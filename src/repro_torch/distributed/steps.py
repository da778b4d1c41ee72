"""Train and serve step builders, the port of the JAX package's
``distributed/steps.py``.

Training accumulates gradients over micro-batches: the batch's leaves
carry a leading ``accum`` axis; with ``accum == 1`` the step is one
value-and-grad, otherwise a loop sums each micro-batch's gradients in
float32 and divides by ``accum``.  The optimizer runs in float32
(``optim.adamw_update``).  The steps are functional, as the
reference's: they return new parameters and state and leave the old
ones as they were; ``make_train_step_`` is the same step in place,
the reference's jitted step with its parameters and state donated
(``launch.train.CompiledTrain`` captures it as one CUDA graph).  On a
mesh the parameters, the optimizer state and
the batch are DTensors (``launch.train.train_loop(mesh=)``): the model
gathers each layer's parameters for use, and DTensor's autograd reduces
every gradient back to its parameter's shards over the fsdp axes (in
the parameters' bfloat16, the implicit compression), so the same code
is the ZeRO-3 step.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import sharding
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, adamw_update, adamw_update_
from repro_torch.optim.adamw import leaves, tree_map


@contextlib.contextmanager
def _span(timing: dict | None, name: str):
    """Record a (start, end) CUDA-event pair under ``timing[name]``."""
    if timing is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    timing.setdefault(name, []).append((start, end))


def micro_grads(model: Model, params, mb: dict, *,
                timing: dict | None = None):
    """(loss, gradients in the parameters' dtypes) of one micro-batch
    ``mb``: one pass of ``value_and_grad``'s loop."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with _span(timing, "forward"):
        loss, _ = model.loss(ps, mb)
    with _span(timing, "backward"):   # an unused parameter gets 0s,
        grads = torch.autograd.grad(    # as under jax.grad
            loss, leaves(ps), allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def placed_as(g, p):
    """A gradient ``g`` with its parameter ``p``'s placements, as the
    accumulator of ``grad_accumulator`` holds it: a DTensor gradient that
    autograd left elsewhere -- a replicated parameter's ``Partial(sum)``
    over the data axes, its per-rank sums -- redistributed (the
    all-reduce or reduce-scatter), so AdamW's state keeps ``opt_specs``'
    placements; a plain tensor as it is."""
    if not sharding.is_dtensor(g) or tuple(g.placements) == tuple(
            p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def grad_accumulator(params):
    """float32 zeros of every parameter (a DTensor's keep its placement)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def accumulate(model: Model, params, mb: dict, gacc, *,
               timing: dict | None = None):
    """One pass of ``value_and_grad``'s loop: the micro-batch's
    gradients added into ``gacc`` in place; returns its loss."""
    loss, grads = micro_grads(model, params, mb, timing=timing)
    tree_map(lambda a, g: a.add_(g), gacc, grads)
    return loss


def value_and_grad(model: Model, params, batch: dict, accum_steps: int, *,
                   timing: dict | None = None):
    """(mean loss, float32 gradients of every parameter) over the
    ``accum_steps`` micro-batches of ``batch`` (leaves (accum, micro,
    ...)).  ``timing``, a dict, collects CUDA-event spans of each
    micro-batch's ``forward`` and ``backward``."""
    if accum_steps == 1:
        loss, grads = micro_grads(model, params,
                                  {k: v[0] for k, v in batch.items()},
                                  timing=timing)
        return loss, tree_map(lambda g, p: placed_as(g.float(), p), grads,
                              params)
    gacc = grad_accumulator(params)
    losses = [accumulate(model, params, {k: v[i] for k, v in batch.items()},
                         gacc, timing=timing) for i in range(accum_steps)]
    return sum(losses) / accum_steps, tree_map(
        lambda g: g.div_(accum_steps), gacc)


def make_train_step(model: Model, opt_cfg: AdamWConfig, accum_steps: int):
    """``train_step(params, opt_state, batch, timing=None)`` -> (params,
    opt_state, {"loss", "lr", "grad_norm"}); ``timing`` also collects the
    ``optimizer`` span."""
    def train_step(params, opt_state, batch, timing: dict | None = None):
        loss, grads = value_and_grad(model, params, batch, accum_steps,
                                     timing=timing)
        with _span(timing, "optimizer"):
            new_params, new_opt, om = adamw_update(grads, opt_state, params,
                                                   opt_cfg)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def make_train_step_(model: Model, opt_cfg: AdamWConfig, accum_steps: int):
    """``train_step_(params, opt_state, batch, scalars, timing=None)`` ->
    {"loss", "grad_norm"}: ``make_train_step``'s step with the parameters
    and the optimizer's tensors updated in place (``adamw_update_``, the
    reference's donation) and the step's (lr, 1 - b1**t, 1 - b2**t) read
    from the 0-d tensors ``scalars``; every device op reads and writes
    only its arguments, so a CUDA graph captured from it replays any
    step.  ``opt_state["step"]`` stays the caller's to advance."""
    def train_step_(params, opt_state, batch, scalars,
                    timing: dict | None = None):
        loss, grads = value_and_grad(model, params, batch, accum_steps,
                                     timing=timing)
        with _span(timing, "optimizer"):
            gnorm = adamw_update_(grads, opt_state, params, opt_cfg, scalars)
        return {"loss": loss, "grad_norm": gnorm}

    return train_step_


def make_prefill_step(model: Model):
    """``prefill_step(params, batch, cache)``: ``Model.prefill``."""
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(params, tokens, pos, cache)``: ``Model.decode``."""
    def decode_step(params, tokens, pos, cache):
        return model.decode(params, tokens, pos, cache)
    return decode_step

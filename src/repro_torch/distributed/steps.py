"""Train and serve step builders, the port of the JAX package's
``distributed/steps.py`` on one device.

Training accumulates gradients over micro-batches: the batch's leaves
carry a leading ``accum`` axis; with ``accum == 1`` the step is one
value-and-grad, otherwise a loop sums each micro-batch's gradients in
float32 and divides by ``accum``.  The optimizer runs in float32
(``optim.adamw_update``).  The steps are functional, as the
reference's: they return new parameters and state and leave the old
ones as they were.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, adamw_update
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


def value_and_grad(model: Model, params, batch: dict, accum_steps: int, *,
                   timing: dict | None = None):
    """(mean loss, float32 gradients of every parameter) over the
    ``accum_steps`` micro-batches of ``batch`` (leaves (accum, micro,
    ...)).  ``timing``, a dict, collects CUDA-event spans of each
    micro-batch's ``forward`` and ``backward``."""
    def one(mb):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with _span(timing, "forward"):
            loss, _ = model.loss(ps, mb)
        with _span(timing, "backward"):   # an unused parameter gets 0s,
            grads = torch.autograd.grad(    # as under jax.grad
                loss, leaves(ps), allow_unused=True, materialize_grads=True)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    if accum_steps == 1:
        loss, grads = one({k: v[0] for k, v in batch.items()})
        return loss, tree_map(lambda g: g.float(), grads)
    gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lsum = 0.0
    for i in range(accum_steps):
        loss, grads = one({k: v[i] for k, v in batch.items()})
        tree_map(lambda a, g: a.add_(g), gacc, grads)
        del grads
        lsum = lsum + loss
    return lsum / accum_steps, tree_map(lambda g: g.div_(accum_steps), gacc)


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

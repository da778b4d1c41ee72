"""AdamW with float32 master weights and moments over (possibly bfloat16)
parameters, the port of the JAX package's ``optim/adamw.py``.

The parameters stay in the model's dtype and are what the forward reads;
the optimizer state holds float32 ``master``, ``m`` and ``v`` trees of
the parameters' structure (dicts and lists of tensors), kept as tensors
of their own, and the ``step``.  The update is the reference's formulas
in plain torch ops over the leaves -- clip by the global norm, bias
corrections, weight decay on masters of 2 or more dims only (norm gains
and biases exempt) -- not ``torch.optim.AdamW``, whose decay and
clipping differ.  The parameters come back in their own dtype.

The step's learning rate and bias corrections are computed on the host
(``schedule``) and read by the update as 0-d float32 tensors on the
device, the reference's traced scalars: the same launched code serves
every step, so a CUDA graph of the update replays with the three
refilled.  ``adamw_update`` returns new tensors, as the
reference's function does; ``adamw_update_`` writes the same bits into
the state and the parameters, as its jitted step with donated buffers.

A list in the tree counts as one more dim of its leaves: the port's
lists of per-layer dicts are the JAX package's layer-stacked arrays, one
axis longer, so a layer's (d,) norm gain is a 2-dim master there and
decays.  The port keeps the reference's rule so both train alike.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """The optimizer's hyperparameters and schedule, the reference's
    defaults."""

    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and lists (and the
    matching leaves of ``rest``), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in the order ``tree_map``
    visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def adamw_init(params) -> dict:
    """step 0, float32 copies of the parameters as ``master`` (distinct
    tensors even where a parameter is float32), zero ``m`` and ``v``."""
    def f32(a):
        return a.detach().to(torch.float32, copy=True)

    def zeros(a):   # a DTensor parameter's zeros keep its placements
        return torch.zeros_like(a, dtype=torch.float32)
    return {"step": 0, "master": tree_map(f32, params),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in float32."""
    sq = [torch.sum(torch.square(a.detach().float())) for a in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def schedule(step: int, cfg: AdamWConfig) -> tuple[float, float, float]:
    """The host's numbers of AdamW step ``step`` (1 the first): the
    learning rate (``warmup_cosine``) and the bias corrections ``1 -
    b1**step`` and ``1 - b2**step``, each in float32 arithmetic, as the
    reference computes them inside its jitted step."""
    lr = warmup_cosine(step, peak_lr=cfg.peak_lr,
                       warmup_steps=cfg.warmup_steps,
                       total_steps=cfg.total_steps)
    step32 = torch.tensor(step, dtype=torch.float32)
    b1c, b2c = (float(1 - torch.pow(torch.tensor(b, dtype=torch.float32),
                                    step32)) for b in (cfg.b1, cfg.b2))
    return lr, b1c, b2c


def _update(grads, opt_state: dict, params, cfg: AdamWConfig,
            scalars: tuple, leaf):
    """The update of every leaf, one at a time: ``leaf(old, new)`` takes
    the leaf's (m, v, master, parameter) and its new float32 (m, v,
    master) as they are made.  Returns (the global gradient norm, the
    tree of ``leaf``'s results)."""
    lr, b1c, b2c = scalars
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)

    def upd(g, m, v, master, ndim):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if ndim >= 2:
            update = update + cfg.weight_decay * master
        return m, v, master - lr * update

    def walk(g, m, v, w, p, lists: int):
        if isinstance(g, dict):
            return {k: walk(g[k], m[k], v[k], w[k], p[k], lists) for k in g}
        if isinstance(g, list):
            return [walk(*x, lists + 1) for x in zip(g, m, v, w, p)]
        return leaf((m, v, w, p), upd(g, m, v, w, w.dim() + lists))

    return gnorm, walk(grads, opt_state["m"], opt_state["v"],
                       opt_state["master"], params, 0)


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig):
    """One AdamW step.  Returns (new_params, new_opt_state, metrics):
    the parameters in their own dtype, the new float32 state, and
    ``{"lr": float, "grad_norm": float32 tensor}``."""
    step = opt_state["step"] + 1
    host = schedule(step, cfg)
    dev = leaves(grads)[0].device
    scalars = tuple(torch.full((), x, dtype=torch.float32, device=dev)
                    for x in host)
    gnorm, out = _update(
        grads, opt_state, params, cfg, scalars,
        lambda old, new: (*new, new[2].to(old[3].dtype, copy=True)))
    new_m, new_v, new_master, new_params = (_unzip(out, i) for i in range(4))
    new_state = {"step": step, "master": new_master, "m": new_m, "v": new_v}
    return new_params, new_state, {"lr": host[0], "grad_norm": gnorm}


@torch.no_grad()
def adamw_update_(grads, opt_state: dict, params, cfg: AdamWConfig,
                  scalars: tuple) -> torch.Tensor:
    """``adamw_update`` in place, the reference's donation: each leaf's
    new ``m``, ``v`` and ``master`` are copied into the state's tensors
    and the master, cast, into the parameter's, leaf by leaf (the
    temporaries are one leaf's), by the same expressions, so the bits
    are ``adamw_update``'s.  ``opt_state["step"]``, a host int, is the
    caller's to advance: a CUDA graph captured from this replays it.
    Returns the global gradient norm."""
    def put(old, new):
        for t, x in zip(old, (*new, new[2])):
            t.copy_(x)
    return _update(grads, opt_state, params, cfg, scalars, put)[0]


def _unzip(tree, i: int):
    """The ``i``-th element of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unzip(v, i) for v in tree]
    return tree[i]

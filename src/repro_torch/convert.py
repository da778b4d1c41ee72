"""Carry state across from the JAX package.

The geometry stack has no weights: a chain's recorded primitives and its
host fold are the state both packages must share.  A reference chain is
handed over as its plain attributes (``dim``, ``kinds``, ``params`` --
numbers, tuples, lists and numpy arrays), so this module never imports
the JAX package; the folds then agree bit for bit, because both packages
run the same numpy fold.

The model stack's parameters come across with
``model_params_from_reference``: the JAX parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``), its layer axes unstacked
into the port's lists of per-layer dicts; the AdamW state of its
training step with ``opt_state_from_reference``, so both packages can
start a step from the same weights and the same state.
"""
from __future__ import annotations

import numpy as np
import torch


def chain_from_reference(dim: int, kinds, params):
    """The port's ``TransformChain`` for a reference chain's attributes:
    ``chain_from_reference(c.dim, c.kinds, c.params)``."""
    from repro_torch.core.transform_chain import TransformChain
    kinds = tuple((str(k), int(axis)) for k, axis in kinds)
    params = tuple(params)
    if len(kinds) != len(params):
        raise ValueError(f"{len(kinds)} primitives but {len(params)} "
                         "parameter sets")
    chain = TransformChain.identity(int(dim))
    return TransformChain(chain.dim, kinds, params)


def folded_to_torch(folded, device: str | torch.device,
                    dtype=np.float32) -> tuple[torch.Tensor, ...]:
    """Folded numpy parameters -- (s, t), (A, t) or (H, lo, hi), single
    or stacked over a batch -- as tensors on ``device``: float32, or the
    int16 Qm.n words of ``quantize_fold`` with ``dtype=np.int16``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(f, dtype),
                                 device=device) for f in folded)


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bfloat16 arrays (numpy
    holds them as an extension dtype) go across by their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def model_params_from_reference(cfg, params, *,
                                 device: str | torch.device = "cuda") -> dict:
    """The port's parameters for a JAX ``Model.init`` pytree given as numpy
    arrays: every leaf as a tensor of the same dtype on ``device`` (the
    GPU unless the caller asks for the CPU), and ``params["layers"]`` --
    stacked by ``jax.vmap`` with a leading axis of ``cfg.n_layers`` --
    split into a list of one dict per layer, as is an enc-dec model's
    ``params["enc_layers"]`` by ``cfg.encoder_layers``.  Every subtree of a layer
    comes across whole: an MoE layer's ``moe`` dict (``router`` float32,
    ``w_gate``/``w_up`` (e, d, d_ff), ``w_down`` (e, d_ff, d)) as the
    SwiGLU ``mlp`` dict of a dense one."""
    from repro_torch.kernels import dispatch
    dev = dispatch.resolve_device(device)
    stacked = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
    out = {k: _tree(v, lambda a: _tensor(a, dev))
           for k, v in params.items() if k not in stacked}
    for key, n in stacked.items():
        if key in params:
            out[key] = [_tree(params[key], lambda a, i=i: _tensor(a[i], dev))
                        for i in range(n)]
    return out


def opt_state_from_reference(cfg, opt_state, *,
                             device: str | torch.device = "cuda") -> dict:
    """The port's AdamW state (``optim.adamw_init``'s layout) for the JAX
    package's, given as numpy arrays (``jax.tree.map(np.asarray,
    opt_state)``): ``step`` as an int, and the float32 ``master``,
    ``m`` and ``v`` trees unstacked as ``model_params_from_reference``
    unstacks the parameters, on ``device`` (the GPU unless the caller
    asks for the CPU)."""
    out = {"step": int(np.asarray(opt_state["step"]))}
    for name in ("master", "m", "v"):
        out[name] = model_params_from_reference(cfg, opt_state[name],
                                                device=device)
    return out

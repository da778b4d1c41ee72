"""Public entry points of the projective chain family (homogeneous
viewing chains: camera -> projection -> cull -> viewport folded to one
matrix).

Both entries return ``(projected, inside)``: the perspective-divided
points and the bool frustum-cull mask, one bit per point (w > 0 and every
coordinate inside the folded [lo, hi] bounds; the bounds are inclusive,
so points exactly on a frustum plane are inside).  Backend dispatch as in
``affine/ops.py``; chain-level byte accounting happens in
``TransformChain.apply``/``project`` and in the serving engine.  Both
take ``config`` as in ``affine/ops.py``: launch knobs only, the same bits
under every config.
"""
from __future__ import annotations

import torch

from repro_torch.autotune.cache import KernelConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.projective import projective as K
from repro_torch.kernels.projective import ref


def _bounds(lo, hi, d: int, like: torch.Tensor, batch: tuple = ()):
    """Cull bounds as contiguous (*batch, d) tensors; ``None`` is -inf
    (``lo``) or +inf (``hi``): no cull on that side."""
    shape = batch + (d,)
    lo = -float("inf") if lo is None else lo
    hi = float("inf") if hi is None else hi
    return (dispatch.param_tensor(lo, shape, like),
            dispatch.param_tensor(hi, shape, like))


def chain_project(points: torch.Tensor, h, lo=None, hi=None, *,
                  backend: str | None = None,
                  config: KernelConfig | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Folded projective chain q = divide([p, 1] @ H) in one fused pass.

    ``points`` is (..., d); ``h`` the composed (d+1, d+1) homogeneous
    matrix (row-vector convention); ``lo``/``hi`` optional (d,) cull
    bounds (``None`` = unbounded).  Returns ``(projected (..., d),
    inside (...,) bool)``.  Lowered to the ``chain_project_1d`` kernel:
    one read of the points, one write of the projected points and one
    mask byte per point."""
    b = dispatch.backend_for(points.device, backend)
    d = points.shape[-1]
    h = dispatch.param_tensor(h, (d + 1, d + 1), points)
    lo, hi = _bounds(lo, hi, d, points)
    if b == "ref":
        return ref.chain_project(points, h, lo, hi)
    cfg = config or KernelConfig("chain_project")
    out, mask = K.chain_project_1d(points.contiguous().reshape(-1), h, lo,
                                   hi, d=d, block_threads=cfg.block_threads,
                                   waves=cfg.waves)
    return out.reshape(points.shape), mask.reshape(points.shape[:-1])


def chain_project_batch(pts3: torch.Tensor, h, lo=None, hi=None, *,
                        backend: str | None = None,
                        config: KernelConfig | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched folded projective chains: one launch per serving bucket.

    ``pts3`` is a packed (B, L, d) batch -- one serving request per row,
    padded to a common length L; ``h`` (B, d+1, d+1) and ``lo``/``hi``
    (B, d) are per-request folded parameters.  Returns ``(projected
    (B, L, d), inside (B, L) bool)``."""
    b = dispatch.backend_for(pts3.device, backend)
    bsz, _, d = pts3.shape
    h = dispatch.param_tensor(h, (bsz, d + 1, d + 1), pts3)
    lo, hi = _bounds(lo, hi, d, pts3, batch=(bsz,))
    if b == "ref":
        return ref.chain_project_batch(pts3, h, lo, hi)
    cfg = config or KernelConfig("chain_project_batch")
    return K.chain_project_batch_2d(pts3.contiguous(), h, lo, hi,
                                    block_threads=cfg.block_threads,
                                    waves=cfg.waves)

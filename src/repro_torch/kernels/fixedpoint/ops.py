"""Public entry points of the fixed-point chain family (Qm.n int16 lane).

The port of ``repro/kernels/fixedpoint/ops.py``: the float chain entries
with int16 Qm.n operands and an explicit ``n_frac``.  All operands are
already-quantised int16 words -- quantisation happens upstream, once per
folded chain, in ``repro_torch.quantize.quantize_fold`` (the chain
compiler and the serving engine both call it there) -- so these entries
never touch floats: a non-int16 operand raises ``TypeError`` rather than
being cast into a different lane.  Backend dispatch per
``repro_torch.kernels.dispatch``: a CUDA tensor launches the kernel, a
CPU tensor runs the plain version, ``backend="ref"`` asks for the plain
version on any device.  Chain-level byte accounting happens in
``TransformChain.apply`` and the serving engine.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.fixedpoint import fixedpoint as K
from repro_torch.kernels.fixedpoint import ref


def _as_q(x, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous int16 tensor of ``shape`` on ``like``'s
    device; raises ``TypeError`` for anything that is not int16 words."""
    q = torch.as_tensor(x, device=like.device)
    if q.dtype != torch.int16:
        raise TypeError(f"fixed-point operands must be int16 Qm.n words, "
                        f"got {q.dtype} (quantise first -- see "
                        "repro_torch.quantize)")
    return q.broadcast_to(shape).contiguous()


def _as_points(points: torch.Tensor) -> torch.Tensor:
    return _as_q(points, tuple(points.shape), points)


def chain_diag_q(points: torch.Tensor, s, t, *, n_frac: int,
                 backend: str | None = None) -> torch.Tensor:
    """Folded diagonal chain q = requant(s (.) p + t) in one fused pass
    over (..., d) int16 Qm.n points; ``s``/``t`` are (d,) int16 words,
    ``n_frac`` the shared fraction-bit count."""
    b = dispatch.backend_for(points.device, backend)
    points = _as_points(points)
    d = points.shape[-1]
    s = _as_q(s, (d,), points)
    t = _as_q(t, (d,), points)
    if b == "ref":
        return ref.chain_diag_q(points, s, t, n_frac)
    out = K.chain_diag_1d_q(points.reshape(-1), s, t, d=d, n_frac=n_frac)
    return out.reshape(points.shape)


def chain_apply_q(points: torch.Tensor, a, t, *, n_frac: int,
                  backend: str | None = None) -> torch.Tensor:
    """Folded general chain q = requant(p @ A + t) in one fused pass;
    ``a`` (d, d) / ``t`` (d,) int16 Qm.n words."""
    b = dispatch.backend_for(points.device, backend)
    points = _as_points(points)
    d = points.shape[-1]
    a = _as_q(a, (d, d), points)
    t = _as_q(t, (d,), points)
    if b == "ref":
        return ref.chain_matrix_q(points, a, t, n_frac)
    out = K.chain_matrix_1d_q(points.reshape(-1), a, t, d=d, n_frac=n_frac)
    return out.reshape(points.shape)


def chain_diag_batch_q(pts3: torch.Tensor, s, t, *, n_frac: int,
                       backend: str | None = None) -> torch.Tensor:
    """Batched folded diagonal chains on a packed int16 (B, L, d) batch;
    ``s``/``t`` (B, d) per-request Qm.n words.  One launch per bucket, as
    on the float lane; integer arithmetic makes the per-request results
    bit-identical to per-request ``chain_diag_q`` on every backend."""
    b = dispatch.backend_for(pts3.device, backend)
    pts3 = _as_points(pts3)
    bsz, _, d = pts3.shape
    s = _as_q(s, (bsz, d), pts3)
    t = _as_q(t, (bsz, d), pts3)
    if b == "ref":
        return ref.chain_diag_batch_q(pts3, s, t, n_frac)
    return K.chain_diag_batch_2d_q(pts3, s, t, n_frac=n_frac)


def chain_apply_batch_q(pts3: torch.Tensor, a, t, *, n_frac: int,
                        backend: str | None = None) -> torch.Tensor:
    """Batched folded general chains on a packed int16 (B, L, d) batch;
    ``a`` (B, d, d) / ``t`` (B, d) per-request Qm.n words."""
    b = dispatch.backend_for(pts3.device, backend)
    pts3 = _as_points(pts3)
    bsz, _, d = pts3.shape
    a = _as_q(a, (bsz, d, d), pts3)
    t = _as_q(t, (bsz, d), pts3)
    if b == "ref":
        return ref.chain_matrix_batch_q(pts3, a, t, n_frac)
    return K.chain_matrix_batch_2d_q(pts3, a, t, n_frac=n_frac)

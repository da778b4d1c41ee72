"""Public entry points of the diagonal chain family.

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches the kernel, a CPU tensor runs the plain version, and
``backend="ref"`` asks for the plain version on any device.  Chain-level
byte accounting happens in ``TransformChain.apply`` and in the serving
engine, not here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.affine import affine as K
from repro_torch.kernels.affine import ref


def chain_diag(points: torch.Tensor, s, t, *,
               backend: str | None = None) -> torch.Tensor:
    """Folded diagonal transform chain q = s (.) p + t in one fused pass.

    ``points`` is (..., d); ``s``/``t`` are scalars or (d,) per-coordinate
    parameters.  Lowered to the ``chain_diag_1d`` kernel over the flat
    buffer: one read of the points, one write."""
    b = dispatch.backend_for(points.device, backend)
    d = points.shape[-1]
    s = dispatch.param_tensor(s, (d,), points)
    t = dispatch.param_tensor(t, (d,), points)
    if b == "ref":
        return ref.chain_diag(points, s, t)
    out = K.chain_diag_1d(points.contiguous().reshape(-1), s, t, d=d)
    return out.reshape(points.shape)


def chain_diag_batch(pts3: torch.Tensor, s, t, *,
                     backend: str | None = None) -> torch.Tensor:
    """Batched folded diagonal chains: q[b] = s[b] (.) p[b] + t[b].

    ``pts3`` is a packed (B, L, d) batch -- one serving request per row,
    padded to a common length L; ``s``/``t`` are (B, d) per-request
    folded parameters.  One launch serves the whole batch."""
    b = dispatch.backend_for(pts3.device, backend)
    bsz, _, d = pts3.shape
    s = dispatch.param_tensor(s, (bsz, d), pts3)
    t = dispatch.param_tensor(t, (bsz, d), pts3)
    if b == "ref":
        return ref.chain_diag_batch(pts3, s, t)
    return K.chain_diag_batch_2d(pts3.contiguous(), s, t)

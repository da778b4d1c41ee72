"""Public entry points of the general (matrix) chain family.

Only the chain functions are ported in this slice; ``matmul`` and
``rotate2d`` of the JAX package's ``kernels/matmul/ops.py`` wait for the
eager-primitive slice.  Backend dispatch as in ``affine/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.matmul import matmul as K
from repro_torch.kernels.matmul import ref


def chain_apply(points: torch.Tensor, a, t, *,
                backend: str | None = None) -> torch.Tensor:
    """Folded transform chain q = p @ A + t in one fused pass.

    ``points`` is (..., d); ``a`` is the composed (d, d) linear part and
    ``t`` the composed (d,) translation.  Lowered to the
    ``chain_matrix_1d`` kernel: one read of the points, one write."""
    b = dispatch.backend_for(points.device, backend)
    d = points.shape[-1]
    a = dispatch.param_tensor(a, (d, d), points)
    t = dispatch.param_tensor(t, (d,), points)
    if b == "ref":
        return ref.chain_matrix(points, a, t)
    out = K.chain_matrix_1d(points.contiguous().reshape(-1), a, t, d=d)
    return out.reshape(points.shape)


def chain_apply_batch(pts3: torch.Tensor, a, t, *,
                      backend: str | None = None) -> torch.Tensor:
    """Batched folded general chains: q[b] = p[b] @ A[b] + t[b].

    ``pts3`` is a packed (B, L, d) batch; ``a`` (B, d, d) / ``t`` (B, d)
    are per-request folded parameters.  One launch serves the batch."""
    b = dispatch.backend_for(pts3.device, backend)
    bsz, _, d = pts3.shape
    a = dispatch.param_tensor(a, (bsz, d, d), pts3)
    t = dispatch.param_tensor(t, (bsz, d), pts3)
    if b == "ref":
        return ref.chain_matrix_batch(pts3, a, t)
    return K.chain_matrix_batch_2d(pts3.contiguous(), a, t)

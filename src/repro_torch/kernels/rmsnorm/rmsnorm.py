"""CUDA wrapper of the ``rmsnorm_2d`` kernel (``csrc/rmsnorm.cu``), the
port of ``rmsnorm_2d`` in the JAX package's ``kernels/rmsnorm/rmsnorm.py``.

The wrapper checks its tensors (CUDA, contiguous, x float32 or bfloat16
of shape (M, N), gain float32 of shape (N,)), allocates the output in
x's dtype, launches on the current stream and counts the launch.  A CPU
tensor raises; nothing falls back to the plain version.  ``row_warps``
is the 16-byte kernel's launch knob (the warps a row; None or 0 for the
kernel's own choice): a count that cannot hold the row, or one for a
launch the 16-byte kernel does not take, raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (DENSE_DTYPES, CudaKernel, check_dense,
                                        f32_bits)

_RMSNORM_2D = CudaKernel("rmsnorm", "rmsnorm_2d", n_ptrs=3, n_sizes=5)
#: ``csrc/rmsnorm.cu``: the 16-byte vectors a lane holds, the warps a row
#: at most
MAX_VEC, MAX_WARPS = 8, 32


def takes_vectors(x: torch.Tensor, gain: torch.Tensor) -> bool:
    """Whether ``rmsnorm_2d`` runs x (M, N) on its 16-byte kernel: rows of
    a multiple of 16 bytes, x and gain on 16-byte boundaries (the output
    is a fresh allocation), at most 32 * MAX_WARPS * MAX_VEC vectors a
    row."""
    nv, rem = divmod(x.shape[1] * x.element_size(), 16)
    return rem == 0 and (x.data_ptr() | gain.data_ptr()) % 16 == 0 \
        and nv <= 32 * MAX_WARPS * MAX_VEC


def row_warps_ok(row_warps: int, nv: int) -> bool:
    """Whether the 16-byte kernel takes ``row_warps`` warps a row of nv
    16-byte vectors: a power of two up to MAX_WARPS whose lanes hold the
    row at MAX_VEC vectors a lane (``csrc/rmsnorm.cu``'s ``warps_ok``)."""
    return row_warps in (1, 2, 4, 8, 16, 32) \
        and 32 * row_warps * MAX_VEC >= nv


def rmsnorm_2d(x: torch.Tensor, gain: torch.Tensor, *, eps: float = 1e-6,
               row_warps: int | None = None) -> torch.Tensor:
    """y[i] = x[i] * rsqrt(mean(x[i]^2) + eps) * gain per row of x (M, N),
    statistics in float32 over the whole unpadded row.  The warps a row
    decide which lane sums which vectors, so results under two
    ``row_warps`` agree within ``rmsnorm_bound``, not bit for bit."""
    check_dense(x)
    check_dense(gain)
    if gain.dtype != torch.float32 or gain.device != x.device:
        raise TypeError(f"rmsnorm_2d wants a float32 gain on {x.device}, got "
                        f"{gain.dtype} on {gain.device}")
    if x.dim() != 2 or gain.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_2d wants x (M, N) and gain (N,); got "
                         f"{tuple(x.shape)}, {tuple(gain.shape)}")
    if row_warps and x.numel() and not (
            takes_vectors(x, gain)
            and row_warps_ok(row_warps,
                             x.shape[1] * x.element_size() // 16)):
        raise ValueError(f"rmsnorm_2d cannot take row_warps={row_warps} for "
                         f"rows of {x.shape[1]} {x.dtype} values at these "
                         "bases: the 16-byte kernel takes a power of two up "
                         f"to {MAX_WARPS} whose lanes hold the row at "
                         f"{MAX_VEC} vectors a lane")
    out = torch.empty_like(x)
    if x.numel():
        _RMSNORM_2D(x.device, out.data_ptr(), x.data_ptr(), gain.data_ptr(),
                    x.shape[0], x.shape[1], f32_bits(eps),
                    DENSE_DTYPES[x.dtype], row_warps or 0)
    return out

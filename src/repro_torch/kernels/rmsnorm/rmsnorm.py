"""CUDA wrapper of the ``rmsnorm_2d`` kernel (``csrc/rmsnorm.cu``), the
port of ``rmsnorm_2d`` in the JAX package's ``kernels/rmsnorm/rmsnorm.py``.

The wrapper checks its tensors (CUDA, contiguous, x float32 or bfloat16
of shape (M, N), gain float32 of shape (N,)), allocates the output in
x's dtype, launches on the current stream and counts the launch.  A CPU
tensor raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (DENSE_DTYPES, CudaKernel, check_dense,
                                        f32_bits)

_RMSNORM_2D = CudaKernel("rmsnorm", "rmsnorm_2d", n_ptrs=3, n_sizes=4)


def rmsnorm_2d(x: torch.Tensor, gain: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    """y[i] = x[i] * rsqrt(mean(x[i]^2) + eps) * gain per row of x (M, N),
    statistics in float32 over the whole unpadded row."""
    check_dense(x)
    check_dense(gain)
    if gain.dtype != torch.float32 or gain.device != x.device:
        raise TypeError(f"rmsnorm_2d wants a float32 gain on {x.device}, got "
                        f"{gain.dtype} on {gain.device}")
    if x.dim() != 2 or gain.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_2d wants x (M, N) and gain (N,); got "
                         f"{tuple(x.shape)}, {tuple(gain.shape)}")
    out = torch.empty_like(x)
    if x.numel():
        _RMSNORM_2D(x.device, out.data_ptr(), x.data_ptr(), gain.data_ptr(),
                    x.shape[0], x.shape[1], f32_bits(eps),
                    DENSE_DTYPES[x.dtype])
    return out

"""CUDA wrapper of the ``rope_3d`` kernel (``csrc/rope.cu``), the port of
``rope_3d`` in the JAX package's ``kernels/rope/rope.py``.

The wrapper checks its tensors (CUDA, contiguous, one dtype of float32
or bfloat16; x (BH, S, D) with D even, cos/sin (S, D/2)), allocates the
output, launches on the current stream and counts the launch.  A CPU
tensor raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel, check_dense

_ROPE_3D = CudaKernel("rope", "rope_3d", n_ptrs=4, n_sizes=4)


def rope_3d(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """y1 = x1*cos - x2*sin, y2 = x2*cos + x1*sin on the halves of each
    row of x (BH, S, D); cos/sin (S, D/2) in x's dtype."""
    bf16 = check_dense(x, cos, sin)
    if x.dim() != 3 or x.shape[2] % 2:
        raise ValueError(f"rope_3d wants x (BH, S, D) with D even, got "
                         f"{tuple(x.shape)}")
    bh, s, d = x.shape
    if cos.shape != (s, d // 2) or sin.shape != cos.shape:
        raise ValueError(f"cos and sin must be ({s}, {d // 2}); got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    out = torch.empty_like(x)
    if x.numel():
        _ROPE_3D(x.device, out.data_ptr(), x.data_ptr(), cos.data_ptr(),
                 sin.data_ptr(), bh * s, s, d // 2, bf16)
    return out

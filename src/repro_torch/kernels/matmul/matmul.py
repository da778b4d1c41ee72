"""CUDA wrappers of the general chain kernels (``csrc/chain_matrix.cu``).

Ports of ``chain_matrix_1d`` and ``chain_matrix_batch_2d`` from the JAX
package's ``kernels/matmul/matmul.py``.  Each wrapper checks its tensors,
allocates the output, launches on the current stream and counts the
launch.  An empty input launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel, check_operands

_MATRIX_1D = CudaKernel("chain_matrix", "chain_matrix_1d", n_ptrs=4,
                        n_sizes=2)
_MATRIX_BATCH = CudaKernel("chain_matrix", "chain_matrix_batch_2d", n_ptrs=4,
                           n_sizes=3)


def chain_matrix_1d(flat: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
                    *, d: int) -> torch.Tensor:
    """q = p @ A + t over the flat (N*d,) buffer of an (N, d) point
    array; ``a`` is (d, d), ``t`` is (d,)."""
    check_operands(flat, a, t, d=d)
    if flat.dim() != 1 or flat.numel() % d or a.shape != (d, d) \
            or t.shape != (d,):
        raise ValueError(f"chain_matrix_1d wants flat (N*{d},), a ({d}, {d}), "
                         f"t ({d},); got {tuple(flat.shape)}, "
                         f"{tuple(a.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(flat)
    if flat.numel():
        _MATRIX_1D(flat.device, out.data_ptr(), flat.data_ptr(), a.data_ptr(),
                   t.data_ptr(), flat.numel() // d, d)
    return out


def chain_matrix_batch_2d(pts3: torch.Tensor, a: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """q[b] = p[b] @ A[b] + t[b] for a packed (B, L, d) batch, (B, d, d)
    and (B, d) per-request parameters: one launch for the whole batch."""
    if pts3.dim() != 3:
        raise ValueError(f"chain_matrix_batch_2d wants (B, L, d) points, got "
                         f"{tuple(pts3.shape)}")
    bsz, length, d = pts3.shape
    check_operands(pts3, a, t, d=d)
    if a.shape != (bsz, d, d) or t.shape != (bsz, d):
        raise ValueError(f"a must be ({bsz}, {d}, {d}) and t ({bsz}, {d}); "
                         f"got {tuple(a.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(pts3)
    if pts3.numel():
        _MATRIX_BATCH(pts3.device, out.data_ptr(), pts3.data_ptr(),
                      a.data_ptr(), t.data_ptr(), bsz, length, d)
    return out

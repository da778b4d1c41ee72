"""CUDA wrappers of the matmul-family kernels: the general chain kernels
(``csrc/chain_matrix.cu``) and the dense product (``csrc/matmul_2d.cu``).

Ports of ``chain_matrix_1d``, ``chain_matrix_batch_2d`` and ``matmul_2d``
from the JAX package's ``kernels/matmul/matmul.py``.  Each wrapper checks
its tensors, allocates the output, launches on the current stream and
counts the launch.  An empty input launches nothing.  No wrapper falls
back to the plain version: a CPU tensor raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (DENSE_DTYPES, CudaKernel,
                                        check_dense, check_operands)

_MATRIX_1D = CudaKernel("chain_matrix", "chain_matrix_1d", n_ptrs=4,
                        n_sizes=2)
_MATRIX_BATCH = CudaKernel("chain_matrix", "chain_matrix_batch_2d", n_ptrs=4,
                           n_sizes=3)
_MATMUL_2D = CudaKernel("matmul_2d", "matmul_2d", n_ptrs=3, n_sizes=5)
#: the streaming regime's limit on K and N (``kSkinny`` in the source)
SKINNY = 8


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


def tensor_cores(dtype: torch.dtype, k: int, n: int) -> bool:
    """Whether ``matmul_2d`` runs inputs of ``dtype`` with contraction K
    and width N on the tensor cores: bfloat16 outside the streaming
    regime (K <= 8 and N <= 8).  Those products agree with the plain
    version within ``tests/torch_bounds.py::matmul_bound``; every other
    product equals it bit for bit."""
    return dtype == torch.bfloat16 and not (k <= SKINNY and n <= SKINNY)


def matmul_2d(x: torch.Tensor, y: torch.Tensor, *,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = X @ Y for x (M, K), y (K, N), both float32 or both bfloat16,
    with a float32 accumulator; C is ``out_dtype`` (float32 or bfloat16,
    x's dtype by default).  The kernel picks its regime from the dtype
    and the shape: K <= 8 and N <= 8 a streaming kernel, other bfloat16
    products a wgmma GEMM with TMA loads (``tensor_cores``), other
    float32 ones a CUDA-core tile; each regime is a kernel of its own,
    launched and counted as one ``matmul_2d`` call."""
    in_bf16 = check_dense(x, y)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in DENSE_DTYPES:
        raise TypeError(f"matmul_2d writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul_2d wants x (M, K) and y (K, N); got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    (m, k), n = x.shape, y.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel():
        _MATMUL_2D(x.device, out.data_ptr(), x.data_ptr(), y.data_ptr(),
                   m, k, n, in_bf16, DENSE_DTYPES[out_dtype])
    return out

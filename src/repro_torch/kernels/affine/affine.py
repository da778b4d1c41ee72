"""CUDA wrappers of the affine-family kernels: the diagonal chain kernels
(``csrc/chain_diag.cu``) and the eager primitives (``csrc/affine_2d.cu``).

Ports of ``chain_diag_1d``, ``chain_diag_batch_2d``, ``affine_2d`` and
``vecadd_2d`` from the JAX package's ``kernels/affine/affine.py``.  Each
wrapper checks its tensors (CUDA, contiguous, matching shapes; float32
for the chain kernels with d in {2, 3}, float32 or bfloat16 for the
eager ones), allocates the output, launches on the current stream and
counts the launch.  An empty input launches nothing.  No wrapper falls
back to the plain version: a CPU tensor raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel, check_dense, check_operands

_DIAG_1D = CudaKernel("chain_diag", "chain_diag_1d", n_ptrs=4, n_sizes=2)
_DIAG_BATCH = CudaKernel("chain_diag", "chain_diag_batch_2d", n_ptrs=4,
                         n_sizes=3)
_AFFINE_2D = CudaKernel("affine_2d", "affine_2d", n_ptrs=4, n_sizes=3)
_VECADD_2D = CudaKernel("affine_2d", "vecadd_2d", n_ptrs=3, n_sizes=2)


def chain_diag_1d(flat: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                  *, d: int) -> torch.Tensor:
    """y = s[c] * x[j] + t[c], c = j mod d, over the flat (N*d,) buffer of
    an (N, d) point array; ``s``/``t`` are (d,)."""
    check_operands(flat, s, t, d=d)
    if flat.dim() != 1 or flat.numel() % d or s.shape != (d,) or t.shape != (d,):
        raise ValueError(f"chain_diag_1d wants flat (N*{d},), s and t "
                         f"({d},); got {tuple(flat.shape)}, "
                         f"{tuple(s.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(flat)
    if flat.numel():
        _DIAG_1D(flat.device, out.data_ptr(), flat.data_ptr(), s.data_ptr(),
                 t.data_ptr(), flat.numel(), d)
    return out


def chain_diag_batch_2d(pts3: torch.Tensor, s: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """q[b] = s[b] (.) p[b] + t[b] for a packed (B, L, d) batch and
    (B, d) per-request parameters: one launch for the whole batch (the
    16-byte kernel where a row of L*d floats is a multiple of 4 and the
    bases are aligned, else the scalar one; ``csrc/chain_diag.cu``)."""
    if pts3.dim() != 3:
        raise ValueError(f"chain_diag_batch_2d wants (B, L, d) points, got "
                         f"{tuple(pts3.shape)}")
    bsz, length, d = pts3.shape
    check_operands(pts3, s, t, d=d)
    if s.shape != (bsz, d) or t.shape != (bsz, d):
        raise ValueError(f"s and t must be ({bsz}, {d}); got "
                         f"{tuple(s.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(pts3)
    if pts3.numel():
        _DIAG_BATCH(pts3.device, out.data_ptr(), pts3.data_ptr(),
                    s.data_ptr(), t.data_ptr(), bsz, length, d)
    return out


def affine_2d(x: torch.Tensor, s: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """y[i, j] = x[i, j] * s[j] + t[j] for x (M, N) and row parameters
    ``s``/``t`` (N,), float32 or bfloat16 (one dtype for all three).  The
    kernel picks its regime from N and the bases' alignment: flat
    16-byte vectors, column vectors or one element a thread
    (``csrc/affine_2d.cu``); a call counts one launch in every regime."""
    bf16 = check_dense(x, s, t)
    if x.dim() != 2 or s.shape != (x.shape[1],) or t.shape != s.shape:
        raise ValueError(f"affine_2d wants x (M, N), s and t (N,); got "
                         f"{tuple(x.shape)}, {tuple(s.shape)}, "
                         f"{tuple(t.shape)}")
    out = torch.empty_like(x)
    if x.numel():
        _AFFINE_2D(x.device, out.data_ptr(), x.data_ptr(), s.data_ptr(),
                   t.data_ptr(), x.shape[0], x.shape[1], bf16)
    return out


def vecadd_2d(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y = x + z for x, z (M, N), float32 or bfloat16 (one dtype)."""
    bf16 = check_dense(x, z)
    if x.dim() != 2 or z.shape != x.shape:
        raise ValueError(f"vecadd_2d wants x and z of one (M, N) shape; got "
                         f"{tuple(x.shape)}, {tuple(z.shape)}")
    out = torch.empty_like(x)
    if x.numel():
        _VECADD_2D(x.device, out.data_ptr(), x.data_ptr(), z.data_ptr(),
                   x.numel(), bf16)
    return out

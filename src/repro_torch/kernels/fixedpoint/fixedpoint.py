"""CUDA wrappers of the fixed-point chain kernels (``csrc/chain_fixedpoint.cu``).

Ports of ``chain_diag_1d_q``, ``chain_matrix_1d_q``,
``chain_diag_batch_2d_q`` and ``chain_matrix_batch_2d_q`` from the JAX
package's ``kernels/fixedpoint/fixedpoint.py``.  Each wrapper checks its
tensors (CUDA, int16, contiguous, d in {2, 3}, matching shapes,
``n_frac`` in [0, 15]), allocates the int16 output, launches on the
current stream and counts the launch.  An empty input launches nothing.
Each takes the launch knobs ``block_threads`` and ``waves``
(``_build.chain_knobs``; None or 0 for the kernel's own choice), which
move no word of a result.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel, chain_knobs, check_operands

_DIAG_1D = CudaKernel("chain_fixedpoint", "chain_diag_1d_q", n_ptrs=4,
                      n_sizes=5)
_DIAG_BATCH = CudaKernel("chain_fixedpoint", "chain_diag_batch_2d_q",
                         n_ptrs=4, n_sizes=6)
_MATRIX_1D = CudaKernel("chain_fixedpoint", "chain_matrix_1d_q", n_ptrs=4,
                        n_sizes=5)
_MATRIX_BATCH = CudaKernel("chain_fixedpoint", "chain_matrix_batch_2d_q",
                           n_ptrs=4, n_sizes=6)


def _check_frac(n_frac: int) -> int:
    if not 0 <= n_frac <= 15:
        raise ValueError(f"n_frac must lie in [0, 15], got {n_frac}")
    return int(n_frac)


def chain_diag_1d_q(flat: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                    *, d: int, n_frac: int,
                    block_threads: int | None = None,
                    waves: int | None = None) -> torch.Tensor:
    """q[j] = requant(x[j] * s[c] + (t[c] << n)), c = j mod d, over the
    flat (N*d,) int16 buffer; ``s``/``t`` are (d,) int16 words."""
    check_operands(flat, s, t, d=d, dtype=torch.int16)
    n = _check_frac(n_frac)
    knobs = chain_knobs(block_threads, waves)
    if flat.dim() != 1 or flat.numel() % d or s.shape != (d,) or t.shape != (d,):
        raise ValueError(f"chain_diag_1d_q wants flat (N*{d},), s and t "
                         f"({d},); got {tuple(flat.shape)}, "
                         f"{tuple(s.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(flat)
    if flat.numel():
        _DIAG_1D(flat.device, out.data_ptr(), flat.data_ptr(), s.data_ptr(),
                 t.data_ptr(), flat.numel(), d, n, *knobs)
    return out


def chain_matrix_1d_q(flat: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
                      *, d: int, n_frac: int,
                      block_threads: int | None = None,
                      waves: int | None = None) -> torch.Tensor:
    """q = requant(p @ A + (t << n)) over the flat (N*d,) int16 buffer;
    ``a`` (d, d) and ``t`` (d,) int16 words."""
    check_operands(flat, a, t, d=d, dtype=torch.int16)
    n = _check_frac(n_frac)
    knobs = chain_knobs(block_threads, waves)
    if flat.dim() != 1 or flat.numel() % d or a.shape != (d, d) \
            or t.shape != (d,):
        raise ValueError(f"chain_matrix_1d_q wants flat (N*{d},), a ({d}, "
                         f"{d}), t ({d},); got {tuple(flat.shape)}, "
                         f"{tuple(a.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(flat)
    if flat.numel():
        _MATRIX_1D(flat.device, out.data_ptr(), flat.data_ptr(), a.data_ptr(),
                   t.data_ptr(), flat.numel() // d, d, n, *knobs)
    return out


def _check_batch(name: str, pts3: torch.Tensor) -> tuple[int, int, int]:
    if pts3.dim() != 3:
        raise ValueError(f"{name} wants (B, L, d) points, got "
                         f"{tuple(pts3.shape)}")
    return tuple(pts3.shape)


def chain_diag_batch_2d_q(pts3: torch.Tensor, s: torch.Tensor,
                          t: torch.Tensor, *, n_frac: int,
                          block_threads: int | None = None,
                          waves: int | None = None) -> torch.Tensor:
    """Per-request diagonal plans on a packed (B, L, d) int16 batch with
    (B, d) int16 words: one launch for the whole batch."""
    bsz, length, d = _check_batch("chain_diag_batch_2d_q", pts3)
    check_operands(pts3, s, t, d=d, dtype=torch.int16)
    n = _check_frac(n_frac)
    knobs = chain_knobs(block_threads, waves)
    if s.shape != (bsz, d) or t.shape != (bsz, d):
        raise ValueError(f"s and t must be ({bsz}, {d}); got "
                         f"{tuple(s.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(pts3)
    if pts3.numel():
        _DIAG_BATCH(pts3.device, out.data_ptr(), pts3.data_ptr(),
                    s.data_ptr(), t.data_ptr(), bsz, length, d, n, *knobs)
    return out


def chain_matrix_batch_2d_q(pts3: torch.Tensor, a: torch.Tensor,
                            t: torch.Tensor, *, n_frac: int,
                            block_threads: int | None = None,
                            waves: int | None = None) -> torch.Tensor:
    """Per-request matrix plans on a packed (B, L, d) int16 batch with
    (B, d, d) and (B, d) int16 words: one launch for the whole batch."""
    bsz, length, d = _check_batch("chain_matrix_batch_2d_q", pts3)
    check_operands(pts3, a, t, d=d, dtype=torch.int16)
    n = _check_frac(n_frac)
    knobs = chain_knobs(block_threads, waves)
    if a.shape != (bsz, d, d) or t.shape != (bsz, d):
        raise ValueError(f"a must be ({bsz}, {d}, {d}) and t ({bsz}, {d}); "
                         f"got {tuple(a.shape)}, {tuple(t.shape)}")
    out = torch.empty_like(pts3)
    if pts3.numel():
        _MATRIX_BATCH(pts3.device, out.data_ptr(), pts3.data_ptr(),
                      a.data_ptr(), t.data_ptr(), bsz, length, d, n,
                      *knobs)
    return out

"""CUDA wrappers of the projective chain kernels (``csrc/chain_project.cu``).

Ports of ``chain_project_1d`` and ``chain_project_batch_2d`` from the JAX
package's ``kernels/projective/projective.py``.  Each wrapper checks its
tensors, allocates the projected points (float32) and the per-point mask
(``torch.bool``, one byte per point), launches on the current stream and
counts the launch.  An empty input launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel, check_operands

_PROJECT_1D = CudaKernel("chain_project", "chain_project_1d", n_ptrs=6,
                         n_sizes=2)
_PROJECT_BATCH = CudaKernel("chain_project", "chain_project_batch_2d",
                            n_ptrs=6, n_sizes=3)


def chain_project_1d(flat: torch.Tensor, h: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, *, d: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """q = divide([p, 1] @ H) and the inclusive cull against [lo, hi] over
    the flat (N*d,) buffer of an (N, d) point array; ``h`` is (d+1, d+1),
    ``lo``/``hi`` are (d,).  Returns the projected flat (N*d,) buffer and
    the (N,) bool mask."""
    check_operands(flat, h, lo, hi, d=d)
    if flat.dim() != 1 or flat.numel() % d or h.shape != (d + 1, d + 1) \
            or lo.shape != (d,) or hi.shape != (d,):
        raise ValueError(f"chain_project_1d wants flat (N*{d},), h "
                         f"({d + 1}, {d + 1}), lo and hi ({d},); got "
                         f"{tuple(flat.shape)}, {tuple(h.shape)}, "
                         f"{tuple(lo.shape)}, {tuple(hi.shape)}")
    n = flat.numel() // d
    out = torch.empty_like(flat)
    mask = torch.empty(n, dtype=torch.bool, device=flat.device)
    if n:
        _PROJECT_1D(flat.device, out.data_ptr(), mask.data_ptr(),
                    flat.data_ptr(), h.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), n, d)
    return out, mask


def chain_project_batch_2d(pts3: torch.Tensor, h: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Projective chains per request of a packed (B, L, d) batch, (B, d+1,
    d+1) and (B, d) per-request parameters: one launch for the whole
    batch.  Returns the projected (B, L, d) batch and the (B, L) bool
    mask."""
    if pts3.dim() != 3:
        raise ValueError(f"chain_project_batch_2d wants (B, L, d) points, "
                         f"got {tuple(pts3.shape)}")
    bsz, length, d = pts3.shape
    check_operands(pts3, h, lo, hi, d=d)
    if h.shape != (bsz, d + 1, d + 1) or lo.shape != (bsz, d) \
            or hi.shape != (bsz, d):
        raise ValueError(f"h must be ({bsz}, {d + 1}, {d + 1}), lo and hi "
                         f"({bsz}, {d}); got {tuple(h.shape)}, "
                         f"{tuple(lo.shape)}, {tuple(hi.shape)}")
    out = torch.empty_like(pts3)
    mask = torch.empty((bsz, length), dtype=torch.bool, device=pts3.device)
    if pts3.numel():
        _PROJECT_BATCH(pts3.device, out.data_ptr(), mask.data_ptr(),
                       pts3.data_ptr(), h.data_ptr(), lo.data_ptr(),
                       hi.data_ptr(), bsz, length, d)
    return out, mask

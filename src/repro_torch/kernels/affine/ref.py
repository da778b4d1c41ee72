"""Plain PyTorch versions of the diagonal chain kernels.

Eager torch, one separately rounded op at a time: a multiply, then an
add -- never a fused multiply-add op, which would round once.  These run
on the CPU for CPU tensors, and on the card when a caller asks for
``backend="ref"``; the CUDA kernels in ``affine.py`` do the same rounded
ops in the same order, so the two agree bit for bit.
"""
from __future__ import annotations

import torch


def chain_diag(p: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Folded diagonal transform chain: q = s (.) p + t, with s and t
    broadcasting against the trailing coordinate axis of p."""
    return p * s + t


def chain_diag_batch(p3: torch.Tensor, s: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """Batched q[b] = s[b] (.) p[b] + t[b] for a packed (B, L, d) batch
    and (B, d) parameters: the per-request ``chain_diag`` broadcast over
    B, so each row is element for element the per-request arithmetic."""
    return chain_diag(p3, s[:, None, :], t[:, None, :])

"""Plain PyTorch versions of the projective chain kernels.

Eager torch, one separately rounded op at a time, in the reference
oracle's order (``repro/kernels/projective/ref.py``, ``chain_project``):
for each homogeneous output column c (the d point coordinates, then w)
the products p_m * H[m, c] are summed over m from m = 0, and the
translation row H[d, c] is added last.  Then the guarded divide -- w > 0
divides by w, anything else (w <= 0, NaN) by 1 and is marked outside --
and the inclusive cull against [lo, hi].  No library product or fused
multiply-add op: those may fuse or reorder.  The CUDA kernels in
``projective.py`` run the same sequence of rounded ops, so the two agree
bit for bit, mask included.
"""
from __future__ import annotations

import torch


def chain_project(p: torch.Tensor, h: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Folded projective chain on (..., d) points: ``h`` (..., d+1, d+1)
    row-vector homogeneous, ``lo``/``hi`` (..., d) cull bounds (+-inf =
    no cull), broadcasting against p's leading axes (a single chain
    passes (d+1, d+1) and (d,)).

    Returns ``(projected (..., d), inside (...,) bool)``: one mask bit
    per point, True when w > 0 and every coordinate lies in [lo, hi]."""
    d = p.shape[-1]
    cols = []
    for c in range(d + 1):
        acc = p[..., 0] * h[..., 0, c]
        for m in range(1, d):
            acc = acc + p[..., m] * h[..., m, c]
        cols.append(acc + h[..., d, c])
    w = cols.pop()
    w_ok = w > 0
    safe = torch.where(w_ok, w, torch.ones_like(w))
    v = torch.stack([c / safe for c in cols], dim=-1)
    inside = w_ok & ((v >= lo) & (v <= hi)).all(dim=-1)
    return v, inside


def chain_project_batch(p3: torch.Tensor, h: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched projective chains over a packed (B, L, d) batch, (B, d+1,
    d+1) and (B, d) parameters: the per-request ``chain_project``
    broadcast over B.  Returns ``(projected (B, L, d), inside (B, L))``."""
    return chain_project(p3, h[:, None], lo[:, None], hi[:, None])

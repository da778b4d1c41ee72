"""Plain PyTorch versions of the general (matrix) chain kernels and of the
tiled ``matmul_2d``.

Eager torch, one separately rounded op at a time, in the reference
oracle's order (``repro/kernels/matmul/ref.py``, ``chain_matrix``): for
each output coordinate c the products p_m * A[m, c] are summed over m
from m = 0, and t[c] is added last.  No library product or fused
multiply-add op: those may fuse or reorder.  The CUDA kernels
in ``matmul.py`` run the same sequence of rounded ops, so the two agree
bit for bit.
"""
from __future__ import annotations

import torch


def chain_matrix(p: torch.Tensor, a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Folded transform chain q = p @ A + t for (..., d) points, with
    ``a`` (..., d, d) and ``t`` (..., d) broadcasting against p's leading
    axes (a single chain passes (d, d) and (d,))."""
    d = p.shape[-1]
    cols = []
    for c in range(d):
        acc = p[..., 0] * a[..., 0, c]
        for m in range(1, d):
            acc = acc + p[..., m] * a[..., m, c]
        cols.append(acc + t[..., c])
    return torch.stack(cols, dim=-1)


def chain_matrix_batch(p3: torch.Tensor, a: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """Batched q[b] = p[b] @ A[b] + t[b] for a packed (B, L, d) batch,
    (B, d, d) and (B, d) parameters: the per-request ``chain_matrix``
    broadcast over B."""
    return chain_matrix(p3, a[:, None], t[:, None])


def matmul(x: torch.Tensor, y: torch.Tensor,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = X @ Y for x (..., K), y (K, N): a float32 accumulator, starting
    at 0, adds the rounded product x[..., k] * y[k, :] for k ascending
    from 0, every op separately rounded; then one cast to ``out_dtype``
    (x's dtype by default).  bfloat16 inputs widen to float32 exactly,
    and their products are exact in float32."""
    out_dtype = out_dtype or x.dtype
    acc = torch.zeros((*x.shape[:-1], y.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k:k + 1].float() * y[k:k + 1, :].float()
    return acc.to(out_dtype)

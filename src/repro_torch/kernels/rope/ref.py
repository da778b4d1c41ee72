"""Plain PyTorch RoPE (half-split pairing, LLaMA convention), the port of
the JAX package's ``kernels/rope/ref.py`` and the function of the
``rope_3d`` kernel.

``rope`` is eager torch, one separately rounded op at a time: for
bfloat16 each product and each sum is rounded to bfloat16, as eager
torch does; the CUDA kernel rounds at the same places, so the two agree
bit for bit.
"""
from __future__ import annotations

import torch


def rope_tables(positions: torch.Tensor, d_head: int,
                theta: float = 10000.0, dtype=torch.float32):
    """cos/sin tables (len(positions), d_head/2), computed in float32 as
    the JAX package does (``theta ** (arange(d2) / d2)``); torch's and
    XLA's float32 ``pow``/``cos``/``sin`` may differ by an ulp."""
    d2 = d_head // 2
    ar = torch.arange(0, d2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (ar / d2))
    angles = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to x (..., S, D) with cos/sin (S, D/2), both cast to x's
    dtype first."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)

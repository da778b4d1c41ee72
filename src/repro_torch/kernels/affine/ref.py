"""Plain PyTorch versions of the affine-family kernels: the diagonal chain
kernels and the eager primitives (``affine_2d``, ``vecadd_2d``).

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


# -- the eager primitives (affine_2d, vecadd_2d) --------------------------------
#
# Each is one separately rounded eager op at a time: ``x * s``, then
# ``+ t``.  For bfloat16 each op rounds to bfloat16, as eager torch does
# (the product and the sum are formed in float and rounded after each op).


def affine(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """y = s*x + t; ``s``/``t`` broadcast against x's trailing dim and are
    cast to x's dtype first."""
    return x * s.to(x.dtype) + t.to(x.dtype)


def vecadd(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y = x + z elementwise, z cast to x's dtype first."""
    return x + z.to(x.dtype)


def translate(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """q = p + t as the ops run it: ``affine(p, 1, t)`` -- the multiply by
    one is kept, so signed zeros behave as in the kernel."""
    return affine(p, torch.ones((), dtype=p.dtype, device=p.device), t)


def scale(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q = s (.) p as the ops run it: ``affine(p, s, 0)`` -- the add of zero
    is kept, so x*s = -0.0 becomes +0.0, as in the JAX package."""
    return affine(p, s, torch.zeros((), dtype=p.dtype, device=p.device))

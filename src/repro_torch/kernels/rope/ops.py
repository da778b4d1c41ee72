"""Public RoPE entry (the paper's rotation transform as rotary embedding).

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches ``rope_3d``, a CPU tensor (or ``backend="ref"``) runs the plain
version; a CUDA call that autograd records launches through
``kernels.grad.Rope``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch, grad
from repro_torch.kernels.rope import ref
from repro_torch.kernels.rope import rope as K

rope_tables = ref.rope_tables


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
         backend: str | None = None) -> torch.Tensor:
    """Apply rotary embedding to x (..., S, D); cos/sin (S, D/2), cast to
    x's dtype.  The kernel takes x as a contiguous (BH, S, D) buffer: a
    strided view (heads split off a (B, S, H*D) product) is copied once
    here, so callers hand it over contiguous.  On DTensors the kernel
    rotates the local shard, the positions and head dim made whole."""
    if sharding.any_dtensor(x, cos, sin):
        return sharding.local_call(
            lambda a, c, s: rope(a, c, s, backend=backend), (x, cos, sin),
            (tuple(range(x.dim() - 2)), (), ()))
    b = dispatch.backend_for(x.device, backend)
    if b == "ref":
        return ref.rope(x, cos, sin)
    s, d = x.shape[-2:]
    args = (x.contiguous().reshape(-1, s, d), cos.to(x.dtype).contiguous(),
            sin.to(x.dtype).contiguous())
    if grad.wanted(*args):
        out = grad.Rope.apply("rope_3d", K.rope_3d, ref.rope, *args)
    else:
        out = K.rope_3d(*args)
    return out if out.shape == x.shape else out.reshape(x.shape)

"""Public RoPE entry (the paper's rotation transform as rotary embedding).

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches ``rope_3d``, a CPU tensor (or ``backend="ref"``) runs the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.rope import ref
from repro_torch.kernels.rope import rope as K

rope_tables = ref.rope_tables


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
         backend: str | None = None) -> torch.Tensor:
    """Apply rotary embedding to x (..., S, D); cos/sin (S, D/2), cast to
    x's dtype.  The kernel takes x as a contiguous (BH, S, D) buffer: a
    strided view (heads split off a (B, S, H*D) product) is copied once
    here, so callers hand it over contiguous."""
    b = dispatch.backend_for(x.device, backend)
    if b == "ref":
        return ref.rope(x, cos, sin)
    s, d = x.shape[-2:]
    out = K.rope_3d(x.contiguous().reshape(-1, s, d),
                    cos.to(x.dtype).contiguous(), sin.to(x.dtype).contiguous())
    return out.reshape(x.shape)

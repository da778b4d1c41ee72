"""Public attention entry: (B, Hq, S, D) x (B, Hkv, T, D) -> (B, Hq, S, D).

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches ``flash_attention_3d``, a CPU tensor (or ``backend="ref"``)
runs its plain version (``ref.flash_attention``).  The JAX package's
``block_kv`` argument picks the blocks of its ``ref`` training path,
which the port does not have yet; it is left out.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention import ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float | None = None, causal: bool = True,
              window: int | None = None, q_offset: int = 0,
              backend: str | None = None) -> torch.Tensor:
    """Scaled dot-product attention, GQA-aware (Hq may exceed Hkv):
    ``causal`` masks with ``q_offset`` placing the queries in the
    sequence, ``window`` keeps the last ``window`` keys of each query."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    be = dispatch.backend_for(q.device, backend)
    q3 = q.contiguous().reshape(b * hq, s, d)
    k3 = k.contiguous().reshape(b * hkv, t, d)
    v3 = v.contiguous().reshape(b * hkv, t, d)
    fn = ref.flash_attention if be == "ref" else K.flash_attention_3d
    out = fn(q3, k3, v3, scale=scale, causal=causal, window=window,
             q_offset=q_offset)
    return out.reshape(b, hq, s, d)

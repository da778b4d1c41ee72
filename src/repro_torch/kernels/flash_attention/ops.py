"""Public attention entry: (B, Hq, S, D) x (B, Hkv, T, D) -> (B, Hq, S, D).

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches ``flash_attention_3d``, a CPU tensor (or ``backend="ref"``)
runs its plain version: the JAX ``ref`` backend's route
(``ref.autodiff_attention``: banded for a causal sliding window from
position 0, else blockwise over ``block_kv`` keys), with or without
autograd, so the CPU path and the dry-run do the products the
reference's do.  The kernel's own function (``ref.flash_attention``)
stays the plain version the kernel is held against.  A call that
autograd records is the training path: a CUDA call launches the kernel
through ``kernels.grad.FlashAttention``, whose backward is the
``ref`` route's vjp.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch, grad
from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention import ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float | None = None, causal: bool = True,
              window: int | None = None, q_offset: int = 0,
              block_kv: int = 1024,
              backend: str | None = None) -> torch.Tensor:
    """Scaled dot-product attention, GQA-aware (Hq may exceed Hkv):
    ``causal`` masks with ``q_offset`` placing the queries in the
    sequence, ``window`` keeps the last ``window`` keys of each query,
    ``block_kv`` sets the plain route's KV block.  On DTensors the
    kernel runs on the local batch rows, every other dim (the keys it
    reduces over among them) made whole."""
    if sharding.any_dtensor(q, k, v):
        return sharding.local_call(
            lambda a, b_, c: attention(a, b_, c, scale=scale, causal=causal,
                                       window=window, q_offset=q_offset,
                                       block_kv=block_kv, backend=backend),
            (q, k, v), ((0,), (0,), (0,)))
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    be = dispatch.backend_for(q.device, backend)
    train = grad.wanted(q, k, v)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset)
    if be == "ref":
        return ref.autodiff_attention(q, k, v, block_kv=block_kv, **kw)

    def kernel(q, k, v):
        out = K.flash_attention_3d(q.contiguous().reshape(b * hq, s, d),
                                   k.contiguous().reshape(b * hkv, t, d),
                                   v.contiguous().reshape(b * hkv, t, d),
                                   **kw)
        return out.reshape(b, hq, s, d)
    if train:
        return grad.FlashAttention.apply(
            "flash_attention_3d", kernel,
            lambda q, k, v: ref.autodiff_attention(q, k, v,
                                                   block_kv=block_kv, **kw),
            q, k, v)
    return kernel(q, k, v)

"""CUDA wrapper of the ``flash_attention_3d`` kernel
(``csrc/flash_attention.cu``), the port of ``flash_attention_3d`` in the
JAX package's ``kernels/flash_attention/flash_attention.py``.

The wrapper checks its tensors (CUDA, contiguous, one dtype of float32
or bfloat16; q (BHq, S, D), k and v (BHkv, T, D), BHq a multiple of
BHkv, D one of ``HEAD_DIMS``), allocates the output, launches on the
current stream and counts the launch.  A CPU tensor raises; nothing
falls back to the plain version.

bfloat16 runs the tensor-core (wgmma) kernel, whose TMA loads need
16-byte aligned bases: an operand that starts mid-allocation (a
contiguous view at an odd offset) is copied to a fresh one first.
float32 runs the CUDA-core kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel, check_dense, f32_bits

_FLASH_3D = CudaKernel("flash_attention", "flash_attention_3d", n_ptrs=4,
                       n_sizes=10)
#: the head dims the kernels are instantiated for: the reduced configs'
#: 16 and the served configs' 64, 80, 96 and 128
HEAD_DIMS = (16, 64, 80, 96, 128)


def flash_attention_3d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, causal: bool = True,
                       window: int | None = None,
                       q_offset: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA attention: q (BHq, S, D) over k/v
    (BHkv, T, D) -> (BHq, S, D); q row-block bh reads kv head
    bh // (BHq // BHkv)."""
    bf16 = check_dense(q, k, v)
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_3d wants q (BHq, S, D), k and v "
                         f"(BHkv, T, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bhq, s, d = q.shape
    bhkv, t, _ = k.shape
    if bhkv == 0 or bhq % bhkv:
        raise ValueError(f"q heads {bhq} are no multiple of kv heads {bhkv}")
    if t == 0:
        raise ValueError("flash_attention_3d needs at least one key")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_3d is built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if bf16:
        q, k, v = (a if a.data_ptr() % 16 == 0 else a.clone()
                   for a in (q, k, v))
    out = torch.empty_like(q)
    if q.numel():
        _FLASH_3D(q.device, out.data_ptr(), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), bhq, s, t, bhq // bhkv, d, f32_bits(scale),
                  int(causal), -1 if window is None else window, q_offset,
                  bf16)
    return out

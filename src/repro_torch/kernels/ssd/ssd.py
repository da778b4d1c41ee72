"""CUDA wrapper of the ``ssd_intra`` kernel (``csrc/ssd_intra.cu``), the
port of ``ssd_intra`` in the JAX package's ``kernels/ssd/ssd.py``.

The wrapper checks its tensors (CUDA, contiguous; xdt, b_in and c_in of
one dtype, float32 or bfloat16; cum float32; lc at most ``MAX_CHUNK``;
(p, n) one of ``SHAPES``), allocates the float32 outputs, launches on
the current stream and counts the launch.  A CPU tensor raises; nothing
falls back to the plain version.

bfloat16 runs the tensor-core (wgmma) kernel, whose TMA loads need
16-byte aligned bases: an operand that starts mid-allocation (a
contiguous view at an odd offset) is copied to a fresh one first.
float32 runs the CUDA-core kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel, check_dense

_SSD_INTRA = CudaKernel("ssd_intra", "ssd_intra", n_ptrs=6, n_sizes=6)
#: the chunk length the kernels take at most
MAX_CHUNK = 256
#: the (head dim p, state size n) pairs the kernel is instantiated for:
#: the reduced configs', hymba-1.5b's and mamba2-130m's
SHAPES = ((16, 16), (64, 16), (64, 128))


def ssd_intra(xdt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
              cum: torch.Tensor):
    """xdt (BC, lc, h, p), b_in/c_in (BC, lc, n), cum (BC, lc, h) ->
    (y_intra (BC, lc, h, p), s_c (BC, h, p, n)), both float32."""
    bf16 = check_dense(xdt, b_in, c_in)
    check_dense(cum)
    if cum.dtype != torch.float32 or cum.device != xdt.device:
        raise TypeError(f"ssd_intra wants float32 cum on {xdt.device}, got "
                        f"{cum.dtype} on {cum.device}")
    if xdt.dim() != 4 or b_in.dim() != 3:
        raise ValueError(f"ssd_intra wants xdt (BC, lc, h, p) and b_in "
                         f"(BC, lc, n); got {tuple(xdt.shape)}, "
                         f"{tuple(b_in.shape)}")
    bc, lc, h, p = xdt.shape
    n = b_in.shape[2]
    if b_in.shape != (bc, lc, n) or c_in.shape != b_in.shape \
            or cum.shape != (bc, lc, h):
        raise ValueError(f"ssd_intra wants b_in/c_in ({bc}, {lc}, n) and cum "
                         f"({bc}, {lc}, {h}); got {tuple(b_in.shape)}, "
                         f"{tuple(c_in.shape)}, {tuple(cum.shape)}")
    if lc > MAX_CHUNK or (p, n) not in SHAPES:
        raise ValueError(f"ssd_intra is built for lc <= {MAX_CHUNK} and "
                         f"(p, n) in {SHAPES}; got lc={lc}, ({p}, {n})")
    if bf16:
        xdt, b_in, c_in = (a if a.data_ptr() % 16 == 0 else a.clone()
                           for a in (xdt, b_in, c_in))
    y = torch.empty((bc, lc, h, p), dtype=torch.float32, device=xdt.device)
    s_c = torch.empty((bc, h, p, n), dtype=torch.float32, device=xdt.device)
    if xdt.numel():
        _SSD_INTRA(xdt.device, y.data_ptr(), s_c.data_ptr(), xdt.data_ptr(),
                   b_in.data_ptr(), c_in.data_ptr(), cum.data_ptr(),
                   bc, lc, h, p, n, bf16)
    return y, s_c

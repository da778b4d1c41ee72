"""Public SSD intra-chunk entry.

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches ``ssd_intra``, a CPU tensor (or ``backend="ref"``, or
``use_backend("ref")`` around the model) runs the plain version; a CUDA
call that autograd records launches through ``kernels.grad.SSDIntra``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch, grad
from repro_torch.kernels.ssd import ref
from repro_torch.kernels.ssd import ssd as K


def ssd_intra(xdt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
              cum: torch.Tensor, *, backend: str | None = None):
    """Mamba-2 SSD intra-chunk core: the within-chunk term of the
    state-space dual (scores C B^T gated by the segment-sum decay ``cum``,
    applied to ``xdt``) and the per-chunk state contribution.  Shapes as
    in ``ref.ssd_intra``; both outputs float32.  On DTensors the kernel
    runs on the local (batch x chunk) rows, the rest made whole."""
    if sharding.any_dtensor(xdt, b_in, c_in, cum):
        return sharding.local_call(
            lambda *a: ssd_intra(*a, backend=backend),
            (xdt, b_in, c_in, cum), ((0,),) * 4, n_out=2)
    be = dispatch.backend_for(xdt.device, backend)
    if be == "ref":
        return ref.ssd_intra(xdt, b_in, c_in, cum)
    args = (xdt.contiguous(), b_in.contiguous(), c_in.contiguous(),
            cum.to(torch.float32).contiguous())
    if grad.wanted(*args):
        return grad.SSDIntra.apply("ssd_intra", K.ssd_intra, ref.ssd_intra,
                                   *args)
    return K.ssd_intra(*args)

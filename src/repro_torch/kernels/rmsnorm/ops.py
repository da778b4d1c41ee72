"""Public RMSNorm entry (the derived-scalar scaling: the scale factor is
computed from the row itself and applied in the same pass).

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches ``rmsnorm_2d``, a CPU tensor (or ``backend="ref"``) runs the
plain version.  The JAX package's ``block_rows``/tuning-cache knob is
left out: rows normalise independently, so it never changed results,
and the CUDA kernel sizes its row groups to the row itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.rmsnorm import ref
from repro_torch.kernels.rmsnorm import rmsnorm as K


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float = 1e-6,
            backend: str | None = None) -> torch.Tensor:
    """y = x / rms(x) * gain over the trailing dim of ``x`` (any rank);
    ``gain`` is (N,), used in float32."""
    b = dispatch.backend_for(x.device, backend)
    if b == "ref":
        return ref.rmsnorm(x, gain, eps)
    n = x.shape[-1]
    out = K.rmsnorm_2d(x.contiguous().reshape(-1, n),
                       gain.to(torch.float32).contiguous(), eps=eps)
    return out.reshape(x.shape)

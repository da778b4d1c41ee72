"""Public RMSNorm entry (the derived-scalar scaling: the scale factor is
computed from the row itself and applied in the same pass).

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches ``rmsnorm_2d``, a CPU tensor (or ``backend="ref"``) runs the
plain version; a CUDA call that autograd records launches through
``kernels.grad.RMSNorm`` (the gain gets its gradient too).  The JAX
package's TPU ``block_rows`` knob becomes the
16-byte kernel's ``row_warps`` (the warps a row): an explicit ``config``
wins, else the tuning cache when autotuning is enabled, else the
kernel's own choice for the row.
"""
from __future__ import annotations

import torch

from repro_torch.autotune import cache as tuning
from repro_torch.autotune.cache import KernelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch, grad
from repro_torch.kernels.rmsnorm import ref
from repro_torch.kernels.rmsnorm import rmsnorm as K


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float = 1e-6,
            backend: str | None = None,
            config: KernelConfig | None = None) -> torch.Tensor:
    """y = x / rms(x) * gain over the trailing dim of ``x`` (any rank);
    ``gain`` is (N,), used in float32.  On DTensors the kernel runs on
    the local rows, the trailing dim and the gain made whole first."""
    if sharding.any_dtensor(x, gain):
        return sharding.local_call(
            lambda a, g: rmsnorm(a, g, eps=eps, backend=backend,
                                 config=config), (x, gain),
            (tuple(range(x.dim() - 1)), ()))
    b = dispatch.backend_for(x.device, backend)
    if b == "ref":
        return ref.rmsnorm(x, gain, eps)
    n = x.shape[-1]
    cfg = config or tuning.config_for("rmsnorm", b,
                                      tuning.dtype_name(x.dtype), x.numel())
    x2, g32 = x.contiguous().reshape(-1, n), gain.to(torch.float32).contiguous()

    def kernel(x2, g32):
        return K.rmsnorm_2d(x2, g32, eps=eps, row_warps=cfg.row_warps)
    if grad.wanted(x2, g32):
        out = grad.RMSNorm.apply("rmsnorm_2d", kernel,
                                 lambda a, g: ref.rmsnorm(a, g, eps), x2, g32)
    else:
        out = kernel(x2, g32)
    return out if out.shape == x.shape else out.reshape(x.shape)

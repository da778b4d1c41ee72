"""Plain PyTorch RMSNorm (fp32 statistics, LLaMA convention), the port of
the JAX package's ``kernels/rmsnorm/ref.py`` and the function of the
``rmsnorm_2d`` kernel: ``x * rsqrt(mean(x*x) + eps) * gain`` with x and
gain widened to float32, rounded to x's dtype at the end."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x*x) + eps) * gain over the trailing dim."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gain.float()).to(x.dtype)

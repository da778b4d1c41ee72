"""Kernel backend and device dispatch.

Every kernel family exposes its public entry points through ``ops.py``
with a ``backend`` argument resolved here:

  * ``cuda`` -- the hand-written CUDA kernel (``kernels/csrc``), built for
                ``sm_90a`` at first use; takes CUDA tensors only;
  * ``ref``  -- the plain PyTorch version in ``ref.py``: one separately
                rounded eager op at a time, on whatever device the
                tensor lies on.

With ``backend=None`` the choice follows the tensor: a CUDA tensor
launches the kernel, a CPU tensor runs the plain version.  ``backend="ref"``
on a CUDA tensor is an explicit request (the on-card comparison in
``chip_smoke.py``); ``backend="cuda"`` on a CPU tensor raises.  There is
no silent degrade from one to the other.

``device`` is the other half: entry points that create tensors default
to ``"cuda"`` and raise when no GPU is present; they run on the CPU only
when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

BACKENDS = ("cuda", "ref")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: raises when CUDA is asked for
    and absent (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default -- pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def place(points, device: str | torch.device = "cuda") -> torch.Tensor:
    """``points`` as a tensor: a tensor stays where it lies, anything else
    (a numpy array, a list) is copied to ``device`` -- the GPU unless the
    caller asks for the CPU."""
    if isinstance(points, torch.Tensor):
        return points
    return torch.as_tensor(points, device=resolve_device(device))


def backend_for(device: torch.device, backend: str | None = None) -> str:
    """The backend that runs on ``device`` (a tensor's or a server's): the
    kernel on CUDA, the plain version on the CPU, unless ``backend`` says
    which."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    return backend


def param_tensor(v, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """Kernel parameters ``v`` (a scalar, array or tensor) as a contiguous
    tensor of ``shape`` with ``like``'s dtype and device."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.broadcast_to(shape).contiguous()

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

``use_backend("ref")`` sets the default for every op called inside it,
as the JAX package's global backend does: the model stack picks its
kernels that way (``ssm._ssd_chunked`` reads no per-call backend), and
``chip_smoke.py`` runs the whole model on the plain versions on the card
to hold the kernel path against it.  A per-call ``backend`` still wins.

``device`` is the other half: entry points that create tensors default
to ``"cuda"`` and raise when no GPU is present; they run on the CPU only
when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch

BACKENDS = ("cuda", "ref")
#: the serving engine's degradation ladder, fastest substrate first: a
#: launch that keeps failing on the hand-written kernel (``cuda``) by
#: injected faults falls to the plain version on the same device
#: (``ref``).  Both compute the same function, so degrading trades
#: speed, never results; a kernel that fails on its own never falls.
FALLBACK_ORDER = ("cuda", "ref")
#: the backend every op takes when its call names none (None: by device)
_BACKEND: str | None = None


@contextlib.contextmanager
def use_backend(name: str | None):
    """Run every op inside on ``name`` unless its call names a backend."""
    global _BACKEND
    if name is not None and name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    prev, _BACKEND = _BACKEND, name
    try:
        yield
    finally:
        _BACKEND = prev


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
    which (or ``use_backend`` set a default)."""
    backend = backend or _BACKEND
    if backend is None:
        return "cuda" if device.type == "cuda" else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    return backend


def fallback_ladder(backend: str) -> tuple[str, ...]:
    """The rungs a failing launch may degrade through, starting at (and
    including) a server's resolved ``backend`` (``backend_for`` of its
    device): ``("cuda", "ref")`` on a CUDA server, ``("ref",)`` on a CPU
    one or a server that asked for the plain version."""
    if backend not in FALLBACK_ORDER:
        raise ValueError(f"backend must be one of {FALLBACK_ORDER}, "
                         f"got {backend!r}")
    return FALLBACK_ORDER[FALLBACK_ORDER.index(backend):]


def param_tensor(v, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """Kernel parameters ``v`` (a scalar, array or tensor) as a contiguous
    tensor of ``shape`` with ``like``'s dtype and device."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.broadcast_to(shape).contiguous()

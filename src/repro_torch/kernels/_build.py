"""Build the CUDA kernels under ``kernels/csrc`` and bind them with ctypes.

Each ``csrc/*.cu`` source has a plain C interface and builds on its own
into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

at first use, from the sources in the checkout only.  The library name
carries a hash of the sources, so an edited kernel is rebuilt and a
stale build is never loaded.  ``build_all`` starts one ``nvcc`` per
source, all together, and waits for them.  A failed build raises; no
caller falls back to the plain version.

``CudaKernel`` is one C entry point: it launches on PyTorch's current
stream, raises when the C function reports a CUDA error, and counts its
launches (``launch_counts``/``reset_launch_counts``), so a run can show
that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: the git-ignored build directory at the root of the checkout
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: every CudaKernel ever made, by name (the launch-count registry)
KERNELS: dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "kernels/csrc at first use and need the CUDA toolkit")


def _target(source: str) -> Path:
    """The library path for ``csrc/<source>.cu``, keyed by a hash of every
    file in ``csrc`` (the sources include the shared header)."""
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:16]}.so"


def sources() -> list[str]:
    """The kernel sources in the checkout, by stem."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, Path]:
    """Compile every source not yet built, one ``nvcc`` each, all started
    together; raises with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {s: _target(s) for s in sources()}
    procs = {}
    for src, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return todo


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = build_all()[source]
            lib = _LIBS[source] = ctypes.CDLL(str(path))
        return lib


class CudaKernel:
    """One C entry point ``int name(ptrs..., sizes..., stream)`` of a
    built library: pointer arguments and the stream are ``c_void_p``,
    sizes ``c_int64``, the return value is ``cudaGetLastError()``."""

    def __init__(self, source: str, name: str, n_ptrs: int, n_sizes: int):
        self.source, self.name = source, name
        self.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * n_sizes
                         + [ctypes.c_void_p])
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, device: torch.device, *args: int) -> None:
        """Launch on ``device``'s current stream; ``args`` are the data
        pointers then the sizes, as Python ints."""
        if self._fn is None:
            fn = getattr(library(self.source), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: {torch.cuda.CudaError(rc)}")
        self.launches += 1


def check_operands(x: torch.Tensor, *params: torch.Tensor, d: int,
                   dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    (float32 for the float lane, int16 for the Qm.n lane) on x's device
    and d is a dimension the kernels are built for."""
    if d not in (2, 3):
        raise ValueError(f"the chain kernels take d in (2, 3), got {d}")
    for a in (x, *params):
        if not a.is_cuda or a.device != x.device:
            raise ValueError(f"kernel operands must lie on one CUDA device, "
                             f"got {a.device} beside {x.device}")
        if a.dtype != dtype:
            raise TypeError(f"kernel operands must be {dtype}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset, by kernel name."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0

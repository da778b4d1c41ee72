"""Build the CUDA kernels under ``kernels/csrc`` and bind them with ctypes.

Each ``csrc/*.cu`` source has a plain C interface and builds on its own
into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -split-compile=0 -Xptxas -v \\
         -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

at first use, from the sources in the checkout only (``-split-compile=0``
runs one source's optimisation passes on every core, so a source with
many template instances, such as ``flash_attention.cu``, does not hold
the build for long after the others).  The library name
carries a hash of the sources, so an edited kernel is rebuilt and a
stale build is never loaded.  ``build_all`` starts one ``nvcc`` per
source, all together, and waits for them.  A failed build raises; no
caller falls back to the plain version.  The compiler's report (``-Xptxas
-v``: each kernel instance's registers, spills and shared memory) is kept
beside the library; ``resource_usage`` reads it.  The sources include
``csrc/hopper.cuh`` (TMA, mbarriers, wgmma) and ``csrc/launch.cuh``; no
library links ``-lcuda`` (the tensor-map encoder comes through the CUDA
runtime's driver entry point).

``CudaKernel`` is one C entry point: it launches on PyTorch's current
stream, raises when the C function reports a CUDA error, and counts its
launches (``launch_counts``/``reset_launch_counts``), so a run can show
that its path went through the kernels; it also keeps the size
arguments of its launches (``launch_sizes``), so a run can show that
each shape its path launched was held against the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: the git-ignored build directory at the root of the checkout
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
              "-Xptxas", "-v")

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
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return todo


def resource_usage(source: str) -> list[dict]:
    """Each kernel instance of ``csrc/<source>.cu`` as its build's
    ``ptxas`` reported it: ``{"function": mangled name, "registers": n,
    "spill_stores": bytes, "spill_loads": bytes}`` (built on first use)."""
    log = build_all()[source].with_suffix(".log").read_text()
    usage, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = {"function": m.group(1)}
            usage.append(fn)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
    return usage


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
        self.n_ptrs, self.launches, self.sizes = n_ptrs, 0, set()
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
        self.sizes.add(args[self.n_ptrs:])


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


#: the float types of the eager-primitive kernels (affine_2d, vecadd_2d,
#: matmul_2d) and the flag each kernel's C entry takes for them
DENSE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_dense(*tensors: torch.Tensor) -> int:
    """Raise unless every tensor is a contiguous CUDA tensor on the first
    one's device, all of one dtype of ``DENSE_DTYPES``; returns that
    dtype's flag (0 float32, 1 bfloat16)."""
    first = tensors[0]
    for a in tensors:
        if not a.is_cuda or a.device != first.device:
            raise ValueError(f"kernel operands must lie on one CUDA device, "
                             f"got {a.device} beside {first.device}")
        if a.dtype not in DENSE_DTYPES or a.dtype != first.dtype:
            raise TypeError(f"kernel operands must all be float32 or all "
                            f"bfloat16, got {a.dtype} beside {first.dtype}")
        if not a.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return DENSE_DTYPES[first.dtype]


def chain_knobs(block_threads: int | None = None,
                waves: int | None = None) -> tuple[int, int]:
    """The chain kernels' launch knobs as the two int64 sizes their C
    entries take (``csrc/launch.cuh``), 0 for the kernel's own choice:
    the scalar kernels' threads a block and the grid's cap in waves of
    resident blocks.  Raises ``ValueError`` for a knob no launch takes
    (a block that is no multiple of 32 from 32 to 1024, fewer than one
    wave); nothing is quietly replaced by the default."""
    bt = block_threads or 0
    w = waves or 0
    if bt and not (32 <= bt <= 1024 and bt % 32 == 0):
        raise ValueError(f"block_threads must be a multiple of 32 from 32 "
                         f"to 1024, got {block_threads}")
    if w and not 1 <= w <= 1024:
        raise ValueError(f"waves must be from 1 to 1024, got {waves}")
    return int(bt), int(w)


def f32_bits(v: float) -> int:
    """A float as the int64 the C entry takes for it: its float32 bits
    (the C side reads them back with ``repro::f32_from_bits``)."""
    return struct.unpack("<i", struct.pack("<f", float(v)))[0]


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset, by kernel name."""
    return {name: k.launches for name, k in KERNELS.items()}


def launch_sizes() -> dict[str, set[tuple]]:
    """The distinct size arguments (everything after the pointers: shapes,
    scalars' bits, the dtype flag) each kernel was launched with since the
    last reset, by kernel name."""
    return {name: set(k.sizes) for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0 and forget its sizes."""
    for k in KERNELS.values():
        k.launches = 0
        k.sizes.clear()

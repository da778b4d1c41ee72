"""The port's import boundary: ``repro_torch`` loads neither jax nor the
JAX package, and its entry points run on the GPU by default -- without
one they raise instead of falling back to the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(len(names), ",".join(bad))
print(" ".join(names))
"""


def test_import_loads_no_jax_or_repro():
    """Every submodule imports in a fresh interpreter (pytest has loaded
    jax already) without pulling jax or ``repro`` into sys.modules."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    counts, names = res.stdout.splitlines()
    n_modules, bad = counts.split()[0], counts.split()[1:]
    assert int(n_modules) >= 20
    assert bad == [], f"imported {bad}"
    for module in ("repro_torch.graphics", "repro_torch.graphics.camera",
                   "repro_torch.graphics.pipeline",
                   "repro_torch.graphics.viewport",
                   "repro_torch.kernels.projective",
                   "repro_torch.kernels.projective.ops",
                   "repro_torch.kernels.projective.projective",
                   "repro_torch.kernels.projective.ref",
                   "repro_torch.quantize", "repro_torch.quantize.chains",
                   "repro_torch.quantize.qformat",
                   "repro_torch.kernels.fixedpoint",
                   "repro_torch.kernels.fixedpoint.fixedpoint",
                   "repro_torch.kernels.fixedpoint.ops",
                   "repro_torch.kernels.fixedpoint.ref"):
        assert module in names.split(), module


_Q_PROBE = r"""
import sys
from repro_torch import quantize
from repro_torch.kernels import fixedpoint
w = quantize.Q8_7.quantize([1.5, -300.0])
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(w.tolist(), ",".join(bad))
"""


def test_q_lane_modules_load_no_jax_or_repro():
    """The fixed-point lane on its own -- ``repro_torch.quantize`` and
    ``repro_torch.kernels.fixedpoint`` imported first in a fresh
    interpreter -- pulls in neither jax nor ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _Q_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["[192,", "-32768]"]


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)")
    hits = [f"{p}:{i}" for p in sorted((SRC / "repro_torch").rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert hits == []


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import serving
    from repro_torch.core.transform_chain import TransformChain
    from repro_torch.launch import serve_transforms
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.GeometryServer()
    chain = TransformChain.identity(2).translate(1.0, 2.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain.apply(np.ones((4, 2), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_transforms.main(["--smoke", "--no-compare"])
    from repro_torch import graphics
    view = graphics.viewing_chain(camera=graphics.Camera())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        view.project(np.ones((4, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain.apply(np.ones((4, 2), np.float32), dtype="q8.7")


def test_cuda_backend_on_cpu_tensor_raises():
    """A CPU tensor never reaches a kernel by accident, and a kernel
    wrapper never runs its plain version in its place."""
    from repro_torch.kernels import chain_apply, chain_diag, chain_project, \
        chain_project_batch
    from repro_torch.kernels.affine import affine
    from repro_torch.kernels.projective import projective
    x = torch.ones(5, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_diag(x, 1.0, 0.0, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_apply(x, torch.eye(2), torch.zeros(2), backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        affine.chain_diag_1d(x.reshape(-1), torch.ones(2), torch.zeros(2), d=2)
    with pytest.raises(ValueError, match="backend must be"):
        chain_diag(x, 1.0, 0.0, backend="interpret")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_project(x, torch.eye(3), backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_project_batch(x[None], torch.eye(3), backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        projective.chain_project_1d(x.reshape(-1), torch.eye(3),
                                    torch.zeros(2), torch.ones(2), d=2)
    from repro_torch.kernels import chain_apply_q, chain_diag_batch_q
    from repro_torch.kernels.fixedpoint import fixedpoint
    w = torch.ones(5, 2, dtype=torch.int16)
    w2 = torch.ones(2, dtype=torch.int16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_apply_q(w, torch.eye(2).to(torch.int16), w2, n_frac=7,
                      backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_diag_batch_q(w[None], w2[None], w2[None], n_frac=7,
                           backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        fixedpoint.chain_matrix_1d_q(w.reshape(-1), torch.eye(2).to(
            torch.int16), w2, d=2, n_frac=7)

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
"""


def test_import_loads_no_jax_or_repro():
    """Every submodule imports in a fresh interpreter (pytest has loaded
    jax already) without pulling jax or ``repro`` into sys.modules."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split()[0], res.stdout.split()[1:]
    assert int(n_modules) >= 20
    assert bad == [], f"imported {bad}"


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


def test_cuda_backend_on_cpu_tensor_raises():
    """A CPU tensor never reaches a kernel by accident, and a kernel
    wrapper never runs its plain version in its place."""
    from repro_torch.kernels import chain_apply, chain_diag
    from repro_torch.kernels.affine import affine
    x = torch.ones(5, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_diag(x, 1.0, 0.0, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_apply(x, torch.eye(2), torch.zeros(2), backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        affine.chain_diag_1d(x.reshape(-1), torch.ones(2), torch.zeros(2), d=2)
    with pytest.raises(ValueError, match="backend must be"):
        chain_diag(x, 1.0, 0.0, backend="interpret")

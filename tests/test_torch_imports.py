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
                   "repro_torch.kernels.fixedpoint.ref",
                   "repro_torch.core.transform_engine",
                   "repro_torch.core.analysis",
                   "repro_torch.core.morphosys",
                   "repro_torch.core.morphosys.rc_array",
                   "repro_torch.core.morphosys.isa",
                   "repro_torch.core.morphosys.programs",
                   "repro_torch.core.morphosys.intel",
                   "repro_torch.models", "repro_torch.models.attention",
                   "repro_torch.models.blocks", "repro_torch.models.config",
                   "repro_torch.models.layers", "repro_torch.models.ssm",
                   "repro_torch.models.transformer", "repro_torch.configs",
                   "repro_torch.configs.hymba_1_5b",
                   "repro_torch.launch.serve",
                   "repro_torch.kernels.rmsnorm.rmsnorm",
                   "repro_torch.kernels.rope.rope",
                   "repro_torch.kernels.flash_attention.flash_attention",
                   "repro_torch.kernels.ssd.ssd",
                   "repro_torch.obs", "repro_torch.obs.metrics",
                   "repro_torch.obs.trace", "repro_torch.obs.recorder",
                   "repro_torch.obs.export", "repro_torch.obs.slo",
                   "repro_torch.serving.clock",
                   "repro_torch.serving.admission",
                   "repro_torch.serving.async_engine",
                   "repro_torch.serving.faults",
                   "repro_torch.autotune", "repro_torch.autotune.__main__",
                   "repro_torch.autotune.cache",
                   "repro_torch.autotune.costmodel",
                   "repro_torch.autotune.search", "repro_torch.obs.profile"):
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


_EMULATOR_PROBE = r"""
import sys
from repro_torch.core.morphosys import programs
from repro_torch.core import analysis, transform_engine
r = programs.run_scaling(list(range(8)), 5)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(r.cycles, int(r.values[-1]), ",".join(bad))
"""


def test_emulator_and_engine_load_no_jax_or_repro():
    """The M1 emulator, the table arithmetic and the transform engine,
    imported first in a fresh interpreter, pull in neither jax nor
    ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _EMULATOR_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["14", "35"]


_MODEL_PROBE = r"""
import sys
from repro_torch import configs
from repro_torch.kernels import attention, rmsnorm, rope, ssd_intra
from repro_torch.kernels.flash_attention import flash_attention, ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms_k
from repro_torch.kernels.rope import rope as rope_k
from repro_torch.kernels.ssd import ssd
from repro_torch.launch import serve
from repro_torch.models import build
cfg = configs.get("hymba-1.5b")
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(cfg.param_count(), cfg.head_dim, ",".join(bad))
"""


_SERVING_PROBE = r"""
import sys
from repro_torch.serving import faults
from repro_torch.serving.async_engine import AsyncGeometryServer
from repro_torch.serving.clock import VirtualClock
from repro_torch import obs
from repro_torch.obs import slo
rep = faults.run_chaos_soak(seed=1, n_requests=16, device="cpu")
eng = AsyncGeometryServer(device="cpu", clock=VirtualClock())
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(rep.lost, rep.backend, obs.Tracer.__module__, ",".join(bad))
"""


def test_fault_and_async_serving_load_no_jax_or_repro():
    """The fault-tolerant and async serving layer and the obs package,
    imported first in a fresh interpreter and run once, pull in neither
    jax nor ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _SERVING_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["0", "ref", "repro_torch.obs.trace"]


_AUTOTUNE_PROBE = r"""
import sys
import repro_torch.autotune.__main__ as cli
from repro_torch import autotune
from repro_torch.autotune import costmodel, search
from repro_torch.obs import profile
cache, reports = search.smoke_search(device="cpu", measure=lambda c: 1.0)
tracer, _ = profile.profile_smoke_workload(8, device="cpu")
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(len(cache), costmodel.morphosys_cycles("translation", 64),
      profile.Profile.from_tracer(tracer).byte_ratio_exact, ",".join(bad))
"""


def test_autotune_and_profiler_load_no_jax_or_repro():
    """``repro_torch.autotune`` (its CLI included) and
    ``repro_torch.obs.profile``, imported first in a fresh interpreter and
    run once, pull in neither jax nor ``repro`` -- the tuning cache is a
    copy of the JAX package's jax-free module, not an import of it."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _AUTOTUNE_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["7", "96", "True"]


def test_model_stack_loads_no_jax_or_repro():
    """The model stack -- ``repro_torch.models``, ``.configs``,
    ``.launch.serve`` and the four kernel families -- imported first in a
    fresh interpreter pulls in neither jax nor ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _MODEL_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1589616896", "64"]


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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.AsyncGeometryServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.run_chaos_soak(n_requests=4)
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
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import build
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "hymba-1.5b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(configs.get("mamba2-130m").reduced()).init_cache(1, 8)


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
    from repro_torch.kernels import attention, rmsnorm, rope, ssd_intra
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm as rms_k
    from repro_torch.kernels.rope import rope as rope_k
    from repro_torch.kernels.ssd import ssd
    h = torch.ones(1, 2, 8, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rmsnorm(x, torch.ones(2), backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rope(h, torch.ones(8, 8), torch.zeros(8, 8), backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        attention(h, h, h, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd_intra(torch.ones(1, 16, 2, 16), torch.ones(1, 16, 16),
                  torch.ones(1, 16, 16), torch.zeros(1, 16, 2),
                  backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        rms_k.rmsnorm_2d(x, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA device"):
        rope_k.rope_3d(h[0], torch.ones(8, 8), torch.zeros(8, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention.flash_attention_3d(h[0], h[0], h[0], scale=0.25)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd.ssd_intra(torch.ones(1, 16, 2, 16), torch.ones(1, 16, 16),
                      torch.ones(1, 16, 16), torch.zeros(1, 16, 2))


def test_use_backend_sets_the_default_and_restores_it():
    """``dispatch.use_backend`` routes every op without a per-call backend
    (a CPU tensor under "cuda" raises, as the model stack would) and puts
    the default back on exit; a per-call backend still wins."""
    from repro_torch.kernels import dispatch, rmsnorm
    from repro_torch.kernels.rmsnorm import ref
    x, g = torch.arange(24.0).reshape(3, 8), torch.ones(8)
    with dispatch.use_backend("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            rmsnorm(x, g)
        assert torch.equal(rmsnorm(x, g, backend="ref"), ref.rmsnorm(x, g))
    assert dispatch.backend_for(x.device) == "ref"
    with pytest.raises(ValueError, match="backend must be"):
        with dispatch.use_backend("interpret"):
            pass

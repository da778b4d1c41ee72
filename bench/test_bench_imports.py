"""The benchmark never loads JAX or the JAX package, and its reference
loads nothing of the program under test: each checked in a fresh
interpreter, by the top-level name of every loaded module (the part
before the first dot), compared whole."""
import functools
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
def top():
    return sorted({{n.split(".")[0] for n in sys.modules}})
import bench.reference, bench.weights, bench.train_inputs, bench.counts
reference = top()
import bench.run, bench.harness, bench.serve_cell, bench.train_cell
import bench.trace, bench.traffic
import repro_torch.launch.serve, repro_torch.launch.train
import repro_torch.models, repro_torch.models.config, repro_torch.optim
print(json.dumps({{"reference": reference, "runner": top()}}))
"""


@functools.lru_cache(maxsize=1)
def _loaded() -> dict:
    """The top-level names loaded by the reference's imports, then by the
    runner's (the reference first, in one fresh interpreter)."""
    code = PROBE.format(root=ROOT, src=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: set(v) for k, v in got.items()}


@pytest.mark.parametrize("which", ["runner", "reference"])
def test_no_jax_and_no_program_in_the_reference(which):
    loaded = _loaded()[which]
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
    if which == "runner":
        assert "repro_torch" in loaded   # the probe reaches the program
    else:
        assert "repro_torch" not in loaded

"""The port's copies of the JAX package's jax-free shape tables: the
input shapes, their applicability, the 40 cells, the micro-batch knobs
and ``data.make_batch_specs``'s stand-ins, each equal to the
reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.data import DataConfig, make_batch_specs  # noqa: E402


def test_shapes_equal_the_reference():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jshapes.SHAPES[name])


def test_microbatch_per_shard_equals_the_reference():
    assert shapes.MICROBATCH_PER_SHARD == jshapes.MICROBATCH_PER_SHARD
    assert set(shapes.MICROBATCH_PER_SHARD) == set(configs.list_archs())


@pytest.mark.parametrize("arch", configs.list_archs())
def test_applicability_equals_the_reference(arch):
    for name in shapes.SHAPES:
        assert shapes.applicability(configs.get(arch), name) == \
            jshapes.applicability(jconfigs.get(arch), name)


def test_cells_equal_the_reference():
    archs = configs.list_archs()
    port = shapes.cells(archs)
    assert port == jshapes.cells(archs)
    assert len(port) == 40
    assert all(ok == (why == "") for _, _, ok, why in port)


@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
def test_make_batch_specs_equals_the_reference(frontend):
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=8,
                     frontend=frontend, n_frontend_tokens=16, d_model=32)
    jcfg = jpipeline.DataConfig(**dataclasses.asdict(cfg))
    port = make_batch_specs(cfg)
    ref = jpipeline.make_batch_specs(jcfg)
    assert list(port) == list(ref)
    for k, v in port.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(ref[k].shape)
        assert np.dtype(str(v.dtype).removeprefix("torch.")) == \
            np.dtype(jnp.dtype(ref[k].dtype))

"""The port's sharding rules against the JAX package's: every leaf's
local shard, exactly.

For a reduced config of every family (dense, MoE, SSM, hybrid, enc-dec,
VLM) on the meshes (4, 2), (8, 1) and (2, 2, 2), the parameters, the
optimizer state, a training and a serving batch (one of batch 1, which
the sanitizing replicates) and the serving cache are placed by the
port's rules on a fake world of 8 ranks (``FakeTensorMode``: no
storage) and each local shard's shape is held against the reference's
``NamedSharding(mesh, spec).shard_shape`` with the layer axis dropped
(the port keeps a list of per-layer leaves where the reference stacks
them).  The reference runs in a subprocess with 8 host devices, as
``tests/test_dryrun_mesh.py`` does.  Then the counterparts of the
reference's ``TestParamSpecs`` and the mesh helpers.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_mod  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"dense": "yi-6b", "moe": "granite-moe-3b-a800m",
         "ssm": "mamba2-130m", "hybrid": "hymba-1.5b",
         "encdec": "whisper-medium", "vlm": "internvl2-76b"}
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ACCUM, MICRO, SEQ, SERVE_B, MAX_LEN = 2, 8, 32, 8, 64

_REFERENCE = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro import configs
from repro.distributed import sharding
from repro.launch import cells
from repro.launch.mesh import make_mesh
from repro.models import build
from repro.optim import adamw_init
ARCHS, MESHES = %(archs)r, %(meshes)r
ACCUM, MICRO, SEQ, SERVE_B, MAX_LEN = %(sizes)r

def shards(tree, specs, mesh):
    specs = sharding.sanitize_specs(tree, specs, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): [list(l.shape), list(
        NamedSharding(mesh, s).shard_shape(l.shape))]
        for (p, l), s in zip(flat, sflat)}

out = {}
for fam, arch in ARCHS.items():
    cfg = configs.get(arch).reduced()
    model = build(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    opt = jax.eval_shape(adamw_init, params)
    train = cells._train_batch_struct(cfg, type("S", (), {"seq_len": SEQ}),
                                      ACCUM, MICRO)
    serve = cells._serve_batch_struct(cfg, SERVE_B, SEQ)
    serve1 = cells._serve_batch_struct(cfg, 1, SEQ)
    cache = model.cache_struct(SERVE_B, MAX_LEN,
                               SEQ if cfg.is_encdec else 0)
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, devices=jax.devices()[:8])
        ps = sharding.params_specs(params, mesh)
        out[f"{fam}/{name}"] = {
            "params": shards(params, ps, mesh),
            "opt": shards(opt, sharding.opt_specs(opt, ps), mesh),
            "train": shards(train, sharding.batch_specs(
                train, mesh, accum_dim=True), mesh),
            "serve": shards(serve, sharding.batch_specs(
                serve, mesh, accum_dim=False), mesh),
            "serve1": shards(serve1, sharding.batch_specs(
                serve1, mesh, accum_dim=False), mesh),
            "cache": shards(cache, sharding.cache_specs(cache, cfg, mesh),
                            mesh),
        }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    code = _REFERENCE % {"archs": ARCHS, "meshes": MESHES,
                         "sizes": (ACCUM, MICRO, SEQ, SERVE_B, MAX_LEN)}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _key(path: str) -> str:
    """A leaf's path without its layer index, as the reference's."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


def _ref_key(keystr: str) -> str:
    return "/".join(re.findall(r"\['([^']*)'\]", keystr))


def _port_shards(tree, specs, mesh) -> dict:
    """{path without layer index: [(global shape, local shape), ...]}."""
    placed = elastic.place(tree, mesh, specs)
    out: dict = {}

    def visit(path, leaf):
        if isinstance(leaf, torch.Tensor):
            out.setdefault(_key(path), []).append(
                (list(leaf.shape), list(leaf.to_local().shape)))
    sharding.tree_map_with_path(visit, placed)
    return out


def _port(fam: str, mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import cells
    from repro_torch.configs.shapes import ShapeSpec
    cfg = configs.get(ARCHS[fam]).reduced()
    model = build(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = model.init(torch.Generator().manual_seed(0))
        opt = adamw_init(params)
        spec = ShapeSpec("t", SEQ, ACCUM * MICRO, "train")
        train = cells._train_batch(cfg, spec, ACCUM, MICRO)
        serve = cells._serve_batch(cfg, SERVE_B, SEQ)
        serve1 = cells._serve_batch(cfg, 1, SEQ)
        cache = model.init_cache(SERVE_B, MAX_LEN,
                                 SEQ if cfg.is_encdec else 0, device="cpu")
        ps = sharding.params_specs(params, mesh)
        return {
            "params": _port_shards(params, ps, mesh),
            "opt": _port_shards(opt, sharding.opt_specs(opt, ps), mesh),
            "train": _port_shards(train, sharding.batch_specs(
                train, mesh, accum_dim=True), mesh),
            "serve": _port_shards(serve, sharding.batch_specs(
                serve, mesh, accum_dim=False), mesh),
            "serve1": _port_shards(serve1, sharding.batch_specs(
                serve1, mesh, accum_dim=False), mesh),
            "cache": _port_shards(cache, sharding.cache_specs(
                cache, cfg, mesh), mesh),
        }


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fam", list(ARCHS))
def test_shard_shapes_equal_the_reference(reference, fam, mesh_name):
    shape, axes = MESHES[mesh_name]
    port = _port(fam, dryrun.fake_mesh(shape, axes))
    ref = reference[f"{fam}/{mesh_name}"]
    for tree in ("params", "opt", "train", "serve", "serve1", "cache"):
        want = {_ref_key(k): v for k, v in ref[tree].items()}
        got = port[tree]
        if tree == "opt":        # the step: a host int in the port
            want.pop("step")
        assert set(got) == set(want), (tree, set(got) ^ set(want))
        for k, (gshape, gshard) in want.items():
            for pshape, pshard in got[k]:
                if pshape == gshape:
                    assert pshard == gshard, (tree, k)
                else:            # the stacked layer axis, dropped
                    assert pshape == gshape[1:], (tree, k)
                    assert pshard == gshard[1:], (tree, k)


# -- the counterparts of the reference's TestParamSpecs -----------------------

def test_column_parallel():
    assert sharding.param_spec("layers/3/attn/wq", 2, ("data",),
                               "model") == (("data",), "model")


def test_row_parallel():
    assert sharding.param_spec("layers/3/attn/wo", 2, ("data",),
                               "model") == ("model", ("data",))


def test_embed():
    assert sharding.param_spec("embed", 2, ("pod", "data"), "model") == \
        ("model", ("pod", "data"))


def test_moe_expert_weights_keep_expert_dim_whole():
    assert sharding.param_spec("layers/0/moe/w_gate", 3, ("data",),
                               "model") == (None, ("data",), "model")


def test_norm_gains_whole():
    assert sharding.param_spec("layers/0/attn_norm", 1, ("data",),
                               "model") == (None,)


def test_sanitize_drops_nondividing_axis():
    mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
    shapes = {"embed": torch.empty((50282, 768), device="meta")}
    fixed = sharding.sanitize_specs(shapes, {"embed": ("model", "data")},
                                    mesh)
    assert fixed["embed"] == (None, "data")   # 50282 % 4 != 0


def test_sanitize_keeps_dividing_axis():
    mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
    shapes = {"w": torch.empty((128256, 8192), device="meta")}
    assert sharding.sanitize_specs(shapes, {"w": ("model", "data")},
                                   mesh)["w"] == ("model", "data")


# -- the mesh helpers ---------------------------------------------------------

def test_mesh_context_nests_and_resets():
    assert sharding.ambient_mesh() is None
    with mesh_mod.mesh_context("outer"):
        with mesh_mod.mesh_context("inner"):
            assert sharding.ambient_mesh() == "inner"
        assert sharding.ambient_mesh() == "outer"
    assert sharding.ambient_mesh() is None


def test_constrain_and_gathered_pass_plain_tensors():
    x = torch.ones(4, 8)
    assert sharding.constrain(x, "batch", "model") is x
    with mesh_mod.mesh_context(dryrun.fake_mesh((2, 4), ("data", "model"))):
        assert sharding.constrain(x, "batch", "model") is x
    tree = {"a": [x]}
    assert sharding.gathered(tree)["a"][0] is x


def test_production_meshes_need_their_ranks():
    dryrun.fake_world(8)
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_mod.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True)
    m = mesh_mod.make_local_mesh(model_axis=2)
    assert tuple(m.shape) == (4, 2) and m.mesh_dim_names == ("data",
                                                             "model")


def test_production_mesh_shapes_and_names():
    m = dryrun.fake_mesh((16, 16), ("data", "model"))
    assert tuple(mesh_mod.make_production_mesh().shape) == (16, 16)
    assert m.mesh_dim_names == ("data", "model")
    dryrun.fake_world(512)
    m3 = mesh_mod.make_production_mesh(multi_pod=True)
    assert tuple(m3.shape) == (2, 16, 16)
    assert m3.mesh_dim_names == ("pod", "data", "model")


def test_replan_accum_takes_a_mesh():
    mesh = dryrun.fake_mesh((4, 2), ("data", "model"))
    assert elastic.replan_accum(64, 2, mesh) == 8
    mesh3 = dryrun.fake_mesh((2, 2, 2), ("pod", "data", "model"))
    assert elastic.replan_accum(64, 2, mesh3) == 8
    assert elastic.replan_accum(64, 2) == 32
    with pytest.raises(ValueError, match="not divisible"):
        elastic.replan_accum(12, 2, mesh)


def test_shard_map_and_to_shardings_on_a_fake_world():
    """``shard_map`` runs a function on the local shards with specs for
    placements; ``to_shardings`` gives (mesh, placements) per leaf, the
    specs sanitized against the shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    mesh = dryrun.fake_mesh((4, 2), ("data", "model"))
    with FakeTensorMode():
        x = elastic.place({"x": torch.zeros(8, 6)}, mesh,
                          {"x": (("data",), None)})["x"]
        fn = sharding.shard_map(lambda a: a * 2, mesh=mesh,
                                in_specs=((("data",), None),),
                                out_specs=(("data",), None))
        y = fn(x)
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert tuple(y.to_local().shape) == (2, 6)
    sh = sharding.to_shardings({"w": ("model", "data")}, mesh,
                               {"w": torch.empty((5, 8), device="meta")})
    assert sh["w"] == (mesh, (Shard(1), Replicate()))

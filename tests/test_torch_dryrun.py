"""The port's dry-run on a fake world, no GPU: the dispatch-trace
analysis (``hlo_analysis``), the cells and their records, and the
analytic counts against the JAX package's.

  * a plain product's FLOPs are exactly 2MNK over the devices;
  * a train step's accumulation loop traced once and multiplied by its
    trip count equals the loop traced in full (FLOPs and collectives);
  * a one-device cell has no collectives;
  * mamba2-130m ``decode_32k`` on (4, 2) and hymba-1.5b ``decode_32k``
    on (2, 2, 2) report FLOPs > 0 and collective bytes > 0, as the
    reference's ``tests/test_dryrun_mesh.py`` asserts of its lowering;
  * a cell's argument bytes equal the sum of the reference's per-leaf
    shard bytes for the same cell (its subprocess: 8 host devices);
  * ``model_flops_for_cell`` and ``applicability``/``cells`` equal the
    reference's for all 40 (arch, shape) pairs, exactly;
  * the traced FLOPs a device at most 1.03x the reference's compiled
    module's (its subprocess: 8 host devices) on the same mesh, where
    the split over ``model`` and the plain attention route must match
    the reference's: yi-6b ``decode_32k`` on (4, 2) (a head-sharded
    cache), phi3-mini-3.8b ``prefill_32k`` on (2, 4), h2o-danube-1.8b
    ``prefill_32k`` on (8, 1) (banded sliding-window attention),
    whisper-medium ``prefill_32k`` on (4, 2) (enc-dec on a mesh) and
    h2o-danube-1.8b ``long_500k`` on (8, 1) (one sequence: the data
    axis splits the dense contractions); and where ``model`` does not
    divide the heads (``sharding.attn_layout``): yi-6b ``prefill_32k``
    and ``decode_32k`` on (1, 8) (query heads split with their kv group;
    a cache split by slots), mamba2-130m ``decode_32k`` on (2, 4) (the
    SSM decode split on its state's head dim), hymba-1.5b
    ``decode_32k`` on (2, 4), ``long_500k`` on (4, 2) and
    ``prefill_32k`` on (2, 4) (attention on the sequence split, the
    slot-split ring cache, the head on split tokens);
    hymba-1.5b ``prefill_32k`` traces on (4, 2) (its SSM's sequence
    split, which attention now takes too).
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro_torch import configs, hlo_analysis  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _placed(tree, mesh, specs):
    return elastic.place(tree, mesh, specs)


def test_plain_product_flops_are_exact_per_device():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = dryrun.fake_mesh((4, 2), ("data", "model"))
    m, n, k = 256, 128, 64
    with FakeTensorMode():
        a = distribute_tensor(torch.randn(m, k), mesh, (Shard(0), Replicate()),
                              src_data_rank=None)
        b = distribute_tensor(torch.randn(k, n), mesh, (Replicate(), Shard(1)),
                              src_data_rank=None)
        trace = hlo_analysis.DispatchTrace()
        with trace:
            a @ b
    ana = hlo_analysis.analyze(trace)
    assert ana["flops"] == 2 * m * n * k / 8
    assert sum(ana["collective_bytes"].values()) == 0


def _train_trace(mesh, full: bool):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import steps
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    cfg = configs.get("yi-6b").reduced()
    model = build(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = model.init(torch.Generator().manual_seed(0))
        params = _placed(params, mesh, sharding.params_specs(params, mesh))
        batch = {k: torch.zeros((2, 8, 32), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        batch = _placed(batch, mesh, sharding.batch_specs(
            batch, mesh, accum_dim=True))
        trace = hlo_analysis.DispatchTrace()
        with dispatch.use_backend("ref"), sharding.mesh_context(mesh), trace:
            if full:
                steps.value_and_grad(model, params, batch, 2)
            else:            # the loop's body once, counted twice
                gacc = steps.grad_accumulator(params)
                with trace.repeat(2):
                    loss = steps.accumulate(
                        model, params, {k: v[0] for k, v in batch.items()},
                        gacc)
                sum([loss]) / 2
                for t in leaves(gacc):
                    t.div_(2)
    return hlo_analysis.analyze(trace)


def test_loop_multiplier_equals_a_full_trace():
    mesh = dryrun.fake_mesh((4, 2), ("data", "model"))
    full, once = _train_trace(mesh, True), _train_trace(mesh, False)
    assert full["flops"] > 0 and full["flops"] == once["flops"]
    assert sum(full["collective_bytes"].values()) > 0
    assert full["collective_bytes"] == once["collective_bytes"]
    assert full["collective_counts"] == once["collective_counts"]


def test_one_device_cell_has_no_collectives():
    rec = dryrun.run_cell("mamba2-130m", "decode_32k", verbose=False,
                          mesh=dryrun.fake_mesh((1, 1), ("data", "model")))
    assert rec["status"] == "OK" and rec["mesh"] == "1x1"
    assert rec["hlo_flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] == 0


@pytest.fixture(scope="module")
def mamba_4x2():
    return dryrun.run_cell("mamba2-130m", "decode_32k", verbose=False,
                           mesh=dryrun.fake_mesh((4, 2), ("data", "model")))


def test_sharded_decode_cell_communicates(mamba_4x2):
    rec = mamba_4x2
    assert rec["status"] == "OK"
    assert rec["hlo_flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0
    mem = rec["bytes_per_device"]
    assert mem["total_live"] == (mem["arguments"] + mem["outputs"]
                                 + mem["temps"] - mem["aliased"]) > 0
    assert set(rec["roofline"]) >= {"t_compute", "t_memory",
                                    "t_collective", "bottleneck",
                                    "useful_flops_ratio",
                                    "roofline_fraction"}


def test_multipod_axes_shard_a_hybrid_decode():
    rec = dryrun.run_cell(
        "hymba-1.5b", "decode_32k", verbose=False,
        mesh=dryrun.fake_mesh((2, 2, 2), ("pod", "data", "model")))
    assert rec["status"] == "OK" and rec["mesh"] == "2x2x2"
    assert rec["hlo_flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0


def test_argument_bytes_equal_the_reference(mamba_4x2):
    """Decode arguments: params, tokens and cache (``pos``, a 0-dim int32
    in the reference, is a Python int in the port and left out)."""
    code = textwrap.dedent(r"""
        import json
        import jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro import configs
        from repro.distributed import sharding
        from repro.launch import cells
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((4, 2), ("data", "model"), devices=jax.devices()[:8])
        cfg = configs.get("mamba2-130m")
        ins = cells.input_specs("mamba2-130m", "decode_32k", mesh, cfg)
        fsdp, _ = sharding.axis_names(mesh)
        trees = [(ins["params"], sharding.params_specs(ins["params"], mesh)),
                 (ins["cache"], sharding.cache_specs(ins["cache"], cfg, mesh)),
                 (ins["tokens"], P(fsdp))]
        total = 0
        for tree, specs in trees:
            specs = sharding.sanitize_specs(tree, specs, mesh)
            leaves = jax.tree_util.tree_leaves(tree)
            sl = jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(x, P))
            for leaf, spec in zip(leaves, sl):
                if leaf.ndim == 0:
                    continue
                shard = NamedSharding(mesh, spec).shard_shape(leaf.shape)
                total += int(np.prod(shard)) * leaf.dtype.itemsize
        print(json.dumps({"arguments": total}))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])["arguments"]
    assert mamba_4x2["bytes_per_device"]["arguments"] == want


def test_model_flops_and_applicability_equal_the_reference():
    archs = configs.list_archs()
    assert archs == jconfigs.list_archs()
    assert shapes.cells(archs) == jshapes.cells(archs)
    assert len(shapes.cells(archs)) == 40
    for arch in archs:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        for name in shapes.SHAPES:
            assert shapes.applicability(cfg, name) == \
                jshapes.applicability(jcfg, name)
            for n in (1, 256, 512):
                port = cells.model_flops_for_cell(types.SimpleNamespace(
                    cfg=cfg, spec=shapes.SHAPES[name]), n)
                ref = jcells.model_flops_for_cell(types.SimpleNamespace(
                    cfg=jcfg, spec=jshapes.SHAPES[name]), n)
                assert port == ref, (arch, name, n)


def test_dryrun_cli_records_skips_and_cells(tmp_path):
    out = tmp_path / "r.jsonl"
    dryrun.main(["--arch", "yi-6b", "--shape", "long_500k",
                 "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "SKIP" and "500k" in rec["reason"]
    assert rec["mesh"] == "16x16"


#: (arch, shape, mesh) cells whose FLOPs a device must match the
#: reference's within FLOPS_RTOL
PARITY_CELLS = [("yi-6b", "decode_32k", (4, 2)),
                ("phi3-mini-3.8b", "prefill_32k", (2, 4)),
                ("h2o-danube-1.8b", "prefill_32k", (8, 1)),
                ("whisper-medium", "prefill_32k", (4, 2)),
                ("h2o-danube-1.8b", "long_500k", (8, 1)),
                ("yi-6b", "prefill_32k", (1, 8)),
                ("yi-6b", "decode_32k", (1, 8)),
                ("mamba2-130m", "decode_32k", (2, 4)),
                ("hymba-1.5b", "decode_32k", (2, 4)),
                ("hymba-1.5b", "long_500k", (4, 2)),
                ("hymba-1.5b", "prefill_32k", (2, 4))]
FLOPS_RTOL = 1.03


@pytest.fixture(scope="module")
def reference_flops():
    """The reference's FLOPs a device of each parity cell: its compiled
    module's ``hlo_analysis`` on 8 host devices, in a subprocess."""
    code = textwrap.dedent(r"""
        import json, sys
        import jax
        from repro import hlo_analysis
        from repro.launch import cells
        from repro.launch.mesh import make_mesh
        out = {}
        for arch, shape, dims in json.loads(sys.argv[1]):
            mesh = make_mesh(tuple(dims), ("data", "model"),
                             devices=jax.devices()[:8])
            cell = cells.build_cell(arch, shape, mesh)
            out[f"{arch} {shape}"] = hlo_analysis.analyze(
                cell.lowered.compile().as_text())["flops"]
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code,
                          json.dumps(PARITY_CELLS)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape,dims", PARITY_CELLS)
def test_flops_per_device_match_the_reference(reference_flops, arch, shape,
                                              dims):
    rec = dryrun.run_cell(arch, shape, verbose=False,
                          mesh=dryrun.fake_mesh(dims, ("data", "model")))
    assert rec["status"] == "OK"
    want = reference_flops[f"{arch} {shape}"]
    assert want > 0
    assert rec["hlo_flops_per_device"] <= FLOPS_RTOL * want, \
        rec["hlo_flops_per_device"] / want


def test_hybrid_prefill_traces_with_the_sequence_split():
    rec = dryrun.run_cell("hymba-1.5b", "prefill_32k", verbose=False,
                          mesh=dryrun.fake_mesh((4, 2), ("data", "model")))
    assert rec["status"] == "OK"
    assert rec["hlo_flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0

"""The port's distributed paths on the CPU, against its one-device paths.

Sharded runs use ``gloo`` ranks spawned by ``tests/torch_dist.py`` (a
``FileStore`` under the test's directory, a 60 s group timeout, every
rank joined within a deadline): one group of 4 ranks and one of 2, each
running every scenario it serves once for the whole module.  In each case
the port's one-device result is the oracle, within ``RTOL`` = 1e-4 of
the largest magnitude (the reduced configs are float32), as
``tests/test_torch_train.py``; the geometry flush is bitwise.

  * a train step of reduced hymba-1.5b and granite-moe-3b-a800m on a
    (2, 2) mesh: loss, global gradient norm, updated parameters (the
    one-device oracle accumulates the same per-shard micro-batches, so
    the MoE's load-balance term -- averaged over the data shards, as the
    reference's ``pmean`` -- is the same function);
  * the MoE mesh path on (1, 2): y, aux, the gradients, the counter;
  * a decode against a sequence-sharded cache (reduced yi-6b's 2 kv heads
    on a 4-wide ``model`` axis);
  * the reference's elastic drill: 6 steps on 4 ranks with checkpoints,
    resumed on 2 ranks to step 10 (global batch 8), its losses also
    within 1e-4 of 10 uninterrupted steps on 2 ranks;
  * a 2-rank mesh flush of a seeded mixed workload, bitwise equal to one
    process;
  * on one rank, with the model kernels routed as on the card (their
    plain versions standing in, ``kernels.grad`` under autograd), a mesh
    train step bit for bit equal to the one-device step -- phase 8g of
    ``chip_smoke.py`` at a reduced size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch import configs, serving  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import workload  # noqa: E402

RTOL = torch_dist.RTOL


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        np.all(np.abs(a - b) <= rtol * max(np.abs(b).max(), 1e-30)))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic"))


@pytest.fixture(scope="module")
def four(tmp_path_factory, ckpt_dir):
    return torch_dist.spawn("four_ranks", 4, tmp_path_factory.mktemp("g4"),
                            ckpt_dir, deadline=400)


@pytest.fixture(scope="module")
def two(tmp_path_factory, ckpt_dir, four):
    return torch_dist.spawn("two_ranks", 2, tmp_path_factory.mktemp("g2"),
                            ckpt_dir, deadline=300)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-moe-3b-a800m"])
def test_sharded_train_step_matches_one_device(four, arch):
    key = "hymba" if arch.startswith("hymba") else "granite"
    losses, norms, params = four[key]
    # the oracle: the same per-shard micro-batches (2 rows) on one device
    want_l, want_n, want_p = torch_dist.train_one(arch, 1)
    assert _close(losses, want_l) and _close(norms, want_n)
    assert len(params) == len(want_p)
    for a, b in zip(params, want_p):
        assert _close(a, b), float(np.abs(a - b).max())


def test_moe_mesh_path_matches_one_device(two):
    y, aux, calls, y_dt, grads = two["moe"]
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    g = torch.Generator().manual_seed(0)
    params = moe.init(g, cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    want_y, want_aux = moe.moe_ffn(params, x, cfg)
    assert calls == 2
    assert _close(y, want_y.numpy()) and _close(y_dt, want_y.numpy())
    assert abs(aux - float(want_aux)) <= RTOL * abs(float(want_aux))
    ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    xs = x.detach().requires_grad_(True)
    y2, aux2 = moe.moe_ffn(ps, xs, cfg)
    ((y2 * y2).sum() + aux2).backward()
    for k, v in ps.items():
        assert _close(grads[k], v.grad.numpy()), k
    assert _close(grads["x"], xs.grad.numpy())


def test_decode_against_a_sequence_sharded_cache(four):
    logits, where = four["decode"]
    assert "Shard(dim=2)" in where     # the cache length over "model"
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import build
    cfg = configs.get("yi-6b").reduced()
    assert cfg.n_kv_heads % 4
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    batch, pos, enc_len = serve_inputs(cfg, tokens)
    cache = model.init_cache(2, 16, enc_len, device="cpu")
    with torch.no_grad():
        lg, cache = model.prefill(params, batch, cache)
        want = [lg.numpy()]
        for i in range(4):
            tok = torch.from_numpy(want[-1].argmax(-1))
            lg, cache = model.decode(params, tok, pos + i, cache)
            want.append(lg.numpy())
    assert len(logits) == len(want) == 5
    for a, b in zip(logits, want):
        assert _close(a, b)


def test_elastic_shrink_and_resume(four, two):
    h1, h2, straight = four["drill"], two["resumed"], two["straight"]
    assert len(h1) == 6
    assert len(h2) == 4                    # steps 6..9
    # the resumed first step continues the trajectory, not the init
    assert h2[0] < h1[0] - 0.2
    # and equals the uninterrupted 2-rank run's steps 6..9
    assert _close(h2, straight[6:])
    assert elastic.replan_accum(8, 1, data_width=4) == 2
    assert elastic.replan_accum(8, 1, data_width=2) == 4


def test_geometry_mesh_flush_is_bitwise(two):
    got = two["flush"]
    srv = serving.GeometryServer(device="cpu")
    for chain, pts in workload.random_workload(seed=3, n_requests=48):
        srv.submit(chain, pts)
    want = torch_dist.flush_arrays(srv.flush())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# -- one rank, the kernels routed as on the card ------------------------------

@pytest.fixture
def world_of_one():
    import datetime

    import torch.distributed as dist
    if dist.is_initialized():      # a fake world left by another file
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """Route every op as on the card with each model kernel's wrapper
    replaced by its plain version (``tests/test_torch_train.py``'s
    fixture), so the ops take their kernel branch and ``kernels.grad``."""
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.affine import affine as affine_k
    from repro_torch.kernels.affine import ref as affine_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms_k
    from repro_torch.kernels.rope import ref as rope_ref
    from repro_torch.kernels.rope import rope as rope_k
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd import ssd as ssd_k
    launches = {}

    def counted(name, fn):
        def run(*a, **kw):
            _build.check_no_grad(*[x for x in a
                                   if isinstance(x, torch.Tensor)])
            launches[name] = launches.get(name, 0) + 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(dispatch, "backend_for",
                        lambda device, backend=None:
                        backend or dispatch._BACKEND or "cuda")
    monkeypatch.setattr(affine_k, "vecadd_2d",
                        counted("vecadd_2d", affine_ref.vecadd))
    monkeypatch.setattr(rms_k, "rmsnorm_2d", counted(
        "rmsnorm_2d", lambda x, g, eps, row_warps: rms_ref.rmsnorm(x, g,
                                                                   eps)))
    monkeypatch.setattr(rope_k, "rope_3d", counted("rope_3d", rope_ref.rope))
    monkeypatch.setattr(fa_k, "flash_attention_3d", counted(
        "flash_attention_3d", fa_ref.flash_attention))
    monkeypatch.setattr(ssd_k, "ssd_intra", counted("ssd_intra",
                                                    ssd_ref.ssd_intra))
    return launches


def _digest_step(mesh, launches):
    import dataclasses

    from repro_torch.kernels import grad
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(),
                              remat="dots")
    got = {}

    def on_step(i, m):
        got["loss"] = m["loss"]
        got["norm"] = float(torch_dist.full(m["grad_norm"]))
        got["params"] = torch_dist.leaf_arrays(m["params"])
        got["opt"] = torch_dist.leaf_arrays(m["opt_state"])
        got["placed"] = m["params"]
    launches.clear()
    grad.reset_backward_counts()
    train_loop(cfg, steps=1, global_batch=4, seq_len=64, micro_per_shard=2,
               opt_cfg=AdamWConfig(total_steps=3, warmup_steps=1),
               device="cpu", mesh=mesh, on_step=on_step, log_every=100)
    got["launches"] = dict(launches)
    got["backwards"] = grad.backward_counts()
    return got


def test_world_of_one_mesh_step_is_bitwise(world_of_one, kernels_as_plain):
    from repro_torch.launch.mesh import make_local_mesh
    want = _digest_step(None, kernels_as_plain)
    mesh = make_local_mesh()
    got = _digest_step(mesh, kernels_as_plain)
    assert got["loss"] == want["loss"] and got["norm"] == want["norm"]
    for key in ("params", "opt"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            assert a.tobytes() == b.tobytes()
    assert got["launches"] == want["launches"] != {}
    assert got["backwards"] == want["backwards"] != {}
    params = got["placed"]
    specs = sharding.sanitize_specs(
        params, sharding.params_specs(params, mesh), mesh)
    from repro_torch.optim.adamw import leaves
    flat_specs = []
    sharding._map_specs(flat_specs.append, specs)
    for p, s in zip(leaves(params), flat_specs):
        assert sharding.is_dtensor(p)
        assert tuple(p.placements) == sharding.placements(s, mesh)

"""The port's autotune against the JAX package's: the tuning cache (size
classes, keys, nearest-class lookup, bytes on disk), the cost model's
byte / FLOP / launch accounting and the paper cross-checks, the search's
pruning and incumbent discipline, the size grid's resolution, and a
server on a tuned grid -- the same buckets as the reference's, results
bitwise equal to per-request ``apply`` on every plan kind (where the
reference itself fails on diag plans, ROADMAP.md queue 3 item 1).

What is the card's is tested for its own rules: Hopper feasibility
(``matmul_2d``'s shared memory, ``rmsnorm_2d``'s warps a row, a block's
threads), the wrappers refusing a knob no launch takes, the TPU fields
refused at load.  The card's runs of every candidate against the default
config are in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

import repro.autotune as jautotune  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.autotune import cache as jcache  # noqa: E402
from repro.autotune import costmodel as jcost  # noqa: E402
from repro.autotune import search as jsearch  # noqa: E402
from repro.core import transform_chain as jtc  # noqa: E402
from repro.serving import bucketing as jbucketing  # noqa: E402
from repro.serving import workload as jworkload  # noqa: E402
from repro_torch import autotune, serving  # noqa: E402
from repro_torch.autotune import cache as tcache  # noqa: E402
from repro_torch.autotune import costmodel, search  # noqa: E402
from repro_torch.autotune.cache import KernelConfig, TuningCache  # noqa: E402
from repro_torch.core import transform_chain as tc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rms_k  # noqa: E402
from repro_torch.serving import bucketing, engine, workload  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture
def tuning_state():
    """Both packages' autotune state isolated: every test starts disabled
    with no loaded cache and leaves no plan built against its config."""
    for mod, cmod in ((autotune, tcache), (jautotune, jcache)):
        mod.set_enabled(False)
        cmod.set_cache(None)
        cmod.set_cache_path(None)
    yield
    for mod, cmod in ((autotune, tcache), (jautotune, jcache)):
        mod.set_enabled(None)
        cmod.set_cache(None)
        cmod.set_cache_path(None)


def _enable_with(cache: TuningCache) -> None:
    tcache.set_cache(cache)
    autotune.set_enabled(True)


#: the JAX package's deterministic stand-in for the timer
#: (tests/test_autotune.py), copied: a pure function of the candidate's
#: tunable fields
def _fake_measure(cfg) -> float:
    return 1.0 + sum(float(v) for v in cfg.key_fields().values()) / 1e4


def _jreqs(reqs):
    """The port's (chain, points) workload as the JAX package's."""
    return [(jtc.TransformChain(c.dim, c.kinds, c.params), p)
            for c, p in reqs]


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 1000, 1024, 1025,
                               1 << 20, (1 << 20) + 1, 3 << 30])
def test_size_class_and_key_equal_the_reference(n):
    assert tcache.size_class(n) == jcache.size_class(n)
    assert tcache.cache_key("chain_apply", "ref", "float32", n) == \
        jcache.cache_key("chain_apply", "ref", "float32", n)


def test_nearest_class_lookup_equals_the_reference():
    """Every lookup size resolves to the same tuned class in both caches
    (exact hit, nearest class, ties to the smaller class, no cross-talk
    between kernels, backends and dtypes)."""
    port, ref = TuningCache(), jcache.TuningCache()
    for n in (64, 2048, 1 << 16):
        port.put("chain_apply", "ref", "float32", n,
                 KernelConfig("chain_apply", waves=n, source="tuned"))
        ref.put("chain_apply", "ref", "float32", n,
                jcache.KernelConfig("chain_apply", block_rows=n,
                                    source="tuned"))
    for n in (0, 1, 33, 64, 65, 500, 2048, 4000, 9000, 1 << 14, 1 << 16,
              1 << 24):
        got, want = port.get("chain_apply", "ref", "float32", n), \
            ref.get("chain_apply", "ref", "float32", n)
        assert got.waves == want.block_rows, n
    for args in (("chain_apply", "cuda", "float32"),
                 ("chain_apply", "ref", "float64"),
                 ("chain_diag", "ref", "float32")):
        assert port.get(*args, 2048) is None
        assert ref.get(*args, 2048) is None


def test_grid_only_cache_serialises_to_the_same_bytes(tmp_path):
    port, ref = TuningCache(), jcache.TuningCache()
    for n, (m, c) in ((34, (64, 0.25)), (97, (16, 0.5)), (0, (4, 0.125))):
        port.put("serving_grid", "ref", "float32", n,
                 KernelConfig("serving_grid", grid_min_len=m,
                              grid_waste_cap=c, source="tuned"))
        ref.put("serving_grid", "ref", "float32", n,
                jcache.KernelConfig("serving_grid", grid_min_len=m,
                                    grid_waste_cap=c, source="tuned"))
    assert port.to_json() == ref.to_json()
    path = str(tmp_path / "grid.json")
    ref.save(path)
    loaded = TuningCache.load(path)
    assert loaded.to_json() == ref.to_json()
    assert loaded.get("serving_grid", "ref", "float32", 97).source == \
        "cached"


def test_cache_roundtrip_of_the_hopper_knobs(tmp_path):
    cache = TuningCache()
    cfgs = {"chain_apply": KernelConfig("chain_apply", block_threads=128,
                                        waves=2, source="tuned"),
            "matmul": KernelConfig("matmul", bn=64, stages=6,
                                   source="tuned"),
            "rmsnorm": KernelConfig("rmsnorm", row_warps=4, source="tuned")}
    for i, (kernel, cfg) in enumerate(cfgs.items()):
        cache.put(kernel, "cuda", "float32", 1 << (10 + i), cfg)
    path = str(tmp_path / "winners.json")
    cache.save(path)
    loaded = TuningCache.load(path)
    for i, (kernel, cfg) in enumerate(cfgs.items()):
        got = loaded.get(kernel, "cuda", "float32", 1 << (10 + i))
        assert got.key_fields() == cfg.key_fields()
        assert got.source == "cached"
    assert loaded.to_json() == cache.to_json()


@pytest.mark.parametrize("field", ["lane_target", "block_rows", "bm", "bk"])
def test_a_tpu_winners_file_does_not_load(tmp_path, field):
    path = tmp_path / "tpu.json"
    path.write_text(json.dumps({"version": 1, "entries": {
        "chain_diag|ref|float32|p11": {field: 256}}}))
    with pytest.raises(ValueError, match=field):
        TuningCache.load(str(path))


def test_the_jax_packages_committed_winners_do_not_load():
    with pytest.raises(ValueError, match="lane_target"):
        TuningCache.load(jcache.DEFAULT_CACHE_PATH)


def test_defaults_are_the_launches_of_before(tuning_state):
    """Tuning disabled gives the kernels' own launches: 256 threads a
    scalar block, 4 stages; every heuristic (grid caps, BN, warps a row)
    left to the kernel; the reference's grid defaults."""
    assert set(tcache.DEFAULTS) == set(jcache.DEFAULTS)
    for kernel in search._SINGLE + search._BATCH:
        assert tcache.DEFAULTS[kernel].key_fields() == {"block_threads": 256}
    assert tcache.DEFAULTS["matmul"].key_fields() == {"stages": 4}
    assert tcache.DEFAULTS["rmsnorm"].key_fields() == {}
    assert tcache.DEFAULTS["serving_grid"].key_fields() == \
        jcache.DEFAULTS["serving_grid"].key_fields()
    cache = TuningCache()
    cache.put("chain_apply", "ref", "float32", 0,
              KernelConfig("chain_apply", waves=8, source="tuned"))
    tcache.set_cache(cache)
    assert tcache.config_for("chain_apply", "ref") is \
        tcache.DEFAULTS["chain_apply"]
    autotune.set_enabled(True)
    assert tcache.config_for("chain_apply", "ref").waves == 8


def test_env_switches_are_the_ports_own(tuning_state, monkeypatch):
    """The JAX package's switch does not enable the port's cache, nor the
    port's the JAX package's."""
    tcache.set_enabled(None)
    jcache.set_enabled(None)
    assert tcache.ENV_ENABLE != jcache.ENV_ENABLE
    assert tcache.ENV_CACHE != jcache.ENV_CACHE
    monkeypatch.setenv(jcache.ENV_ENABLE, "1")
    assert jcache.enabled() and not tcache.enabled()
    monkeypatch.delenv(jcache.ENV_ENABLE)
    monkeypatch.setenv(tcache.ENV_ENABLE, "1")
    assert tcache.enabled() and not jcache.enabled()


# ---------------------------------------------------------------------------
# the cost model: the reference's accounting, the card's scoring
# ---------------------------------------------------------------------------

_KINDS = ("diag", "matrix", "projective")


@pytest.mark.parametrize("kind,q", [(k, q) for k in _KINDS
                                    for q in (None, "q8.7")
                                    if not (k == "projective" and q)])
@pytest.mark.parametrize("d", [2, 3])
def test_predict_launch_equals_the_reference(kind, q, d):
    """Every plan kind (projective plans have no q lane) x q x d."""
    for bsz in (1, 3, 48, 1100):
        for lpad in (4, 8, 13, 1024, 32768):
            got = costmodel.predict_launch(kind, bsz, lpad, d, qformat=q)
            want = jcost.predict_launch(kind, bsz, lpad, d, qformat=q)
            assert (got.kernel, got.hbm_bytes, got.flops, got.m1_cycles) \
                == (want.kernel, want.hbm_bytes, want.flops,
                    want.m1_cycles), (bsz, lpad)


@pytest.mark.parametrize("kind", ["diag", "matrix", "projective", "diag_q",
                                  "matrix_q"])
def test_chain_costs_bytes_and_flops_equal_the_reference(kind):
    for d in (2, 3):
        assert costmodel.chain_param_bytes(d, kind) == \
            jcost.chain_param_bytes(d, kind)
        assert costmodel._chain_flops_per_point(d, kind) == \
            jcost._chain_flops_per_point(d, kind)
        for n in (1, 700, 2048, 1 << 20):
            got, want = costmodel.chain_cost(n, d, kind), \
                jcost.chain_cost(n, d, kind)
            assert (got.kernel, got.hbm_bytes, got.flops, got.launches) == \
                (want.kernel, want.hbm_bytes, want.flops, want.launches)
        for bsz, lpad in ((1, 8), (8, 64), (47, 32768)):
            got, want = costmodel.packed_chain_cost(bsz, lpad, d, kind), \
                jcost.packed_chain_cost(bsz, lpad, d, kind)
            assert (got.kernel, got.hbm_bytes, got.flops, got.launches) == \
                (want.kernel, want.hbm_bytes, want.flops, want.launches)


def test_grid_cost_launches_and_bytes_equal_the_reference():
    reqs = workload.random_workload(seed=33, n_requests=40, max_points=300)
    jreqs = jworkload.random_workload(seed=33, n_requests=40, max_points=300)
    shape, jshape = costmodel.workload_shape(reqs), \
        jcost.workload_shape(jreqs)
    assert [s[1:] for s in shape] == [s[1:] for s in jshape]
    for min_len, cap in ((4, 0.125), (8, 0.5), (32, 0.25), (64, 0.125)):
        got = costmodel.grid_cost(shape, min_len, cap)
        want = jcost.grid_cost(jshape, min_len, cap)
        assert (got.launches, got.hbm_bytes, got.flops) == \
            (want.launches, want.hbm_bytes, want.flops)


def test_grid_cost_replays_the_servers_bucketing(tuning_state):
    """The model's launch count equals the port's server's schedule."""
    reqs = workload.random_workload(seed=33, n_requests=40, max_points=300)
    for min_len, cap in ((8, 0.5), (32, 0.25), (64, 0.125)):
        est = costmodel.grid_cost(costmodel.workload_shape(reqs),
                                  min_len, cap)
        srv = serving.GeometryServer(device="cpu", min_len=min_len,
                                     waste_cap=cap)
        serving.reset_stats()
        srv.serve(reqs)
        assert est.launches == serving.stats["launches"], (min_len, cap)


def test_paper_cross_checks_equal_the_reference():
    for routine in ("translation", "scaling"):
        for n in (8, 16, 64, 128):
            assert costmodel.morphosys_cycles(routine, n) == \
                jcost.morphosys_cycles(routine, n)
    assert costmodel.morphosys_cycles("translation", 64) == 96
    assert costmodel.morphosys_cycles("scaling", 64) == 55
    for kind in ("diag", "matrix", "projective", "diag_q", "matrix_q"):
        for n, d in ((1, 2), (45, 3), (1000, 2), (1 << 20, 3)):
            assert costmodel.m1_chain_cycles(kind, n, d) == \
                jcost.m1_chain_cycles(kind, n, d)
    assert costmodel.perf_rows() == [
        type(costmodel.perf_rows()[0])(**r.__dict__)
        for r in jcost.perf_rows()]
    with pytest.raises(ValueError):
        costmodel.morphosys_cycles("translation", 12)


def test_hopper_feasibility():
    """The card's limits decide which candidates survive: matmul_2d's
    ring in 232 448 bytes of shared memory, rmsnorm_2d's warps holding
    the row, a chain kernel's block a multiple of 32 up to 1024."""
    assert costmodel.matmul_smem(128, 4) == 4 * (16384 + 16384) + 1024
    for bn in (64, 128):
        for stages in (3, 4, 6):
            cfg = KernelConfig("matmul", bn=bn, stages=stages)
            assert costmodel.matmul_cost(1024, 1024, 1024, cfg).feasible
    assert not costmodel.matmul_cost(
        1024, 1024, 1024, KernelConfig("matmul", bn=128, stages=8)).feasible
    assert not costmodel.matmul_cost(
        1024, 1024, 1024, KernelConfig("matmul", bn=256)).feasible
    # bf16 rows of 1600 are 200 vectors: one warp holds them (8 a lane)
    for w in (1, 2, 4, 8, 16, 32):
        assert costmodel.rmsnorm_cost(
            8192, 1600, KernelConfig("rmsnorm", row_warps=w),
            itemsize=2).feasible
    # float32 rows of 32768 are 8192 vectors: only 32 warps hold them
    feasible = [w for w in (1, 2, 4, 8, 16, 32) if costmodel.rmsnorm_cost(
        4, 32768, KernelConfig("rmsnorm", row_warps=w)).feasible]
    assert feasible == [32]
    assert not costmodel.rmsnorm_cost(
        4, 1600, KernelConfig("rmsnorm", row_warps=3)).feasible
    for bt, ok in ((128, True), (1024, True), (1056, False), (100, False)):
        assert costmodel.chain_cost(
            2048, 2, "diag",
            KernelConfig("chain_diag", block_threads=bt)).feasible is ok
    # the kernel's own choices, mirrored
    assert costmodel.matmul_bn(1024, 1024) == 64
    assert costmodel.matmul_bn(4096, 4096) == 128
    assert costmodel.rmsnorm_warps(8192, 200) == 1
    assert costmodel.rmsnorm_warps(4, 200) == 8


def test_wave_tail_and_launch_costs():
    """The card's scoring: a grid of whole waves pays no tail; a serving
    bucket costs the mixed flush's share, a kernel the launch floor."""
    est = costmodel.chain_cost(1 << 24, 2, "diag",
                               KernelConfig("chain_diag", waves=4))
    assert est.waves == 4 and est.tail_us == 0.0
    default = costmodel.chain_cost(1 << 24, 2, "diag")
    assert default.tail_us > 0.0          # 4096 blocks: 3.88 waves
    assert est.predicted_us == pytest.approx(
        costmodel.LAUNCH_OVERHEAD_US + est.hbm_bytes / 3.35e12 * 1e6)
    grid = costmodel.grid_cost([(0, "diag", 2, 100)], 8, 0.5)
    assert grid.predicted_us == pytest.approx(
        costmodel.GRID_LAUNCH_US + grid.hbm_bytes / 3.35e12 * 1e6)
    assert costmodel.GRID_LAUNCH_US == pytest.approx(1348.2, abs=0.1)
    mm = costmodel.matmul_cost(4096, 4096, 4096)
    assert mm.stream_us == pytest.approx(2 * 4096 ** 3 / 989e12 * 1e6)


@pytest.mark.parametrize("kind,lpad,d,vec", [
    ("diag", 8, 2, True), ("diag", 13, 3, False), ("matrix", 6, 2, True),
    ("matrix", 6, 3, False), ("projective", 12, 3, True),
    ("projective", 6, 2, False), ("diag_q", 12, 2, True),
    ("matrix_q", 12, 3, False)])
def test_batch_takes_vectors_mirrors_the_c_entries(kind, lpad, d, vec):
    assert costmodel.batch_takes_vectors(kind, lpad, d) is vec


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def test_candidate_spaces():
    assert [(c.block_threads, c.waves)
            for c in search.chain_candidates("chain_diag")] == \
        [(bt, w) for bt in (128, 256, 512) for w in (1, 2, 4)]
    assert [c.waves for c in search.chain_batch_candidates(
        "chain_apply_batch")] == [1, 2, 4, 8]
    assert len(search.chain_batch_candidates("chain_apply_batch",
                                             vectors=False)) == 9
    assert [(c.bn, c.stages) for c in search.matmul_candidates()] == \
        [(bn, s) for bn in (64, 128) for s in (3, 4, 6)]
    assert [c.row_warps for c in search.rmsnorm_candidates()] == \
        [1, 2, 4, 8, 16, 32]
    assert [c.key_fields() for c in search.grid_candidates()] == \
        [c.key_fields() for c in jsearch.grid_candidates()]
    assert search.NOISE_FLOOR == jsearch.NOISE_FLOOR == 0.03
    for name in ("SMOKE_SEED", "SMOKE_REQUESTS", "SMOKE_MAX_POINTS",
                 "BENCH_SEED", "BENCH_REQUESTS", "BENCH_MAX_POINTS"):
        assert getattr(search, name) == getattr(jsearch, name)
    with pytest.raises(ValueError):
        search.candidates_for("rope")


def test_smoke_workloads_equal_the_references():
    for port_wl, ref_wl in ((search.smoke_workload, jsearch.smoke_workload),
                            (search.bench_workload, jsearch.bench_workload)):
        a, b = port_wl(), ref_wl()
        assert search.workload_size_class_n(a) == \
            jsearch.workload_size_class_n(b)
        assert costmodel.workload_shape(a)[0][1:] == \
            jcost.workload_shape(b)[0][1:]
        for (ca, pa), (cb, pb) in zip(a, b):
            assert ca.kinds == cb.kinds
            np.testing.assert_array_equal(pa, pb)


@pytest.fixture
def reference_costs(monkeypatch):
    """The port's scoring constants set to the reference's, so that only
    the accounting (which the packages share) decides."""
    monkeypatch.setattr(costmodel, "GRID_LAUNCH_US",
                        jcost.LAUNCH_OVERHEAD_US)
    monkeypatch.setattr(costmodel, "LAUNCH_OVERHEAD_US",
                        jcost.LAUNCH_OVERHEAD_US)
    monkeypatch.setattr(costmodel, "STEP_OVERHEAD_US",
                        jcost.STEP_OVERHEAD_US)
    monkeypatch.setattr(costmodel, "MODEL_BW", jcost.MODEL_BW)


def _trials(rep):
    return [(sorted(t.config.key_fields().items()), t.seconds)
            for t in rep.trials]


@pytest.mark.parametrize("wl", ["smoke", "bench"])
@pytest.mark.parametrize("timer", ["fake", "cost model"])
def test_grid_pruning_equals_the_reference(wl, timer, reference_costs,
                                           tuning_state):
    """Under the reference's constants, the port's grid search picks the
    reference's survivors, trials and winner, timed by the reference
    test's fake timer or by the cost model itself."""
    reqs = search.smoke_workload() if wl == "smoke" \
        else search.bench_workload()
    jreqs = _jreqs(reqs)
    if timer == "fake":
        m, jm = _fake_measure, _fake_measure
    else:
        shape, jshape = costmodel.workload_shape(reqs), \
            jcost.workload_shape(jreqs)
        m = lambda c: costmodel.grid_cost(  # noqa: E731
            shape, c.grid_min_len, c.grid_waste_cap).predicted_us / 1e6
        jm = lambda c: jcost.grid_cost(  # noqa: E731
            jshape, c.grid_min_len, c.grid_waste_cap).predicted_us / 1e6
    rep = search.tune_serving_grid(reqs, "ref", device="cpu", measure=m)
    jrep = jsearch.tune_serving_grid(jreqs, "ref", measure=jm)
    assert _trials(rep) == _trials(jrep)
    assert [t.predicted_us for t in rep.trials] == \
        [t.predicted_us for t in jrep.trials]
    assert rep.winner.key_fields() == jrep.winner.key_fields()
    assert rep.winner.source == jrep.winner.source
    assert rep.n == jrep.n


def test_search_deterministic_winners_file(tmp_path, tuning_state):
    """Same inputs (workload seeds, candidate spaces, measure) -> the same
    winners, serialized to byte-identical files."""
    texts = []
    for _ in range(2):
        cache, reports = search.smoke_search(device="cpu",
                                             measure=_fake_measure)
        assert [r.kernel for r in reports] == \
            ["chain_diag", "chain_apply", "chain_project", "chain_diag_q",
             "chain_apply_q", "serving_grid", "serving_grid"]
        texts.append(cache.to_json())
    assert texts[0] == texts[1]
    keys = sorted(json.loads(texts[0])["entries"])
    assert all("|ref|" in k for k in keys)


def test_ref_backend_pins_kernel_winners_to_default(tuning_state):
    """The plain version never reads the launch knobs: the tuners time
    the default alone on ``ref`` unless a measure is injected."""
    rep = search.tune_chain("chain_apply", device="cpu", n_points=256,
                            iters=1)
    assert rep.backend == "ref" and len(rep.trials) == 1
    assert rep.winner.key_fields() == \
        tcache.DEFAULTS["chain_apply"].key_fields()
    for rep in (search.tune_rmsnorm(device="cpu", m=32, n=64, iters=1),
                search.tune_matmul(device="cpu", m=16, k=16, n=16, iters=1),
                search.tune_chain_batch("chain_diag_batch_q", device="cpu",
                                        bsz=3, lpad=16, d=2, dtype="q8.7",
                                        iters=1)):
        assert len(rep.trials) == 1 and rep.winner.source == "default"
    rep = search.tune_chain("chain_apply", device="cpu", n_points=256,
                            measure=_fake_measure)
    assert len(rep.trials) > 1


def test_incumbent_scan_keeps_the_default_within_the_noise_floor():
    """A candidate must beat the default by 3 % to take its seat, and
    then the next one must beat it by 3 % in turn."""
    times = {None: 1.0, 1: 0.98, 2: 0.90, 4: 0.885, 8: 0.80}
    rep = search.tune_chain_batch(
        "chain_apply_batch", device="cpu", bsz=4, lpad=64, d=2, keep=8,
        measure=lambda c: times[c.waves])
    assert rep.winner.waves == 8 and rep.winner.source == "tuned"
    times[8] = 0.89
    rep = search.tune_chain_batch(
        "chain_apply_batch", device="cpu", bsz=4, lpad=64, d=2, keep=8,
        measure=lambda c: times[c.waves])
    assert rep.winner.waves == 2
    rep = search.tune_chain_batch(
        "chain_apply_batch", device="cpu", bsz=4, lpad=64, d=2, keep=8,
        measure=lambda c: 1.0)
    assert rep.winner.source == "default" and rep.winner.waves is None
    assert rep.default_seconds == rep.winner_seconds == 1.0


def test_tuners_cache_under_the_engines_size_classes(tuning_state):
    cache = TuningCache()
    search.tune_chain_batch("chain_project_batch", device="cpu", bsz=20,
                            lpad=65536, d=3, cache=cache,
                            measure=_fake_measure)
    search.tune_matmul(device="cpu", m=1024, k=1024, n=1024, cache=cache,
                       measure=_fake_measure)
    search.tune_rmsnorm(device="cpu", m=8192, n=1600, dtype="bfloat16",
                        cache=cache, measure=_fake_measure)
    assert sorted(cache.entries) == [
        "chain_project_batch|ref|float32|p21", "matmul|ref|bfloat16|p20",
        "rmsnorm|ref|bfloat16|p24"]


def test_the_timer_runs_on_the_device_it_is_given(tuning_state):
    """Without an injected measure the tuners time the public op entry on
    the device they are given; the default device is the GPU, which a
    machine without one refuses."""
    rep = search.tune_serving_grid(search.smoke_workload(), device="cpu",
                                   iters=1)
    assert rep.backend == "ref" and len(rep.trials) == 5
    assert all(t.seconds > 0 for t in rep.trials)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            search.tune_chain("chain_diag", n_points=64)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            search.tune_serving_grid(search.smoke_workload())


# ---------------------------------------------------------------------------
# the wrappers' knobs (checked before any launch)
# ---------------------------------------------------------------------------

def test_chain_knobs_refuse_what_no_launch_takes():
    assert _build.chain_knobs() == (0, 0)
    assert _build.chain_knobs(256, None) == (256, 0)
    assert _build.chain_knobs(512, 4) == (512, 4)
    for bt, w in ((100, None), (2048, None), (16, None), (None, -1),
                  (None, 2000)):
        with pytest.raises(ValueError):
            _build.chain_knobs(bt, w)


def test_rmsnorm_row_warps_feasibility():
    assert rms_k.row_warps_ok(1, 200)          # 1600 bfloat16 values
    assert not rms_k.row_warps_ok(1, 800)      # 3200 float32 values
    assert rms_k.row_warps_ok(4, 800)
    assert not rms_k.row_warps_ok(3, 16)
    assert not rms_k.row_warps_ok(64, 16)


def test_ops_take_config_and_the_plain_version_ignores_it():
    """Every op that takes ``config`` in the JAX package takes it here;
    on the CPU (the plain version) any config gives the default's
    bits."""
    from repro_torch import kernels
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 2), dtype=np.float32))
    x3 = x.reshape(4, 16, 2)
    q = torch.from_numpy(rng.integers(-999, 999, (64, 2)).astype(np.int16))
    cfg = KernelConfig("x", block_threads=128, waves=2)
    s, t = torch.tensor([1.5, 0.5]), torch.tensor([0.25, -1.0])
    a = torch.tensor([[0.5, 1.0], [-1.0, 0.25]])
    h = torch.eye(3)
    qs, qt = s.mul(128).to(torch.int16), t.mul(128).to(torch.int16)
    qa = a.mul(128).to(torch.int16)
    calls = [
        lambda c: kernels.chain_diag(x, s, t, config=c),
        lambda c: kernels.chain_diag_batch(x3, s, t, config=c),
        lambda c: kernels.chain_apply(x, a, t, config=c),
        lambda c: kernels.chain_apply_batch(x3, a, t, config=c),
        lambda c: kernels.chain_project(x, h, config=c)[0],
        lambda c: kernels.chain_project_batch(x3, h, config=c)[0],
        lambda c: kernels.chain_diag_q(q, qs, qt, n_frac=7, config=c),
        lambda c: kernels.chain_apply_q(q, qa, qt, n_frac=7, config=c),
        lambda c: kernels.chain_diag_batch_q(q.reshape(4, 16, 2), qs, qt,
                                             n_frac=7, config=c),
        lambda c: kernels.chain_apply_batch_q(q.reshape(4, 16, 2), qa, qt,
                                              n_frac=7, config=c),
    ]
    for call in calls:
        assert torch.equal(call(cfg), call(None))
    g = torch.ones(2)
    assert torch.equal(kernels.rmsnorm(x, g, config=KernelConfig(
        "rmsnorm", row_warps=4)), kernels.rmsnorm(x, g))
    assert torch.equal(kernels.matmul(x, a, bn=64, stages=3),
                       kernels.matmul(x, a, config=KernelConfig(
                           "matmul", bn=128, stages=6)))


# ---------------------------------------------------------------------------
# integration: the size grid and the server
# ---------------------------------------------------------------------------

def test_grid_for_resolution_order_equals_the_reference(tuning_state):
    for mod, cmod, bmod in ((autotune, tcache, bucketing),
                            (jautotune, jcache, jbucketing)):
        cache = cmod.TuningCache()
        cache.put("serving_grid", "ref", "float32", 0,
                  cmod.KernelConfig("serving_grid", grid_min_len=64,
                                    grid_waste_cap=0.125, source="tuned"))
        cmod.set_cache(cache)
    cases = (dict(min_len=4, waste_cap=0.5), {}, dict(min_len=16),
             dict(waste_cap=0.25), dict(n=5000))
    for on in (True, False):
        autotune.set_enabled(on)
        jautotune.set_enabled(on)
        for kw in cases:
            assert bucketing.grid_for("ref", **kw) == \
                jbucketing.grid_for("ref", **kw), (on, kw)
    autotune.set_enabled(True)
    assert bucketing.grid_for("ref", min_len=16) == \
        (16, 0.125, "explicit+tuned")
    assert bucketing.grid_for("cuda") == \
        (bucketing.MIN_LEN, bucketing.WASTE_CAP, "default")


def _tag(structure) -> str:
    dim, kinds = structure
    return f"{dim}D:" + "".join(k for k, _ in kinds)


def test_tuned_grid_buckets_equal_the_reference_and_stay_bitwise(
        tuning_state):
    """A server on a tuned grid (16, 0.25) forms the reference's buckets
    -- keys, padded lengths, launches, padded points -- and its results
    equal per-request ``apply``/``project`` bit for bit on every plan
    kind (the reference's own diag plans miss this, queue 3 item 1)."""
    reqs = workload.random_workload(seed=21, n_requests=40, max_points=400,
                                    min_points=16)
    for mod, cmod in ((autotune, tcache), (jautotune, jcache)):
        cache = cmod.TuningCache()
        cache.put("serving_grid", "ref", "float32", 0,
                  cmod.KernelConfig("serving_grid", grid_min_len=16,
                                    grid_waste_cap=0.25, source="tuned"))
        cmod.set_cache(cache)
        mod.set_enabled(True)
    srv = serving.GeometryServer(device="cpu")
    assert (srv.min_len, srv.waste_cap) == (16, 0.25)
    assert srv.grid_source == "tuned"
    serving.reset_stats()
    outs = srv.serve(reqs)
    jsrv = jserving.GeometryServer(backend="ref")
    jserving.reset_stats()
    jsrv.serve(_jreqs(reqs))
    mine = [(r.structure, r.kind, r.lpad, r.requests, r.launches,
             r.padded_points) for r in srv.last_report]
    theirs = [(r.structure, r.kind, r.lpad, r.requests, r.launches,
               r.padded_points) for r in jsrv.last_report]
    assert mine == theirs
    assert serving.stats["launches"] == jserving.stats["launches"]
    assert serving.stats["padded_points"] == jserving.stats["padded_points"]
    kinds = set()
    for rep in srv.last_report:
        assert rep.waste < 0.25, rep
    for (chain, pts), out in zip(reqs, outs):
        kinds.add(chain.plan_kind)
        if chain.is_projective:
            q, m = chain.project(torch.from_numpy(pts))
            np.testing.assert_array_equal(out.mask, m.numpy())
        else:
            q = chain.apply(torch.from_numpy(pts))
        assert out.tobytes() == q.numpy().tobytes()
    assert kinds == {"diag", "matrix", "projective"}
    jautotune.set_enabled(False)


def test_set_enabled_moves_a_live_server_and_clears_plan_caches(
        tuning_state):
    cache = TuningCache()
    cache.put("serving_grid", "ref", "float32", 0,
              KernelConfig("serving_grid", grid_min_len=64,
                           grid_waste_cap=0.25, source="tuned"))
    tcache.set_cache(cache)
    srv = serving.GeometryServer(device="cpu")        # built while disabled
    assert (srv.min_len, srv.grid_source) == (bucketing.MIN_LEN, "default")
    reqs = workload.random_workload(seed=4, n_requests=6, max_points=40)
    srv.serve(reqs)
    chain, pts = reqs[0]
    chain.apply(torch.from_numpy(pts))
    assert engine._BATCH_PLANS and tc._PLAN_CACHE
    autotune.set_enabled(True)
    assert not engine._BATCH_PLANS and not tc._PLAN_CACHE
    srv.serve(reqs)
    assert (srv.min_len, srv.waste_cap) == (64, 0.25)
    assert srv.grid_source == "tuned"
    autotune.set_enabled(False)
    srv.serve(reqs)
    assert (srv.min_len, srv.grid_source) == (bucketing.MIN_LEN, "default")
    pinned = serving.GeometryServer(device="cpu", min_len=16, waste_cap=0.5)
    autotune.set_enabled(True)
    pinned.serve(reqs)
    assert (pinned.min_len, pinned.waste_cap, pinned.grid_source) == \
        (16, 0.5, "explicit")


def test_launch_instants_carry_the_tuned_config(tuning_state):
    """With tuning on and a bucket's class in the cache, the ``launch``
    instant names the config's source, as the reference's does."""
    from repro_torch import obs
    reqs = workload.random_workload(seed=4, n_requests=6, max_points=40,
                                    templates=workload.TEMPLATES[1:2])
    cache = TuningCache()
    cache.put("chain_diag_batch", "ref", "float32", 0,
              KernelConfig("chain_diag_batch", waves=2, source="tuned"))
    _enable_with(cache)
    trc = obs.Tracer()
    with obs.installed(trc):
        serving.GeometryServer(device="cpu").serve(reqs)
    launches = [s.attrs for s in trc.spans if s.name == "launch"]
    assert launches and all(a["config"] == "tuned"
                            and a["kernel"] == "chain_diag_batch"
                            for a in launches)


def test_cli_smoke_check_on_the_cpu():
    """``python -m repro_torch.autotune --smoke --check --device cpu``:
    the paper table, the emulator cross-check, the search, and the
    committed (card) winners file's presence and grid launch gate."""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.autotune",
                          "--smoke", "--check", "--device", "cpu",
                          "--iters", "1"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "emulator=96" in res.stdout
    assert "[check] committed default cache: OK" in res.stdout


def test_committed_winners_are_the_cards():
    """The committed winners file holds only ``cuda`` entries: the port's
    card's, not the JAX package's ``ref`` ones."""
    committed = TuningCache.load(tcache.DEFAULT_CACHE_PATH)
    assert len(committed) == 7
    assert all(k.split("|")[1] == "cuda" for k in committed.entries)
    for kernel, dtype, n in (("chain_diag", "float32", 2048),
                             ("chain_apply_q", "q8.7", 2048),
                             ("serving_grid", "float32", 34),
                             ("serving_grid", "float32", 1024)):
        assert committed.get(kernel, "cuda", dtype, n) is not None

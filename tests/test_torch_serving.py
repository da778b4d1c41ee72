"""The port's serving engine against the JAX package's.

Workloads come from the same numpy seeds through both packages'
``random_workload``.  Deterministic counters (launches, buckets, shards,
payload and padded points) must EQUAL the reference's live counters;
served results must be within |port - jax| <= 4 eps32 (sum_m |p_m A_mc|
+ |t_c|) per element of the reference's served results (XLA:CPU contracts
some multiply-adds; the port never does); and within the port, packed
results must equal per-request ``apply`` BITWISE.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import serving as jserving
from repro.serving import bucketing as jbucketing
from repro.serving import workload as jworkload
from repro_torch import errors, serving
from repro_torch.core import transform_chain as tc
from repro_torch.kernels import opcount
from repro_torch.serving import bucketing, workload

EPS32 = float(np.finfo(np.float32).eps)
COUNTERS = ("launches", "buckets", "shards", "payload_points",
            "padded_points", "requests")


def _server(**kw):
    serving.reset_stats()
    serving.clear_plan_cache()
    return serving.GeometryServer(device="cpu", **kw)


def _jax_server(**kw):
    jserving.reset_stats()
    jserving.clear_plan_cache()
    return jserving.GeometryServer(backend="ref", **kw)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _bound(chain, pts):
    p = np.abs(pts.reshape(-1, chain.dim).astype(np.float64))
    folded = [np.abs(f.astype(np.float64)) for f in chain.fold()]
    mag = p * folded[0] if chain.is_diagonal else p @ folded[0]
    return (4 * EPS32 * (mag + folded[1])).reshape(pts.shape)


def _affine_workload(seed=1904, n=64, max_points=1024):
    return (workload.random_workload(seed=seed, n_requests=n,
                                     templates=workload.AFFINE_TEMPLATES,
                                     max_points=max_points),
            jworkload.random_workload(seed=seed, n_requests=n,
                                      templates=jworkload.AFFINE_TEMPLATES,
                                      max_points=max_points))


@pytest.mark.parametrize("affine_only", [True, False])
@pytest.mark.parametrize("seed", [0, 1904])
def test_random_workload_matches_reference(seed, affine_only):
    templates = workload.AFFINE_TEMPLATES if affine_only \
        else workload.TEMPLATES
    assert templates == (jworkload.AFFINE_TEMPLATES if affine_only
                         else jworkload.TEMPLATES)
    port = workload.random_workload(seed=seed, n_requests=40,
                                    templates=templates, max_points=300)
    ref = jworkload.random_workload(seed=seed, n_requests=40,
                                    templates=templates, max_points=300)
    for (pc, pp), (rc, rp) in zip(port, ref, strict=True):
        assert _same_bits(pp, rp)
        assert pc.structure == rc.structure
        assert all(_same_bits(a, b) for a, b in zip(pc.fold(), rc.fold()))


def test_mixed_lane_workload_matches_reference():
    port = workload.mixed_lane_workload(3, 24)
    ref = jworkload.mixed_lane_workload(3, 24)
    for (pc, pp, pq), (rc, rp, rq) in zip(port, ref, strict=True):
        assert pq == rq and pc.structure == rc.structure
        assert _same_bits(pp, rp)


def test_bucketing_matches_reference():
    for cap in (0.1, 0.25, 0.5, 0.9):
        for min_len in (1, 8, 64):
            for n in range(1, 700, 7):
                assert bucketing.padded_length(n, min_len=min_len,
                                               waste_cap=cap) \
                    == jbucketing.padded_length(n, min_len=min_len,
                                                waste_cap=cap)
    assert bucketing.MIN_LEN == jbucketing.MIN_LEN
    assert bucketing.WASTE_CAP == jbucketing.WASTE_CAP
    assert bucketing.waste_fraction(48, 64) == jbucketing.waste_fraction(48, 64)
    assert bucketing.grid_for() == (8, 0.5, "default")
    assert bucketing.grid_for(min_len=16) == (16, 0.5, "explicit+default")
    with pytest.raises(ValueError):
        bucketing.padded_length(5, waste_cap=1.0)


@pytest.mark.parametrize("max_points_per_launch", [None, 256])
def test_counters_equal_reference(max_points_per_launch):
    """Seed 1904, 64 affine requests: the reference's live counters (35
    launches and 3576 padded points without a launch cap)."""
    port_reqs, ref_reqs = _affine_workload()
    srv = _server(max_points_per_launch=max_points_per_launch)
    srv.serve(port_reqs)
    jsrv = _jax_server(max_points_per_launch=max_points_per_launch)
    jsrv.serve(ref_reqs)
    for key in COUNTERS:
        assert serving.stats[key] == jserving.stats[key], key
    assert [(r.structure, r.kind, r.lpad, r.requests, r.launches)
            for r in srv.last_report] == \
        [(r.structure, r.kind, r.lpad, r.requests, r.launches)
         for r in jsrv.last_report]
    if max_points_per_launch is None:
        assert serving.stats["launches"] == 35
        assert serving.stats["padded_points"] == 3576
    else:
        assert serving.stats["shards"] > 0
    assert serving.stats["launches"] == sum(r.launches for r in srv.reports)


def test_served_results_match_reference():
    port_reqs, ref_reqs = _affine_workload(seed=11, n=48, max_points=300)
    outs = _server().serve(port_reqs)
    jouts = _jax_server().serve(ref_reqs)
    for (chain, pts), out, jout in zip(port_reqs, outs, jouts):
        assert isinstance(out, np.ndarray) and out.shape == pts.shape
        assert np.all(np.abs(out.astype(np.float64) - np.asarray(jout))
                      <= _bound(chain, pts))


@pytest.mark.parametrize("seed", [11, 1904])
def test_packed_equals_per_request_apply_bitwise(seed):
    """Diag AND matrix plans: no last-ULP daylight within the port."""
    reqs, _ = _affine_workload(seed=seed, n=48, max_points=300)
    assert {c.plan_kind for c, _ in reqs} == {"diag", "matrix"}
    outs = _server().serve(reqs)
    for (chain, pts), out in zip(reqs, outs):
        assert _same_bits(out, chain.apply(torch.from_numpy(pts)).numpy())


def test_padding_never_contaminates_payload():
    """A request's bits must not depend on WHICH requests share its bucket."""
    rng = np.random.default_rng(9)
    for dim, kinds in ((2, "TSRT"), (3, "SAT")):
        probe = workload.chain_for(rng, dim, kinds)
        pts = rng.standard_normal((50, dim)).astype(np.float32)
        outs = []
        for neighbour_seed in (1, 2):
            nrng = np.random.default_rng(neighbour_seed)
            reqs = [(probe, pts)] + [
                (workload.chain_for(nrng, dim, kinds),
                 (nrng.standard_normal((int(nrng.integers(33, 64)), dim))
                  * 1e30).astype(np.float32))
                for _ in range(5)]
            srv = _server()
            outs.append(srv.serve(reqs)[0])
            assert serving.stats["launches"] == 1
        assert _same_bits(outs[0], outs[1])


def test_identity_passes_through_and_empty_rejects():
    srv = _server()
    pts = np.ones((4, 2), np.float32)
    srv.submit(tc.TransformChain.identity(2), pts)
    with pytest.raises(errors.EmptyPointsError) as ei:
        srv.submit(workload.chain_for(np.random.default_rng(0), 2, "TS"),
                   np.zeros((0, 2), np.float32))
    assert ei.value.ticket == 1 and ei.value.code == "empty"
    (out_id,) = srv.flush()
    assert _same_bits(out_id, pts)
    assert serving.stats["launches"] == 0
    assert serving.stats["rejected_requests"] == 1


def test_submit_validation_and_later_slices():
    srv = _server()
    rng = np.random.default_rng(6)
    chain = workload.chain_for(rng, 2, "TSRT")
    with pytest.raises(errors.DtypeError):
        srv.submit(chain, np.ones((3, 2), np.float64))
    with pytest.raises(errors.DtypeError):
        srv.submit(chain, np.ones((3, 2), np.int16))
    bad = np.ones((3, 2), np.float32)
    bad[1, 0] = np.nan
    with pytest.raises(errors.NonFiniteError) as ei:
        srv.submit(chain, bad)
    assert ei.value.ticket == 2
    with pytest.raises(errors.NonFiniteError):
        srv.submit(tc.TransformChain.identity(2).scale(np.inf), np.ones(
            (3, 2), np.float32))
    with pytest.raises(NotImplementedError, match="graphics slice"):
        srv.submit(workload.chain_for(rng, 3, "MPC"),
                   np.ones((3, 3), np.float32))
    with pytest.raises(NotImplementedError, match="Qm.n"):
        srv.submit(chain, np.ones((3, 2), np.float32), qformat="q8.7")
    assert serving.stats["rejected_requests"] == 4
    assert srv.pending == 0


def test_submitted_points_are_copied_and_shapes_round_trip():
    rng = np.random.default_rng(1)
    chain = workload.chain_for(rng, 3, "TRS")
    pts = rng.standard_normal((4, 13, 3)).astype(np.float32)
    snapshot = pts.copy()
    srv = _server()
    srv.submit(chain, pts)
    srv.submit(chain, torch.from_numpy(pts[0]))
    pts[:] = 0.0
    out, out0 = srv.flush()
    assert out.shape == (4, 13, 3) and out0.shape == (13, 3)
    want = chain.apply(torch.from_numpy(snapshot)).numpy()
    assert _same_bits(out, want)
    assert _same_bits(out0, chain.apply(torch.from_numpy(snapshot[0])).numpy())


def test_oversized_bucket_shards_and_matches():
    rng = np.random.default_rng(41)
    chain_rng = np.random.default_rng(2)
    reqs = [(workload.chain_for(chain_rng, 2, "TSRT"),
             rng.standard_normal((100, 2)).astype(np.float32))
            for _ in range(12)]                   # one bucket, lpad=128
    srv = _server(max_points_per_launch=3 * 128)
    outs = srv.serve(reqs)
    assert serving.stats["buckets"] == 1
    assert serving.stats["launches"] == 4        # 12 reqs / 3 rows per shard
    assert serving.stats["shards"] == 3
    assert srv.last_report[0].launches == 4
    for (chain, pts), out in zip(reqs, outs):
        assert _same_bits(out, chain.apply(torch.from_numpy(pts)).numpy())


def test_launch_bytes_and_plan_cache_match_reference():
    port_reqs, ref_reqs = _affine_workload(seed=43, n=32, max_points=200)
    srv = _server()
    with opcount.counting() as got:
        srv.serve(port_reqs)
        srv.serve(port_reqs)
    jsrv = _jax_server()
    from repro.kernels import opcount as jopcount
    with jopcount.counting() as want:
        jsrv.serve(ref_reqs)
        jsrv.serve(ref_reqs)
    assert got == want
    for key in ("plan_compiles", "plan_hits"):
        assert serving.stats[key] == jserving.stats[key], key
    assert serving.stats["launches"] == sum(r.launches for r in srv.reports)
    srv.reset_stats()
    assert srv.reports == [] and serving.stats["launches"] == 0


def test_cpu_server_times_its_phases():
    reqs, _ = _affine_workload(seed=2, n=8, max_points=64)
    srv = _server()
    srv.serve(reqs)
    assert set(srv.last_timing) == {"pack_s", "dispatch_s", "unpack_s"}
    assert all(v >= 0 for v in srv.last_timing.values())

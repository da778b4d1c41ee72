"""The port's serving engine against the JAX package's.

Workloads come from the same numpy seeds through both packages'
``random_workload``, over the affine pool and over the full ``TEMPLATES``
pool (projective structures included).  Deterministic counters (launches,
buckets, shards, payload and padded points, launch bytes) must EQUAL the
reference's live counters; served results must be within
|port - jax| <= 4 eps32 (sum_m |p_m A_mc| + |t_c|) per element of the
reference's served results for affine plans (XLA:CPU contracts some
multiply-adds; the port never does), and within the projective float
contract of ``torch_bounds.py`` for projective plans, masks included.  Within the port, packed results equal
per-request ``apply``/``project`` BITWISE, masks included.  Results of the
int16 Qm.n lane (``qformat=``) equal the reference's BITWISE, wrapped
words included: its arithmetic is integer, exact and order-independent.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import serving as jserving
from repro.core import transform_chain as jtc
from repro.errors import QRangeError as JQRangeError
from repro.serving import bucketing as jbucketing
from repro.serving import workload as jworkload
from repro_torch import errors, serving
from repro_torch.core import transform_chain as tc
from repro_torch.kernels import opcount
from repro_torch.kernels.fixedpoint import ref as q_ref
from repro_torch.quantize import Q8_7, quantize_fold
from repro_torch.serving import bucketing, workload
from torch_bounds import check_projective

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


@pytest.fixture
def reference_q_plans():
    """Tests that serve the JAX package's q lane compile its plans; drop
    them AFTER the test, so a reference test later in the same worker
    that counts q8.7 plan compiles finds the caches as it would alone."""
    yield
    jserving.clear_plan_cache()
    jtc.clear_plan_cache()


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _bound(chain, pts):
    p = np.abs(pts.reshape(-1, chain.dim).astype(np.float64))
    folded = [np.abs(f.astype(np.float64)) for f in chain.fold()]
    mag = p * folded[0] if chain.is_diagonal else p @ folded[0]
    return (4 * EPS32 * (mag + folded[1])).reshape(pts.shape)


POOLS = {"affine": (workload.AFFINE_TEMPLATES, jworkload.AFFINE_TEMPLATES),
         "all": (workload.TEMPLATES, jworkload.TEMPLATES)}


def _workload(seed, n, max_points, pool):
    port_pool, ref_pool = POOLS[pool]
    return (workload.random_workload(seed=seed, n_requests=n,
                                     templates=port_pool,
                                     max_points=max_points),
            jworkload.random_workload(seed=seed, n_requests=n,
                                      templates=ref_pool,
                                      max_points=max_points))


def _affine_workload(seed=1904, n=64, max_points=1024):
    return _workload(seed, n, max_points, "affine")


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
    # the reference's signature (the backend whose tuning cache entry
    # applies); tuning is off by default in both packages
    assert bucketing.grid_for("ref") == jbucketing.grid_for("ref") \
        == (8, 0.5, "default")
    assert bucketing.grid_for("ref", min_len=16) == \
        jbucketing.grid_for("ref", min_len=16) == \
        (16, 0.5, "explicit+default")
    with pytest.raises(ValueError):
        bucketing.padded_length(5, waste_cap=1.0)


@pytest.mark.parametrize("max_points_per_launch, pool", [
    pytest.param(None, "affine", id="None"),
    pytest.param(256, "affine", id="256"),
    pytest.param(None, "all", id="None-all"),
    pytest.param(256, "all", id="256-all")])
def test_counters_equal_reference(max_points_per_launch, pool):
    """Seed 1904, 64 requests: the reference's live counters (for the
    affine pool 35 launches and 3576 padded points without a launch
    cap)."""
    port_reqs, ref_reqs = _workload(1904, 64, 1024, pool)
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
    if max_points_per_launch is None and pool == "affine":
        assert serving.stats["launches"] == 35
        assert serving.stats["padded_points"] == 3576
    elif max_points_per_launch is not None:
        assert serving.stats["shards"] > 0
    assert serving.stats["launches"] == sum(r.launches for r in srv.reports)


def _check_served_results(pool):
    port_reqs, ref_reqs = _workload(11, 48, 300, pool)
    outs = _server().serve(port_reqs)
    jouts = _jax_server().serve(ref_reqs)
    for (chain, pts), out, jout in zip(port_reqs, outs, jouts):
        assert isinstance(out, np.ndarray) and out.shape == pts.shape
        if chain.is_projective:
            assert isinstance(out, serving.Projected)
            assert out.mask.shape == pts.shape[:-1]
            check_projective(pts, chain.fold(), out, out.mask, jout, jout.mask)
        else:
            assert np.all(np.abs(out.astype(np.float64) - np.asarray(jout))
                          <= _bound(chain, pts))
    return port_reqs


def test_served_results_match_reference():
    _check_served_results("affine")


def test_served_results_match_reference_full_pool():
    reqs = _check_served_results("all")
    assert {c.plan_kind for c, _ in reqs} == {"diag", "matrix", "projective"}


@pytest.mark.parametrize("seed, pool", [
    pytest.param(11, "affine", id="11"),
    pytest.param(1904, "affine", id="1904"),
    pytest.param(11, "all", id="11-all"),
    pytest.param(1904, "all", id="1904-all")])
def test_packed_equals_per_request_apply_bitwise(seed, pool):
    """Every plan kind of the pool: no last-ULP daylight within the
    port; projective results carry the mask of per-request
    ``project``."""
    reqs, _ = _workload(seed, 48, 300, pool)
    kinds = {"diag", "matrix"} | ({"projective"} if pool == "all" else set())
    assert {c.plan_kind for c, _ in reqs} == kinds
    outs = _server().serve(reqs)
    for (chain, pts), out in zip(reqs, outs):
        assert _same_bits(out, chain.apply(torch.from_numpy(pts)).numpy())
        if chain.is_projective:
            got, mask = chain.project(torch.from_numpy(pts))
            assert _same_bits(out, got.numpy())
            assert _same_bits(out.mask, mask.numpy())


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
    ticket = srv.submit(workload.chain_for(rng, 3, "MPC"),
                        np.ones((3, 3), np.float32))   # projective: accepted
    q_ticket = srv.submit(chain, np.ones((3, 2), np.float32),
                          qformat="q8.7")              # the Qm.n lane too
    assert serving.stats["rejected_requests"] == 4    # the typed errors
    assert srv.pending == 2 and (ticket, q_ticket) == (4, 5)
    out, q_out = srv.flush()
    assert isinstance(out, serving.Projected) and out.mask.shape == (3,)
    assert q_out.dtype == np.float32 and q_out.shape == (3, 2)


def test_projective_fold_with_infinite_bounds_is_accepted():
    """A TSP chain folds to lo = -inf, hi = +inf (no cull): only H is
    held finite at submit, as in the reference, which serves it."""
    chain = workload.chain_for(np.random.default_rng(12), 2, "TSP")
    _, lo, hi = chain.fold()
    assert np.isneginf(lo).all() and np.isposinf(hi).all()
    pts = np.random.default_rng(13).standard_normal((40, 2)).astype(
        np.float32)
    srv = _server()
    srv.submit(chain, pts)
    jsrv = _jax_server()
    jsrv.submit(jtc.TransformChain(chain.dim, chain.kinds, chain.params),
                pts)
    (out,), (jout,) = srv.flush(), jsrv.flush()
    assert serving.stats["rejected_requests"] == 0
    assert isinstance(out, serving.Projected)
    check_projective(pts, chain.fold(), out, out.mask, jout, jout.mask)
    got, mask = chain.project(torch.from_numpy(pts))
    assert _same_bits(out, got.numpy()) and _same_bits(out.mask, mask.numpy())
    with pytest.raises(errors.NonFiniteError):
        srv.submit(tc.TransformChain.identity(2).projective(
            np.full((3, 3), np.inf, np.float32)), pts)


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


def _check_launch_bytes_and_plan_cache(pool):
    port_reqs, ref_reqs = _workload(43, 32, 200, pool)
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
    return got


def test_launch_bytes_and_plan_cache_match_reference():
    _check_launch_bytes_and_plan_cache("affine")


def test_launch_bytes_and_plan_cache_match_reference_full_pool():
    records = _check_launch_bytes_and_plan_cache("all")
    assert any(op == "serve_bucket_projective" for op, _ in records)


def test_cpu_server_times_its_phases():
    reqs, _ = _affine_workload(seed=2, n=8, max_points=64)
    srv = _server()
    srv.serve(reqs)
    assert set(srv.last_timing) == {"pack_s", "dispatch_s", "unpack_s"}
    assert all(v >= 0 for v in srv.last_timing.values())


# -- the int16 Qm.n lane ----------------------------------------------------

def _q_oracle(chain, words):
    folded_q = quantize_fold(chain.fold(), chain.plan_kind, Q8_7)
    oracle = q_ref.np_chain_diag_q if chain.is_diagonal \
        else q_ref.np_chain_matrix_q
    return oracle(words.reshape(-1, chain.dim), *folded_q,
                  Q8_7.n).reshape(words.shape)


def _serve_triples(srv, reqs):
    for chain, pts, q in reqs:
        srv.submit(chain, pts, qformat=q)
    return srv.flush()


def _reports(srv):
    return [(r.structure, r.kind, r.lpad, r.requests, r.launches,
             r.q_fallback_requests) for r in srv.last_report]


@pytest.mark.parametrize("seed", [0, 5])
def test_mixed_lane_workload_matches_reference(seed, reference_q_plans):
    """``mixed_lane_workload(seed, 128)``: float affine, projective and
    q8.7 requests in one flush.  The q results equal the reference's and
    the numpy Q oracle's bit for bit, the float ones lie within the float
    contract, and the counters, bucket reports and launch bytes are the
    reference's."""
    reqs = workload.mixed_lane_workload(seed, 128)
    jreqs = jworkload.mixed_lane_workload(seed, 128)
    srv, jsrv = _server(), _jax_server()
    with opcount.counting() as got:
        outs = _serve_triples(srv, reqs)
    from repro.kernels import opcount as jopcount
    with jopcount.counting() as want:
        jouts = _serve_triples(jsrv, jreqs)
    assert got == want
    assert any(op.endswith("_q") for op, _ in got)
    for key in (*COUNTERS, "q_fallbacks", "plan_compiles", "plan_hits"):
        assert serving.stats[key] == jserving.stats[key], key
    assert _reports(srv) == [(r.structure, r.kind, r.lpad, r.requests,
                              r.launches, r.q_fallback_requests)
                             for r in jsrv.last_report]
    n_q = 0
    for (chain, pts, q), out, jout in zip(reqs, outs, jouts, strict=True):
        if q is not None:
            n_q += 1
            assert _same_bits(out, np.asarray(jout))
            assert _same_bits(out, Q8_7.dequantize(
                _q_oracle(chain, Q8_7.quantize(pts))))
        elif chain.is_projective:
            check_projective(pts, chain.fold(), out, out.mask, jout,
                             jout.mask)
        else:
            assert np.all(np.abs(out.astype(np.float64) - np.asarray(jout))
                          <= _bound(chain, pts))
    assert n_q > 0


def test_q_packed_equals_per_request_apply_and_shares_buckets(
        reference_q_plans):
    """A float-submitted and an int16-submitted q8.7 request of one
    structure pack into ONE int16 bucket (the key is the format, not the
    submitted dtype), apart from the float lane's bucket; each result is
    bitwise the per-request ``apply(dtype=)``, float in float32 out and
    int16 in int16 out."""
    rng = np.random.default_rng(50)
    chain = workload.chain_for(rng, 2, "TSRT")
    pts = rng.uniform(-3, 3, (20, 2)).astype(np.float32)
    words = Q8_7.quantize(pts)
    reqs = [(chain, pts, "q8.7"), (chain, words, "q8.7"), (chain, pts, None)]
    srv = _server()
    out_f, out_q, out_float = _serve_triples(srv, reqs)
    jsrv = _jax_server()
    jouts = _serve_triples(jsrv, [(jtc.TransformChain(chain.dim, chain.kinds,
                                                      chain.params), p, q)
                                  for _, p, q in reqs])
    assert serving.stats["buckets"] == serving.stats["launches"] == 2
    assert jserving.stats["buckets"] == 2
    assert out_f.dtype == np.float32 and out_q.dtype == np.int16
    assert _same_bits(out_f, chain.apply(torch.from_numpy(pts),
                                         dtype="q8.7").numpy())
    assert _same_bits(out_q, chain.apply(torch.from_numpy(words),
                                         dtype="q8.7").numpy())
    assert _same_bits(Q8_7.quantize(out_f), out_q)
    assert _same_bits(out_f, np.asarray(jouts[0]))
    assert _same_bits(out_q, np.asarray(jouts[1]))
    assert _same_bits(out_float, chain.apply(torch.from_numpy(pts)).numpy())


def _overflowing():
    """A chain q8.7 cannot hold (its scale saturates at 255.99) and
    points in and out of range, as float32 and as int16 words."""
    chain = tc.TransformChain.identity(2).scale(1000.0).translate(0.5, -1.0)
    pts = np.random.default_rng(51).uniform(-3, 3, (30, 2)).astype(
        np.float32)
    return chain, jtc.TransformChain(chain.dim, chain.kinds, chain.params), \
        pts, Q8_7.quantize(pts)


def test_q_overflow_reject_raises_with_ticket(reference_q_plans):
    chain, jchain, pts, words = _overflowing()
    cfg = serving.FaultConfig(on_q_overflow="reject")
    srv = _server(fault_config=cfg)
    jsrv = _jax_server(fault_config=jserving.FaultConfig(
        on_q_overflow="reject"))
    srv.submit(chain, pts)                               # float lane: fine
    jsrv.submit(jchain, pts)
    for sub in (pts, words):
        with pytest.raises(errors.QRangeError) as got:
            srv.submit(chain, sub, qformat="q8.7")
        with pytest.raises(JQRangeError) as want:
            jsrv.submit(jchain, sub, qformat="q8.7")
        assert (got.value.code, got.value.ticket, str(got.value)) \
            == (want.value.code, want.value.ticket, str(want.value))
    assert got.value.ticket == 2
    assert serving.stats["rejected_requests"] \
        == jserving.stats["rejected_requests"] == 2
    assert srv.pending == 1


def test_q_overflow_wrap_serves_wrapped_words(reference_q_plans):
    """``"wrap"``: no check -- the lane's int32 accumulator and int16
    store wrap, and the served words are the numpy oracle's and the
    reference's, bit for bit."""
    chain, jchain, pts, words = _overflowing()
    srv = _server(fault_config=serving.FaultConfig(on_q_overflow="wrap"))
    jsrv = _jax_server(fault_config=jserving.FaultConfig(
        on_q_overflow="wrap"))
    full = np.random.default_rng(52).integers(
        -(1 << 15), 1 << 15, (40, 2)).astype(np.int16)
    reqs = [(pts, "q8.7"), (words, "q8.7"), (full, "q8.7")]
    outs = _serve_triples(srv, [(chain, p, q) for p, q in reqs])
    jouts = _serve_triples(jsrv, [(jchain, p, q) for p, q in reqs])
    for out, jout in zip(outs, jouts):
        assert _same_bits(out, np.asarray(jout))
    wrapped = _q_oracle(chain, words)
    assert _same_bits(outs[1], wrapped)
    assert _same_bits(outs[2], _q_oracle(chain, full))
    assert _same_bits(outs[0], Q8_7.dequantize(wrapped))
    # the words did wrap: the exact values lie far outside the format
    assert np.abs(pts * 255.9921875).max() > 256
    assert serving.stats["q_fallbacks"] == 0


def test_q_overflow_fallback_reroutes_and_requantises(reference_q_plans):
    """The default ``"fallback"``: the request is served on the float lane
    (counted in ``q_fallbacks`` and the bucket's ``q_fallback_requests``),
    a float caller gets float32 and an int16 caller requantised int16 --
    the reference's counters and words."""
    chain, jchain, pts, words = _overflowing()
    srv, jsrv = _server(), _jax_server()
    reqs = [(pts, "q8.7"), (words, "q8.7"), (pts, None)]
    out_f, out_q, out_float = _serve_triples(
        srv, [(chain, p, q) for p, q in reqs])
    jouts = _serve_triples(jsrv, [(jchain, p, q) for p, q in reqs])
    assert serving.stats["q_fallbacks"] == jserving.stats["q_fallbacks"] == 2
    assert _reports(srv) == [(r.structure, r.kind, r.lpad, r.requests,
                              r.launches, r.q_fallback_requests)
                             for r in jsrv.last_report]
    assert sum(r.q_fallback_requests for r in srv.last_report) == 2
    assert out_f.dtype == np.float32 and out_q.dtype == np.int16
    assert _same_bits(out_f, out_float)
    assert _same_bits(out_f, chain.apply(torch.from_numpy(pts)).numpy())
    deq = torch.from_numpy(Q8_7.dequantize(words))
    assert _same_bits(out_q, Q8_7.quantize(chain.apply(deq).numpy()))
    assert _same_bits(out_q, np.asarray(jouts[1]))
    assert np.all(np.abs(out_f.astype(np.float64) - np.asarray(jouts[0]))
                  <= _bound(chain, pts))


@pytest.mark.parametrize("validate", [True, False])
def test_non_finite_outputs_resolve_like_reference(validate):
    """A d = 3 chain scale([1e30, 1, 1]) over 64 points of 1e10 overflows
    float32 to inf.  With ``validate_outputs`` (the default) the launch
    raises ``CorruptionError`` and the recovery ladder (retries, then
    bisection) ends with a ``LaunchError`` in that request's slot and its
    finite neighbours in the same launch served; the port resolves the
    same slots, tickets and message text, and its recovery counters
    (launches, launch failures, retries, bisections, recovered and
    failed requests) equal the reference's.  Without it both return the
    infs in one launch."""
    chain = tc.TransformChain.identity(3).scale([1e30, 1.0, 1.0])
    jchain = jtc.TransformChain(chain.dim, chain.kinds, chain.params)
    rng = np.random.default_rng(54)
    subs = [rng.standard_normal((64, 3)).astype(np.float32),
            np.full((64, 3), 1e10, np.float32),
            rng.standard_normal((50, 3)).astype(np.float32)]
    srv = _server(fault_config=serving.FaultConfig(validate_outputs=validate))
    jsrv = _jax_server(fault_config=jserving.FaultConfig(
        validate_outputs=validate))
    outs = srv.serve([(chain, p) for p in subs])
    jouts = jsrv.serve([(jchain, p) for p in subs])
    assert len({r.structure for r in srv.last_report}) == 1
    for i, (out, jout) in enumerate(zip(outs, jouts)):
        if validate and i == 1:
            assert isinstance(out, errors.LaunchError)
            assert type(jout).__name__ == "LaunchError"
            assert out.ticket == jout.ticket == 1
            for e in (out, jout):
                assert "non-finite values in diag launch output" in str(e)
        else:
            assert isinstance(out, np.ndarray) and out.dtype == np.float32
            assert np.array_equal(out, np.asarray(jout))
    if not validate:
        assert np.isinf(outs[1]).any() and np.isinf(jouts[1]).any()
    failed = 1 if validate else 0
    assert serving.stats["failed_requests"] \
        == jserving.stats["failed_requests"] == failed
    assert sum(r.failed_requests for r in srv.last_report) \
        == sum(r.failed_requests for r in jsrv.last_report) == failed
    recovery = ("launches", "launch_failures", "retries", "bisections",
                "recovered_requests", "failed_requests")
    assert {k: serving.stats[k] for k in recovery} \
        == {k: jserving.stats[k] for k in recovery}
    # 3 attempts of the bucket, bisect: [0] in 1, [1, 2] in 3, bisect:
    # [1] in 3 (then its LaunchError), [2] in 1
    assert serving.stats["launches"] == (3 + 1 + 3 + 3 + 1 if validate else 1)
    assert [(r.launches, r.retries, r.bisections, r.recovered_requests)
            for r in srv.last_report] == \
        [(r.launches, r.retries, r.bisections, r.recovered_requests)
         for r in jsrv.last_report]


def test_q_intake_matches_reference(reference_q_plans):
    """FaultConfig validation, and the q intake's refusals: a projective
    chain, a bad format, int32 points; identity q requests pass through."""
    assert serving.FaultConfig() == serving.FaultConfig(on_q_overflow="fallback")
    assert {f: getattr(serving.FaultConfig(), f) for f in (
        "max_launch_attempts", "backoff_base_s", "backoff_factor",
        "backoff_cap_s", "validate_finite", "validate_outputs",
        "on_q_overflow")} == {f: getattr(jserving.FaultConfig(), f) for f in (
            "max_launch_attempts", "backoff_base_s", "backoff_factor",
            "backoff_cap_s", "validate_finite", "validate_outputs",
            "on_q_overflow")}
    with pytest.raises(ValueError, match="on_q_overflow"):
        serving.FaultConfig(on_q_overflow="explode")
    with pytest.raises(ValueError, match="max_launch_attempts"):
        serving.FaultConfig(max_launch_attempts=0)
    rng = np.random.default_rng(53)
    srv = _server()
    pts = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="fixed-point"):
        srv.submit(workload.chain_for(rng, 3, "MPC"), pts, qformat="q8.7")
    chain = workload.chain_for(rng, 3, "SAT")
    with pytest.raises(ValueError, match="not a fixed-point format"):
        srv.submit(chain, pts, qformat="float32")
    with pytest.raises(errors.DtypeError) as ei:
        srv.submit(chain, pts.astype(np.int32), qformat="q8.7")
    assert ei.value.ticket == 2
    assert serving.stats["rejected_requests"] == 1
    ident = srv.submit(tc.TransformChain.identity(3), Q8_7.quantize(pts),
                       qformat="q8.7")
    (out,) = srv.flush()
    assert ident == 3 and _same_bits(out, Q8_7.quantize(pts))
    assert serving.stats["launches"] == 0

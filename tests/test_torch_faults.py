"""The port's fault model against the JAX package's: the typed
request-error taxonomy, submit/apply boundary validation, the q-lane wrap
policies, the engine's retry / backend-degradation / bisection recovery
ladder under seeded fault injection, and the chaos soak.

Mirrors ``tests/test_faults.py`` case by case.  The parity cases drive
both packages from the same numpy seeds and injector settings: the
pinned scenarios resolve the same tickets with the same ``BucketReport``
fields, and ``run_chaos_soak(seed=11, n_requests=64)`` gives exactly the
counters of ``tests/torch_chaos.py`` -- the one-rung ladder on the CPU,
and the two-rung one (the card's shape, ``("cuda", "ref")``) with the
port's ladder patched to ``("ref", "ref")`` here.  A VirtualClock trace
of the soak has the reference's spans, events and fields, the ``launch``
instant's autotune fields (``config``, ``kernel``, ``pred_*``) included,
but for the ``plan.trace`` instants of jit traces, which eager PyTorch
does not have.
"""
import collections
import json

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

import torch_chaos  # noqa: E402
from repro import errors as jerrors  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import transform_chain as jtc  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving.clock import VirtualClock as JVirtualClock  # noqa: E402
from repro_torch import errors, obs, quantize, serving  # noqa: E402
from repro_torch.core import transform_chain as tc  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving import engine, faults, workload  # noqa: E402
from repro_torch.serving.clock import VirtualClock  # noqa: E402

RNG = np.random.default_rng(60)


def _fresh(**kw):
    serving.reset_stats()
    serving.clear_plan_cache()
    return serving.GeometryServer(device="cpu", **kw)


def _chain2():
    return tc.TransformChain.identity(2).translate(0.5, -0.25).scale(1.5, 0.5)


def _pts(n=8, dim=2):
    return RNG.uniform(-1, 1, (n, dim)).astype(np.float32)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


@pytest.fixture
def two_rungs(monkeypatch):
    """The card's two-rung ladder on the CPU: the plain version stands in
    for the kernel on rung 0 (``backend`` tickets fail only there)."""
    monkeypatch.setattr(dispatch, "fallback_ladder",
                        lambda backend: ("ref", "ref"))


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

class TestTaxonomy:
    def test_codes_and_subclassing(self):
        for cls, code in [(errors.ShapeError, "shape"),
                          (errors.DtypeError, "dtype"),
                          (errors.EmptyPointsError, "empty"),
                          (errors.NonFiniteError, "nonfinite"),
                          (errors.QRangeError, "q-range"),
                          (errors.LaunchError, "launch")]:
            assert issubclass(cls, errors.RequestError)
            assert issubclass(cls, ValueError)
            assert cls.code == code == getattr(jerrors, cls.__name__).code
        assert issubclass(errors.DtypeError, TypeError)
        # infrastructure faults are not request errors
        for cls in (serving.InjectedFault, serving.CorruptionError):
            assert issubclass(cls, RuntimeError)
            assert not issubclass(cls, errors.RequestError)
            assert not serving.is_error(cls("x"))

    def test_ticket_prefix_and_with_ticket(self):
        e = errors.ShapeError("bad", ticket=42)
        assert e.ticket == 42 and "[request 42]" in str(e)
        anon = errors.NonFiniteError("nan")
        assert anon.ticket is None and "[request" not in str(anon)
        named = anon.with_ticket(7)
        assert type(named) is errors.NonFiniteError and named.ticket == 7

    def test_fault_config_validates(self):
        with pytest.raises(ValueError):
            engine.FaultConfig(on_q_overflow="explode")
        with pytest.raises(ValueError):
            engine.FaultConfig(max_launch_attempts=0)

    def test_fallback_ladder(self):
        assert dispatch.FALLBACK_ORDER == ("cuda", "ref")
        assert dispatch.fallback_ladder("cuda") == ("cuda", "ref")
        assert dispatch.fallback_ladder("ref") == ("ref",)
        assert dispatch.fallback_ladder(
            dispatch.backend_for(torch.device("cpu"))) == ("ref",)
        with pytest.raises(ValueError):
            dispatch.fallback_ladder("interpret")


# ---------------------------------------------------------------------------
# boundary validation
# ---------------------------------------------------------------------------

class TestApplyBoundary:
    def test_apply_rejects_empty_and_shape_and_float64(self):
        chain = _chain2()
        with pytest.raises(errors.EmptyPointsError):
            chain.apply(np.zeros((0, 2), np.float32), device="cpu")
        with pytest.raises(errors.ShapeError):
            chain.apply(np.zeros((4, 3), np.float32), device="cpu")
        with pytest.raises(errors.DtypeError):
            chain.apply(np.zeros((4, 2), np.float64), device="cpu")

    def test_apply_shape_error_is_still_a_valueerror(self):
        with pytest.raises(ValueError):
            _chain2().apply(np.zeros((4, 3), np.float32), device="cpu")


class TestSubmitBoundary:
    def test_typed_rejections_carry_the_ticket(self):
        srv = _fresh()
        srv.submit(_chain2(), _pts())            # ticket 0
        cases = [
            (np.zeros((0, 2), np.float32), errors.EmptyPointsError),
            (np.zeros((3, 3), np.float32), errors.ShapeError),
            (np.zeros((3, 2), np.float64), errors.DtypeError),
            (np.float32(1.0), errors.ShapeError),          # bare scalar
            (np.full((3, 2), np.inf, np.float32), errors.NonFiniteError),
        ]
        for i, (bad, exc) in enumerate(cases):
            with pytest.raises(exc) as ei:
                srv.submit(_chain2(), bad)
            assert ei.value.ticket == 1 + i
        assert serving.stats["rejected_requests"] == len(cases)
        assert srv.metrics.value("rejected_requests") == len(cases)
        (out,) = srv.flush()
        assert out.shape == (8, 2)

    def test_float_lane_is_strict_float32(self):
        srv = _fresh()
        with pytest.raises(errors.DtypeError):
            srv.submit(_chain2(), np.zeros((4, 2), np.float16))
        with pytest.raises(errors.DtypeError):
            srv.submit(_chain2(), np.zeros((4, 2), np.int32))

    def test_nonfinite_fold_rejected_at_submit(self):
        srv = _fresh()
        chain = tc.TransformChain.identity(2).scale(np.inf, 1.0)
        with pytest.raises(errors.NonFiniteError) as ei:
            srv.submit(chain, _pts())
        assert "fold" in str(ei.value)

    def test_malform_modes_map_to_codes(self):
        srv = _fresh()
        assert faults.MALFORM_MODES == jfaults.MALFORM_MODES
        for mode, code in faults.MALFORM_MODES:
            with pytest.raises(errors.RequestError) as ei:
                srv.submit(_chain2(), faults.malform(_pts(), mode))
            assert ei.value.code == code, mode
        with pytest.raises(ValueError):
            faults.malform(_pts(), "explode")


class TestQOverflowPolicy:
    def test_wrap_boundary_is_pinned(self):
        fmt = quantize.as_qformat("q8.7")
        ok = tc.TransformChain.identity(2).scale(100.0).fold()
        bad = tc.TransformChain.identity(2).scale(1000.0).fold()
        assert quantize.fits(ok, "diag", fmt, 1.0)
        assert not quantize.fits(bad, "diag", fmt, 1.0)
        with pytest.raises(errors.QRangeError):
            quantize.ensure_fits(bad, "diag", fmt, 1.0, ticket=5)

    def test_reject_policy_raises_qrange(self):
        srv = _fresh(fault_config=engine.FaultConfig(on_q_overflow="reject"))
        chain = tc.TransformChain.identity(2).scale(1000.0)
        with pytest.raises(errors.QRangeError) as ei:
            srv.submit(chain, _pts(), qformat="q8.7")
        assert ei.value.ticket == 0
        assert serving.stats["rejected_requests"] == 1

    def test_fallback_policy_serves_through_float32(self):
        srv = _fresh()
        chain = tc.TransformChain.identity(2).scale(1000.0)
        pts = _pts()
        srv.submit(chain, pts, qformat="q8.7")
        (out,) = srv.flush()
        assert out.dtype == np.float32
        assert _same_bits(out, chain.apply(pts, device="cpu").numpy())
        assert serving.stats["q_fallbacks"] == 1
        assert srv.last_report[0].q_fallback_requests == 1

    def test_fallback_requantises_for_int16_callers(self):
        srv = _fresh()
        chain = tc.TransformChain.identity(2).scale(1000.0)
        words = quantize.as_qformat("q8.7").quantize(_pts())
        srv.submit(chain, words, qformat="q8.7")
        (out,) = srv.flush()
        assert out.dtype == np.int16

    def test_fitting_q_requests_stay_bitwise(self):
        srv = _fresh()
        chain, pts = _chain2(), _pts(16)
        srv.submit(chain, pts, qformat="q8.7")
        (out,) = srv.flush()
        ref = chain.apply(pts, dtype="q8.7", device="cpu").numpy()
        assert _same_bits(out, ref)
        assert serving.stats["q_fallbacks"] == 0

    def test_wrap_policy_preserves_legacy_semantics(self):
        srv = _fresh(fault_config=engine.FaultConfig(on_q_overflow="wrap"))
        chain = tc.TransformChain.identity(2).scale(1000.0)
        pts = _pts()
        srv.submit(chain, pts, qformat="q8.7")
        (out,) = srv.flush()
        ref = chain.apply(pts, dtype="q8.7", device="cpu").numpy()
        assert _same_bits(out, ref)
        assert serving.stats["q_fallbacks"] == 0


# ---------------------------------------------------------------------------
# the recovery ladder under seeded injection
# ---------------------------------------------------------------------------

def _cfg(**kw):
    kw.setdefault("backoff_base_s", 0.0)     # tests need no real sleeps
    return engine.FaultConfig(**kw)


class TestRecovery:
    def test_flaky_launch_recovers_by_retry(self):
        inj = faults.FaultInjector(flaky_tickets=frozenset({0, 1}),
                                   flaky_attempts=2)
        srv = _fresh(fault_config=_cfg(), injector=inj)
        chain, pts = _chain2(), _pts()
        srv.submit(chain, pts)
        srv.submit(chain, _pts())
        out = srv.flush()
        assert _same_bits(out[0], chain.apply(pts, device="cpu").numpy())
        # attempt 0 (phase 1) + attempt 1 fail, attempt 2 succeeds
        assert serving.stats["launch_failures"] == 2
        assert serving.stats["retries"] == 2
        assert serving.stats["recovered_requests"] == 2
        assert serving.stats["failed_requests"] == 0
        assert srv.last_report[0].retries == 2
        assert "recover_s" in srv.last_timing

    def test_backend_fault_degrades_down_the_ladder(self, two_rungs):
        inj = faults.FaultInjector(backend_tickets=frozenset({0}))
        srv = _fresh(fault_config=_cfg(max_launch_attempts=2), injector=inj)
        chain, pts = _chain2(), _pts()
        srv.submit(chain, pts)
        (out,) = srv.flush()
        assert _same_bits(out, chain.apply(pts, device="cpu").numpy())
        assert serving.stats["backend_fallbacks"] == 1
        rep = srv.last_report[0]
        assert rep.backend == "ref" and rep.final_backend == "ref"
        assert rep.backend_fallbacks == 1

    def test_backend_fault_fails_on_a_one_rung_ladder(self):
        inj = faults.FaultInjector(backend_tickets=frozenset({0}))
        srv = _fresh(fault_config=_cfg(max_launch_attempts=2), injector=inj)
        srv.submit(_chain2(), _pts())
        (out,) = srv.flush()
        assert isinstance(out, errors.LaunchError) and out.ticket == 0
        assert "('ref',)" in str(out) and "injected backend fault" in str(out)
        assert serving.stats["backend_fallbacks"] == 0

    def test_corruption_detected_and_retried_clean(self):
        inj = faults.FaultInjector(corrupt_tickets=frozenset({0}))
        srv = _fresh(fault_config=_cfg(), injector=inj)
        chain, pts = _chain2(), _pts()
        srv.submit(chain, pts)
        (out,) = srv.flush()
        # the retry re-packed from the clean host copy
        assert np.isfinite(out).all()
        assert _same_bits(out, chain.apply(pts, device="cpu").numpy())
        assert inj.injected_corruptions == 1
        assert serving.stats["launch_failures"] == 1
        assert serving.stats["retries"] == 1
        assert serving.stats["recovered_requests"] == 1
        assert serving.stats["launches"] == 2

    def test_corrupt_staging_returns_a_copy(self):
        inj = faults.FaultInjector(corrupt_tickets=frozenset({1}))
        packed = torch.zeros(3, 4, 2)
        out = inj.corrupt_staging(packed, (0, 1, 2), 0, 0)
        assert out is not packed and torch.isnan(out[1, 0, 0])
        assert int(torch.isnan(out).sum()) == 1
        assert not torch.isnan(packed).any()
        # later attempts and rungs, and clean groups, stage the buffer
        assert inj.corrupt_staging(packed, (0, 1, 2), 0, 1) is packed
        assert inj.corrupt_staging(packed, (0, 1, 2), 1, 0) is packed
        assert inj.corrupt_staging(packed, (0, 2), 0, 0) is packed
        assert inj.injected_corruptions == 1

    def test_poison_is_bisected_to_a_named_failure(self):
        inj = faults.FaultInjector(poison_tickets=frozenset({3}))
        srv = _fresh(fault_config=_cfg(max_launch_attempts=2), injector=inj)
        chain = _chain2()
        ptss = [_pts(8) for _ in range(8)]
        for p in ptss:
            srv.submit(chain, p)
        out = srv.flush()
        assert len(out) == 8
        for i in range(8):
            if i == 3:
                assert isinstance(out[i], errors.LaunchError)
                assert serving.is_error(out[i]) and out[i].ticket == 3
            else:
                assert _same_bits(out[i],
                                  chain.apply(ptss[i], device="cpu").numpy())
        assert serving.stats["bisections"] == 3   # 8 -> 4 -> 2 -> 1
        assert serving.stats["failed_requests"] == 1
        assert serving.stats["recovered_requests"] == 7
        rep = srv.last_report[0]
        assert rep.bisections == 3 and rep.failed_requests == 1

    def test_failed_bucket_never_touches_its_neighbours(self):
        inj = faults.FaultInjector(poison_tickets=frozenset({0}))
        srv = _fresh(fault_config=_cfg(max_launch_attempts=2), injector=inj)
        clean_chain = tc.TransformChain.identity(3).translate(1.0, 2.0, 3.0)
        srv.submit(_chain2(), _pts())                 # ticket 0: poison
        clean_pts = _pts(8, 3)
        srv.submit(clean_chain, clean_pts)            # different bucket
        out = srv.flush()
        assert isinstance(out[0], errors.LaunchError)
        assert _same_bits(out[1],
                          clean_chain.apply(clean_pts, device="cpu").numpy())
        clean_rep = [r for r in srv.last_report
                     if r.structure.startswith("3D")][0]
        assert clean_rep.launches == 1 and clean_rep.failed_requests == 0

    def test_failed_shard_does_not_orphan_sibling_shards(self):
        inj = faults.FaultInjector(poison_tickets=frozenset({4}))
        srv = _fresh(fault_config=_cfg(max_launch_attempts=2), injector=inj,
                     max_points_per_launch=3 * 128)
        chain = _chain2()
        ptss = [_pts(100) for _ in range(12)]
        for p in ptss:
            srv.submit(chain, p)
        out = srv.flush()
        rep = srv.last_report[0]
        assert serving.stats["shards"] == 3   # 4 launches = 1 + 3 shards
        for i in range(12):
            if i == 4:
                assert isinstance(out[i], errors.LaunchError)
            else:
                assert _same_bits(out[i],
                                  chain.apply(ptss[i], device="cpu").numpy())
        # only the poisoned shard (3 requests) went through recovery
        assert serving.stats["recovered_requests"] == 2
        assert serving.stats["failed_requests"] == 1
        assert rep.failed_requests == 1

    def test_injected_fault_counts_as_launch_failure_not_launch(self):
        inj = faults.FaultInjector(flaky_tickets=frozenset({0}),
                                   flaky_attempts=1)
        srv = _fresh(fault_config=_cfg(), injector=inj)
        srv.submit(_chain2(), _pts())
        srv.flush()
        # attempt 0 blocked (no dispatch), attempt 1 dispatched
        assert serving.stats["launches"] == 1
        assert serving.stats["launch_failures"] == 1
        assert sum(r.launches for r in srv.last_report) == \
            serving.stats["launches"] == srv.metrics.value("launches")

    def test_a_real_launch_exception_is_contained(self, monkeypatch):
        """A plan that raises on its own (no injector) is a launch failure
        like any other: its bucket fails alone, its neighbour serves."""
        srv = _fresh(fault_config=_cfg(max_launch_attempts=2))
        bad = _chain2()
        good = tc.TransformChain.identity(3).translate(1.0, 2.0, 3.0)
        plan = engine.get_batch_plan(bad.structure, "ref")

        def boom(folded, pts3):
            raise RuntimeError("device fault")
        monkeypatch.setitem(engine._BATCH_PLANS, (bad.structure, "ref", None),
                            engine.BatchPlan(kind=plan.kind, dim=plan.dim,
                                             backend="ref", fn=boom))
        pts = _pts(8, 3)
        srv.submit(bad, _pts())
        srv.submit(good, pts)
        out = srv.flush()
        assert isinstance(out[0], errors.LaunchError)
        assert "device fault" in str(out[0])
        assert _same_bits(out[1], good.apply(pts, device="cpu").numpy())
        assert serving.stats["launch_failures"] == 2

    @pytest.mark.parametrize("fault", ["raise", "corrupt", "injected"])
    def test_plain_version_stands_in_only_after_injected_faults(
            self, fault, monkeypatch):
        """The card's ladder (cuda, ref) on the CPU: the server's rung 0 is
        named ``cuda`` and its plan patched to fail.  A kernel that raises
        or whose output is non-finite retries and bisects on its own rung
        and ends in ``LaunchError``s, never served by the plain version;
        an injected fault degrades to ``ref`` as in the reference."""
        inj = faults.FaultInjector(backend_tickets=frozenset({0, 1})) \
            if fault == "injected" else None
        srv = _fresh(fault_config=_cfg(), injector=inj)
        srv.backend = "cuda"
        chain = _chain2()
        plan = engine.get_batch_plan(chain.structure, "ref")
        calls = []

        def kernel(folded, pts3):
            calls.append(len(pts3))
            if fault == "raise":
                raise RuntimeError("kernel refused")
            out = plan.fn(folded, pts3)
            return out * np.float32(np.inf) if fault == "corrupt" else out
        monkeypatch.setitem(engine._BATCH_PLANS, (chain.structure, "cuda",
                                                  None),
                            engine.BatchPlan(kind=plan.kind, dim=plan.dim,
                                             backend="cuda", fn=kernel))
        subs = [_pts(), _pts()]
        out = srv.serve([(chain, p) for p in subs])
        if fault == "injected":
            for got, p in zip(out, subs):
                assert _same_bits(got, chain.apply(p, device="cpu").numpy())
            assert serving.stats["backend_fallbacks"] == 1
            assert srv.last_report[0].final_backend == "ref"
            assert calls == []
            return
        for t, got in enumerate(out):
            assert isinstance(got, errors.LaunchError) and got.ticket == t
            assert "('cuda',)" in str(got)
        # the pair: 3 attempts, bisected; each half: 3 attempts
        assert calls == [2] * 3 + [1] * 6
        assert serving.stats["backend_fallbacks"] == 0
        assert serving.stats["bisections"] == 1
        assert serving.stats["failed_requests"] == 2


# ---------------------------------------------------------------------------
# the pinned scenarios against the JAX package
# ---------------------------------------------------------------------------

_SCENARIOS = {
    "flaky": dict(flaky_tickets=frozenset({0, 5}), flaky_attempts=2),
    "backend": dict(backend_tickets=frozenset({2})),
    "corrupt": dict(corrupt_tickets=frozenset({1, 6})),
    "poison": dict(poison_tickets=frozenset({3})),
}

_REPORT_FIELDS = ("structure", "kind", "lpad", "requests", "launches",
                  "retries", "bisections", "backend_fallbacks",
                  "recovered_requests", "failed_requests")


@pytest.mark.parametrize("ladder", ["one rung", "two rungs"])
@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_scenario_matches_reference(scenario, ladder, monkeypatch):
    """The same eight requests (two buckets) and the same injected
    tickets through both packages: the same slots resolve to the same
    results or ticket-named ``LaunchError``s, with the same counters and
    ``BucketReport`` fields.  The reference's two-rung ladder is an
    interpret server's (interpret -> ref); the port's is patched to
    (ref, ref), the card's shape."""
    if ladder == "two rungs":
        monkeypatch.setattr(dispatch, "fallback_ladder",
                            lambda backend: ("ref", "ref"))
    rng = np.random.default_rng([0xFA17, 23])
    chains = [workload.chain_for(rng, 2, "TST"),
              workload.chain_for(rng, 3, "TRS")]
    reqs = [(chains[i % 2], rng.uniform(-1, 1, (int(rng.integers(4, 30)),
                                                 2 + i % 2))
             .astype(np.float32)) for i in range(8)]
    kw = _SCENARIOS[scenario]
    srv = _fresh(fault_config=_cfg(), injector=faults.FaultInjector(**kw))
    jserving.reset_stats()
    jserving.clear_plan_cache()
    jsrv = jserving.GeometryServer(
        backend="ref" if ladder == "one rung" else "interpret",
        fault_config=jserving.FaultConfig(backoff_base_s=0.0),
        injector=jfaults.FaultInjector(**kw))
    outs = srv.serve(reqs)
    jouts = jsrv.serve([(jtc.TransformChain(c.dim, c.kinds, c.params), p)
                        for c, p in reqs])
    for i, (out, jout) in enumerate(zip(outs, jouts)):
        if isinstance(jout, jerrors.LaunchError):
            assert isinstance(out, errors.LaunchError) and out.ticket == i
            assert jout.ticket == i
        else:
            assert isinstance(out, np.ndarray)
            np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-6,
                                       atol=1e-6)
    keys = ("launches", "launch_failures", "retries", "backend_fallbacks",
            "bisections", "recovered_requests", "failed_requests")
    assert {k: serving.stats[k] for k in keys} == \
        {k: jserving.stats[k] for k in keys}
    assert [[getattr(r, f) for f in _REPORT_FIELDS] for r in srv.last_report] \
        == [[getattr(r, f) for f in _REPORT_FIELDS] for r in jsrv.last_report]
    # the rung each bucket ended on ("interpret", the reference's rung 0,
    # is the port's "ref")
    assert [r.final_backend for r in srv.last_report] == \
        [r.final_backend.replace("interpret", "ref")
         for r in jsrv.last_report]
    assert (srv.injector.injected_launch_faults,
            srv.injector.injected_corruptions) == \
        (jsrv.injector.injected_launch_faults,
         jsrv.injector.injected_corruptions)
    assert serving.stats["launch_failures"] > 0


# ---------------------------------------------------------------------------
# the chaos soak
# ---------------------------------------------------------------------------

def _event(d: dict) -> str:
    """A span or event as a comparable string, every field but the ids
    (a skipped ``plan.trace`` shifts them)."""
    d = {k: v for k, v in d.items() if k not in ("sid", "parent")}
    return json.dumps(d, sort_keys=True, default=str)


def _port_soak(**kw):
    serving.reset_stats()
    serving.clear_plan_cache()
    tc.clear_plan_cache()
    trc = obs.Tracer(clock=VirtualClock(), recorder=obs.FlightRecorder(512))
    with obs.installed(trc):
        rep = faults.run_chaos_soak(
            seed=torch_chaos.SEED, n_requests=torch_chaos.N_REQUESTS,
            device="cpu", **kw)
    return rep, trc


@pytest.fixture(scope="module")
def reference_soaks():
    """The JAX package's soak at the pinned seed on both ladders, traced
    under a VirtualClock (``backoff_base_s=0.0``: the backoff sleeps
    steer no counter)."""
    out = {}
    for backend in ("ref", "interpret"):
        jserving.reset_stats()
        jserving.clear_plan_cache()
        jtc.clear_plan_cache()
        trc = jobs.Tracer(clock=JVirtualClock(),
                          recorder=jobs.FlightRecorder(512))
        with jobs.installed(trc):
            rep = jfaults.run_chaos_soak(
                seed=torch_chaos.SEED, n_requests=torch_chaos.N_REQUESTS,
                backend=backend,
                fault_config=jserving.FaultConfig(backoff_base_s=0.0))
        out[backend] = (rep, trc)
    jserving.clear_plan_cache()
    jtc.clear_plan_cache()
    return out


class TestChaosSoak:
    def test_reference_still_produces_the_pinned_counters(
            self, reference_soaks):
        assert reference_soaks["ref"][0].counters() == torch_chaos.ONE_RUNG
        assert reference_soaks["interpret"][0].counters() == \
            torch_chaos.TWO_RUNG

    def test_one_rung_counters_equal_the_reference(self):
        rep = faults.run_chaos_soak(seed=torch_chaos.SEED,
                                    n_requests=torch_chaos.N_REQUESTS,
                                    device="cpu")
        assert rep.backend == "ref"
        assert rep.counters() == torch_chaos.ONE_RUNG

    def test_two_rung_counters_equal_the_reference(self, two_rungs):
        rep = faults.run_chaos_soak(seed=torch_chaos.SEED,
                                    n_requests=torch_chaos.N_REQUESTS,
                                    device="cpu")
        assert rep.counters() == torch_chaos.TWO_RUNG

    @pytest.mark.parametrize("ladder", ["ref", "interpret"])
    def test_trace_matches_the_reference(self, ladder, reference_soaks,
                                         monkeypatch):
        if ladder == "interpret":
            monkeypatch.setattr(dispatch, "fallback_ladder",
                                lambda backend: ("ref", "ref"))
        rep, trc = _port_soak(
            fault_config=engine.FaultConfig(backoff_base_s=0.0))
        jrep, jtrc = reference_soaks[ladder]
        port = [s.as_dict() for s in trc.spans]
        ref = [s.as_dict() for s in jtrc.spans if s.name != "plan.trace"]
        if ladder == "interpret":
            # the reference's ladder starts on "interpret" and compiles a
            # second plan for its "ref" rung; the port's patched ladder
            # is "ref" twice, so that lookup hits the rung-0 plan
            ref = [json.loads(json.dumps(d).replace("interpret", "ref"))
                   for d in ref]
            for d in port + ref:
                if d["name"] in ("plan.compile", "plan.hit") \
                        and d["attrs"]["cache"] == "serving":
                    d["name"] = "plan.lookup"
        assert collections.Counter(d["name"] for d in port) == \
            collections.Counter(d["name"] for d in ref)
        assert [_event(d) for d in port] == [_event(d) for d in ref]
        assert trc.count("launch") == rep.launches == torch_chaos.ONE_RUNG[
            "launches"]
        assert [pm["track"] for pm in rep.postmortems] == \
            [pm["track"].replace("|interpret|", "|ref|")
             for pm in jrep.postmortems]

    def test_soak_zero_lost_and_deterministic(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        a = faults.run_chaos_soak(seed=1, n_requests=32, device="cpu")
        b = faults.run_chaos_soak(seed=1, n_requests=32, device="cpu")
        assert a.lost == 0 and a.mismatches == 0
        assert a.counters() == b.counters()
        assert a.rejected_at_submit == a.malformed > 0
        assert a.launch_failures > 0 and a.q_fallbacks == 1
        assert a.resolved + a.failed_requests == a.requests

    def test_soak_seeds_differ(self):
        a = faults.run_chaos_soak(seed=1, n_requests=32, device="cpu")
        b = faults.run_chaos_soak(seed=2, n_requests=32, device="cpu")
        assert a.lost == b.lost == 0
        assert a.counters() != b.counters()

    def test_roles_are_pure_function_of_seed_and_ticket(self):
        rates = dict(flaky_rate=0.2, backend_rate=0.2, corrupt_rate=0.2,
                     poison_rate=0.2)
        i1 = faults.FaultInjector(seed=9, **rates)
        i2 = faults.FaultInjector(seed=9, **rates)
        roles = [i1.role(t) for t in range(200)]
        assert roles == [i2.role(t) for t in range(200)]
        assert len({r for r in roles if r}) == 4   # all roles drawn
        # the JAX package's draw, ticket for ticket
        ref = jfaults.FaultInjector(seed=9, **rates)
        assert roles == [ref.role(t) for t in range(200)]
        assert faults.ROLES == jfaults.ROLES

    def test_mixed_lane_workload_shape(self):
        triples = workload.mixed_lane_workload(3, 40, q_fraction=0.5)
        assert len(triples) == 40
        q = [t for t in triples if t[2] is not None]
        assert 0 < len(q) < 40
        assert all(not c.is_projective for c, _, f in q)

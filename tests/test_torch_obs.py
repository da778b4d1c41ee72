"""The port's observability layer against the JAX package's: the
span-tree tracer, the typed metrics registry and its ``StatsView``,
Chrome-trace / Prometheus export, the flight recorder, the SLO burn-rate
monitor, per-server counter isolation, and the engine's span trees under
seeded fault injection (every ticket's tree accounts for its outcome,
and the ``launch`` instant count equals ``stats["launches"]``).

Mirrors ``tests/test_obs.py`` and ``tests/test_slo.py`` case by case on
the port (``repro_torch.obs`` is a copy of ``repro.obs``' jax-free
modules), and holds the copies' exports byte for byte to the
reference's on the same script.
"""
import json
import math

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.serving.clock import VirtualClock as JVirtualClock  # noqa: E402
from repro_torch import obs, serving  # noqa: E402
from repro_torch.core import transform_chain as tc  # noqa: E402
from repro_torch.obs.slo import (DEFAULT_RULES, LATENCY, REJECTIONS,  # noqa: E402
                                 BurnRule, SLOMonitor)
from repro_torch.serving import engine, faults  # noqa: E402
from repro_torch.serving.async_engine import (AsyncGeometryServer,  # noqa: E402
                                              SLOConfig)
from repro_torch.serving.clock import VirtualClock  # noqa: E402

RNG = np.random.default_rng(80)


def _fresh(**kw):
    serving.reset_stats()
    serving.clear_plan_cache()
    return serving.GeometryServer(device="cpu", **kw)


def _cfg(**kw):
    kw.setdefault("backoff_base_s", 0.0)
    return engine.FaultConfig(**kw)


def _chain2():
    return tc.TransformChain.identity(2).translate(0.5, -0.25).scale(1.5)


def _pts(n=8, dim=2):
    return RNG.uniform(-1, 1, (n, dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

class TestTracer:
    def test_begin_end_nest_and_stack(self):
        clk = VirtualClock()
        trc = obs.Tracer(clock=clk)
        a = trc.begin("outer")
        clk.advance(1.0)
        b = trc.begin("inner", ticket=7)
        clk.advance(0.5)
        trc.end(b)
        trc.end(a)
        outer, inner = trc.spans[0], trc.spans[1]
        assert outer.name == "outer" and outer.t0 == 0.0 and outer.t1 == 1.5
        assert inner.parent == outer.sid and inner.duration == 0.5
        assert inner.ticket == 7

    def test_end_merges_attrs_and_late_ticket(self):
        trc = obs.Tracer(clock=VirtualClock())
        sid = trc.begin("s", a=1)
        trc.end(sid, ticket=3, b=2)
        (s,) = trc.spans
        assert s.ticket == 3 and s.attrs == {"a": 1, "b": 2}

    def test_instant_and_complete(self):
        trc = obs.Tracer(clock=VirtualClock(start=2.0))
        trc.instant("mark", ticket=1, k="v")
        trc.complete("retro", 0.25, 0.75, ticket=1)
        mark, retro = trc.spans
        assert mark.instant and mark.t0 == 2.0
        assert not retro.instant and (retro.t0, retro.t1) == (0.25, 0.75)
        assert trc.n_events == 2 and trc.n_spans == 1

    def test_span_contextmanager_closes_on_error(self):
        trc = obs.Tracer(clock=VirtualClock())
        with pytest.raises(RuntimeError):
            with trc.span("work", ticket=5):
                raise RuntimeError("boom")
        (s,) = trc.spans
        assert s.t1 is not None and s.ticket == 5

    def test_span_tree_reconstructs_per_ticket(self):
        trc = obs.Tracer(clock=VirtualClock())
        a = trc.begin("shared")              # untagged: drops out of trees
        b = trc.begin("request.validate", ticket=1)
        trc.end(b)
        c = trc.begin("bucket", tickets=(1, 2))
        trc.instant("launch", tickets=(1, 2))
        trc.end(c)
        trc.end(a)
        roots = trc.span_tree(1)
        names = [n.name for n in roots]
        assert names == ["request.validate", "bucket"]
        # the launch instant re-nests under the bucket span, not the
        # uncollected "shared" ancestor
        assert [ch.name for ch in roots[1].children] == ["launch"]
        assert trc.span_tree(3) == []

    def test_install_and_restore(self):
        trc = obs.Tracer(clock=VirtualClock())
        assert not obs.active().enabled
        with obs.installed(trc):
            assert obs.active() is trc
            inner = obs.Tracer(clock=VirtualClock())
            with obs.installed(inner):
                assert obs.active() is inner
            assert obs.active() is trc
        assert not obs.active().enabled

    def test_null_tracer_is_inert(self):
        n = obs.NullTracer()
        assert not n.enabled and n.spans == ()
        sid = n.begin("x")
        n.end(sid)
        n.instant("y")
        with n.span("z"):
            pass
        assert n.spans == ()


# ---------------------------------------------------------------------------
# metrics registry + back-compat views
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_counter_gauge_histogram(self):
        reg = obs.MetricsRegistry("t")
        c = reg.counter("hits")
        c.inc()
        c.inc(4)
        g = reg.gauge("depth")
        g.track_max(3)
        g.track_max(1)
        h = reg.histogram("lat")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
        assert reg.value("hits") == 5 and reg.value("depth") == 3
        assert h.count == 4 and h.sum == 10.0 and h.max == 4.0
        assert h.percentile(50) == 2.0

    def test_labels_fan_out(self):
        reg = obs.MetricsRegistry()
        fam = reg.counter("req", labels=("tenant",))
        fam.labels(tenant="a").inc(2)
        fam.labels(tenant="b").inc()
        assert reg.value("req", tenant="a") == 2
        assert reg.value("req", tenant="b") == 1
        with pytest.raises(ValueError):
            fam.labels(nope="x")

    def test_redeclare_must_be_consistent(self):
        reg = obs.MetricsRegistry()
        reg.counter("n")
        assert reg.counter("n") is not None    # same family: fine
        with pytest.raises(ValueError):
            reg.gauge("n")

    def test_reset_zeroes_in_place(self):
        reg = obs.MetricsRegistry()
        c = reg.counter("n")
        c.inc(9)
        reg.reset()
        assert c.value == 0 and reg.counter("n") is c

    def test_stats_view_is_a_mutable_mapping(self):
        reg = obs.MetricsRegistry()
        view = obs.StatsView(reg, ("a", "b"))
        view["a"] += 2
        view["b"] = 5
        assert dict(view) == {"a": 2, "b": 5}
        assert view == {"a": 2, "b": 5} and len(view) == 2
        assert sorted(view) == ["a", "b"]
        with pytest.raises(KeyError):
            view["nope"] = 1

    def test_percentile_reexported_by_clock(self):
        from repro_torch.serving.clock import percentile
        assert percentile is obs.percentile
        assert percentile([3.0, 1.0, 2.0], 50) == 2.0

    def test_percentile_empty_is_nan(self):
        assert math.isnan(obs.percentile([], 50))
        assert math.isnan(obs.percentile([], 0))
        assert math.isnan(obs.percentile([], 100))

    def test_percentile_single_sample_is_that_sample(self):
        for q in (0, 1, 50, 99, 100):
            assert obs.percentile([7.0], q) == 7.0

    def test_percentile_all_equal(self):
        for q in (0, 50, 99, 100):
            assert obs.percentile([3.0] * 5, q) == 3.0

    def test_percentile_nearest_rank_ties(self):
        # nearest rank is exact set membership: p50 of an even-length
        # sample is the LOWER middle element (rank ceil(0.5*4) = 2),
        # and p99 of any sample shorter than 100 is its maximum
        assert obs.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0
        assert obs.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
        assert obs.percentile([1.0, 2.0, 3.0, 4.0], 99) == 4.0
        assert obs.percentile(range(1, 101), 99) == 99
        assert obs.percentile(range(1, 101), 50) == 50
        # duplicated median: ties collapse to the shared value
        assert obs.percentile([1.0, 2.0, 2.0, 9.0], 50) == 2.0
        with pytest.raises(ValueError):
            obs.percentile([1.0], 101)
        with pytest.raises(ValueError):
            obs.percentile([1.0], -1)

    def test_histogram_edge_cases(self):
        h = obs.Histogram()
        # empty: count/sum/max well-defined, quantile nan, buckets zero
        assert h.count == 0 and h.sum == 0.0 and h.max == 0.0
        assert math.isnan(h.percentile(99))
        assert h.bucket_counts() == [0] * len(obs.Histogram.BOUNDS)
        # single sample sits in every bucket at or above its bound
        h.observe(0.01)
        assert h.percentile(50) == 0.01 and h.percentile(99) == 0.01
        assert h.bucket_counts((0.005, 0.01, 0.05)) == [0, 1, 1]
        # all-equal: every quantile is the shared value
        h2 = obs.Histogram()
        for _ in range(8):
            h2.observe(2.0)
        assert h2.percentile(50) == 2.0 == h2.percentile(99)
        assert h2.count == 8 and h2.sum == 16.0 and h2.max == 2.0


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

class TestExport:
    def _tracer(self):
        clk = VirtualClock()
        trc = obs.Tracer(clock=clk)
        sid = trc.begin("flush")
        b = trc.begin("bucket.assemble", track="2D:TS|ref|<f4|8",
                      tickets=(0, 1))
        clk.advance(0.001)
        trc.instant("launch", track="2D:TS|ref|<f4|8", rows=2)
        trc.end(b)
        trc.end(sid)
        return trc

    def test_chrome_events_shape(self):
        evs = obs.chrome_trace_events(self._tracer())
        meta = [e for e in evs if e["ph"] == "M"]
        assert [m["args"]["name"] for m in meta] == \
            ["serve", "2D:TS|ref|<f4|8"]     # first-seen track order
        x = [e for e in evs if e["ph"] == "X"]
        i = [e for e in evs if e["ph"] == "i"]
        assert len(x) == 2 and len(i) == 1 and i[0]["s"] == "t"
        assert x[0]["tid"] == 0 and x[1]["tid"] == 1

    def test_dump_is_byte_deterministic(self, tmp_path):
        p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
        obs.dump_chrome_trace(self._tracer(), str(p1))
        obs.dump_chrome_trace(self._tracer(), str(p2))
        assert p1.read_bytes() == p2.read_bytes()
        doc = json.loads(p1.read_text())
        assert doc["displayTimeUnit"] == "ms"

    def test_prometheus_text_sorted_and_typed(self):
        reg = obs.MetricsRegistry("srv")
        reg.counter("zeta").inc(2)
        reg.counter("alpha", help="first").inc()
        fam = reg.counter("by_tenant", labels=("tenant",))
        fam.labels(tenant="b").inc()
        fam.labels(tenant="a").inc(3)
        h = reg.histogram("lat")
        h.observe(0.5)
        text = obs.prometheus_text(reg)
        lines = text.splitlines()
        assert "# HELP srv_alpha first" in lines
        assert lines.index("# TYPE srv_alpha counter") < \
            lines.index("# TYPE srv_zeta counter")
        # label children sort by value; histograms render as cumulative
        # bucket series
        ia = lines.index('srv_by_tenant{tenant="a"} 3')
        ib = lines.index('srv_by_tenant{tenant="b"} 1')
        assert ia < ib
        assert "# TYPE srv_lat histogram" in lines
        assert 'srv_lat_bucket{le="0.25"} 0' in lines
        assert 'srv_lat_bucket{le="0.5"} 1' in lines      # 0.5 <= 0.5
        assert 'srv_lat_bucket{le="2.5"} 1' in lines
        assert 'srv_lat_bucket{le="+Inf"} 1' in lines
        assert "srv_lat_sum 0.5" in lines
        assert "srv_lat_count 1" in lines
        # bucket lines are cumulative and ordered bound-ascending
        bucket_vals = [int(ln.rsplit(" ", 1)[1]) for ln in lines
                       if ln.startswith("srv_lat_bucket")]
        assert bucket_vals == sorted(bucket_vals)
        assert obs.prometheus_text(reg) == text    # deterministic


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class TestFlightRecorder:
    def test_bounded_window(self):
        rec = obs.FlightRecorder(capacity=4)
        trc = obs.Tracer(clock=VirtualClock(), recorder=rec)
        for k in range(10):
            trc.instant("e", k=k)
        assert len(rec) == 4 and rec.recorded == 10 and rec.dropped == 6
        snap = rec.snapshot()
        assert [e["attrs"]["k"] for e in snap] == [6, 7, 8, 9]
        rec.clear()
        assert len(rec) == 0 and rec.recorded == 0

    def test_capacity_validates(self):
        with pytest.raises(ValueError):
            obs.FlightRecorder(capacity=0)


# ---------------------------------------------------------------------------
# engine tracing: span trees, exact launch accounting, zero steering
# ---------------------------------------------------------------------------

class TestEngineTracing:
    def test_launch_instants_equal_launch_counter(self):
        srv = _fresh(backend="ref")
        trc = obs.Tracer(clock=VirtualClock())
        with obs.installed(trc):
            for _ in range(6):
                srv.submit(_chain2(), _pts(int(RNG.integers(4, 24))))
            srv.submit(tc.TransformChain.identity(2), _pts(5))
            srv.flush()
        assert trc.count("launch") == serving.stats["launches"] > 0
        assert trc.count("request.resolve") == 7

    def test_every_ticket_tree_complete_on_success(self):
        srv = _fresh(backend="ref")
        trc = obs.Tracer(clock=VirtualClock())
        with obs.installed(trc):
            tickets = [srv.submit(_chain2(), _pts(8)) for _ in range(4)]
            tickets.append(srv.submit(tc.TransformChain.identity(2),
                                      _pts(3)))
            srv.flush()
        for t in tickets:
            names = [s.name for root in trc.span_tree(t)
                     for s in root.walk()]
            assert "request.validate" in names
            assert "request.resolve" in names

    def test_rejection_tree(self):
        srv = _fresh(backend="ref")
        trc = obs.Tracer(clock=VirtualClock())
        with obs.installed(trc):
            with pytest.raises(serving.RequestError):
                srv.submit(_chain2(), np.zeros((0, 2), np.float32))
        (s,) = trc.spans_for(trc.tickets_seen()[0])
        assert s.name == "request.validate"
        assert s.attrs["outcome"] == "rejected"
        assert s.attrs["code"] == "empty"

    def test_tracing_never_steers_the_counters(self):
        # identical seeded workload, untraced vs traced: every counter
        # bit-identical (instrumentation observes, never steers)
        def serve():
            srv = _fresh(backend="ref")
            rng = np.random.default_rng(7)
            for _ in range(12):
                n = int(rng.integers(2, 40))
                pts = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
                srv.submit(_chain2(), pts)
            srv.flush()
            return dict(serving.stats)

        untraced = serve()
        trc = obs.Tracer(clock=VirtualClock())
        with obs.installed(trc):
            traced = serve()
        assert untraced == traced
        assert trc.n_events > 0

    def test_bucket_tracks_and_labeled_dimensions(self):
        srv = _fresh(backend="ref")
        trc = obs.Tracer(clock=VirtualClock())
        with obs.installed(trc):
            srv.submit(_chain2(), _pts(8))
            srv.flush()
        tracks = {s.track for s in trc.spans if s.track}
        assert len(tracks) == 1
        track = tracks.pop()
        assert "ref" in track                 # structure|backend|dtype|lpad
        # the per-server labeled counter saw the bucket's rows
        kind, backend, dt, lpad = None, "ref", None, None
        for s in trc.spans:
            if s.name == "bucket.assemble":
                kind = s.attrs["kind"]
                lpad = str(s.attrs["lpad"])
        dt = track.split("|")[2]
        assert srv.metrics.value("bucket_requests", kind=kind,
                                 backend=backend, dtype=dt,
                                 size_class=lpad) == 1


class TestSpanTreesUnderFaults:
    def _traced_faulty(self, inj, n=6, **srv_kw):
        srv = _fresh(backend="ref", fault_config=_cfg(max_launch_attempts=2),
                     injector=inj, **srv_kw)
        rec = obs.FlightRecorder(capacity=128)
        trc = obs.Tracer(clock=VirtualClock(), recorder=rec)
        with obs.installed(trc):
            tickets = [srv.submit(_chain2(), _pts(8)) for _ in range(n)]
            results = srv.flush()
        return srv, trc, tickets, results

    def test_recovery_tree_for_flaky_ticket(self):
        inj = faults.FaultInjector(flaky_tickets=frozenset({0}),
                                   flaky_attempts=1)
        srv, trc, tickets, results = self._traced_faulty(inj)
        names = [s.name for root in trc.span_tree(0)
                 for s in root.walk()]
        assert "recover" in names and "request.resolve" in names
        rec_spans = [s for s in trc.spans_for(0) if s.name == "recover"]
        assert rec_spans[0].attrs["outcome"] == "recovered"
        assert str(rec_spans[0].track).startswith("recovery:")
        assert trc.count("launch") == serving.stats["launches"]

    def test_bisection_and_terminal_failure_trees(self):
        inj = faults.FaultInjector(poison_tickets=frozenset({2}))
        srv, trc, tickets, results = self._traced_faulty(inj)
        assert trc.count("recover.bisect") == serving.stats["bisections"] > 0
        # the poisoned ticket: recover spans + a launch-error resolve
        res = [s for s in trc.spans_for(2) if s.name == "request.resolve"]
        assert len(res) == 1 and res[0].attrs["outcome"] == "launch-error"
        assert isinstance(results[2], serving.LaunchError)
        # its terminal error carries the flight-recorder window
        assert isinstance(results[2].flight, list) and results[2].flight
        assert all("name" in e for e in results[2].flight)
        # the bucket neighbours all recovered, each with a complete tree
        for t in [t for t in tickets if t != 2]:
            outs = [s.attrs["outcome"] for s in trc.spans_for(t)
                    if s.name == "request.resolve"]
            assert outs == ["ok"]
        assert trc.count("launch") == serving.stats["launches"]

    def test_every_ticket_accounted_under_mixed_faults(self):
        inj = faults.FaultInjector(flaky_tickets=frozenset({0}),
                                   backend_tickets=frozenset({1}),
                                   corrupt_tickets=frozenset({3}),
                                   poison_tickets=frozenset({4}),
                                   flaky_attempts=1)
        srv, trc, tickets, results = self._traced_faulty(inj, n=8)
        for t in tickets:
            spans = trc.spans_for(t)
            assert any(s.name == "request.validate"
                       and s.attrs["outcome"] == "admitted" for s in spans)
            resolves = [s for s in spans if s.name == "request.resolve"]
            assert len(resolves) == 1, f"ticket {t} must resolve exactly once"
            assert resolves[0].attrs["outcome"] in ("ok", "launch-error")
        assert trc.count("launch") == serving.stats["launches"]
        # the poisoned ticket is terminally failed; the corrupted one may
        # also fail after bisection isolates it -- both resolve exactly
        # once (asserted above), which is the invariant under test
        assert serving.stats["failed_requests"] >= 1
        assert isinstance(results[4], serving.LaunchError)


# ---------------------------------------------------------------------------
# per-server counters vs the module aggregate (the multi-server drift fix)
# ---------------------------------------------------------------------------

class TestPerServerCounters:
    def test_two_servers_do_not_blur(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        a = serving.GeometryServer(device="cpu")
        b = serving.GeometryServer(device="cpu")
        for _ in range(3):
            a.submit(_chain2(), _pts(8))
        for _ in range(5):
            b.submit(_chain2(), _pts(8))
        a.flush()
        b.flush()
        assert a.metrics.value("requests") == 3
        assert b.metrics.value("requests") == 5
        assert a.metrics.value("launches") == 1
        assert b.metrics.value("launches") == 1
        # the module view is the explicit aggregate across servers
        assert serving.stats["requests"] == 8
        assert serving.stats["launches"] == \
            a.metrics.value("launches") + b.metrics.value("launches")

    def test_reset_stats_clears_server_registry(self):
        srv = _fresh(backend="ref")
        srv.submit(_chain2(), _pts(4))
        srv.flush()
        assert srv.metrics.value("requests") == 1
        srv.reset_stats()
        assert srv.metrics.value("requests") == 0

    def test_two_async_engines_mirror_rejections_by_delta(self):
        # the old absolute mirror clobbered the module counters when two
        # engines served side by side; deltas must sum
        serving.reset_stats()
        serving.clear_plan_cache()
        clock = VirtualClock()
        cfg = serving.AdmissionConfig(max_queue_depth=1, tenant_share=1.0)
        e1 = AsyncGeometryServer(device="cpu", clock=clock,
                                 admission=cfg)
        e2 = AsyncGeometryServer(device="cpu", clock=clock,
                                 admission=cfg)
        for eng_ in (e1, e2):
            eng_.submit_async(_chain2(), _pts(4))
            for _ in range(2):
                with pytest.raises(serving.QueueFullError):
                    eng_.submit_async(_chain2(), _pts(4))
        assert e1.stats["queue_full_rejections"] == 2
        assert e2.stats["queue_full_rejections"] == 2
        assert serving.stats["queue_full_rejections"] == 4
        e1.drain()
        e2.drain()


# ---------------------------------------------------------------------------
# async front-end tracing
# ---------------------------------------------------------------------------

class TestAsyncTracing:
    def test_queue_wait_and_policy_spans(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        clock = VirtualClock()
        eng_ = AsyncGeometryServer(
            device="cpu", clock=clock,
            slo=SLOConfig(max_wait_s=0.01, target_rows=4))
        trc = obs.Tracer(clock=clock)
        with obs.installed(trc):
            t = eng_.submit_async(_chain2(), _pts(6), tenant="a")
            due = eng_.next_due_in()
            clock.advance(due)
            eng_.poll()
        assert t.done()
        waits = [s for s in trc.spans if s.name == "queue.wait"]
        assert len(waits) == 1 and waits[0].ticket == t.id
        assert waits[0].duration == pytest.approx(due)
        assert 0.0 < waits[0].duration <= 0.01
        pol = [s for s in trc.spans if s.name == "policy.launch"]
        assert len(pol) == 1 and pol[0].attrs["reason"] == "deadline"
        subs = [s for s in trc.spans if s.name == "request.submit"]
        assert subs[0].attrs["outcome"] == "admitted"
        assert subs[0].ticket == t.id

    def test_fill_reason_and_admission_reject_instant(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        clock = VirtualClock()
        eng_ = AsyncGeometryServer(
            device="cpu", clock=clock,
            slo=SLOConfig(max_wait_s=1.0, target_rows=2),
            admission=serving.AdmissionConfig(max_queue_depth=2,
                                              tenant_share=1.0))
        trc = obs.Tracer(clock=clock)
        with obs.installed(trc):
            eng_.submit_async(_chain2(), _pts(4))
            eng_.submit_async(_chain2(), _pts(4))
            with pytest.raises(serving.QueueFullError):
                eng_.submit_async(_chain2(), _pts(4))
            eng_.poll()                      # full bucket: due immediately
        pol = [s for s in trc.spans if s.name == "policy.launch"]
        assert [s.attrs["reason"] for s in pol] == ["fill"]
        rej = [s for s in trc.spans if s.name == "admission.reject"]
        assert len(rej) == 1 and rej[0].attrs["code"] == "queue-full"
        assert rej[0].attrs["gate"] == "depth"

    def test_registry_backed_stats_view_unchanged(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        clock = VirtualClock()
        eng_ = AsyncGeometryServer(device="cpu", clock=clock)
        t = eng_.submit_async(_chain2(), _pts(4), tenant="r")
        eng_.drain()
        st = eng_.stats
        assert st["admitted"] == 1 and st["resolved"] == 1
        assert st["failed"] == 0 and st["queue_depth"] == 0
        assert st["p50_latency_s"] == st["p99_latency_s"] >= 0.0
        assert eng_.metrics.value("tenant_requests", tenant="r") == 1
        assert not serving.is_error(t.result())


# ---------------------------------------------------------------------------
# chaos soak post-mortems
# ---------------------------------------------------------------------------

class TestChaosPostmortems:
    def test_soak_attaches_postmortems(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        rep = faults.run_chaos_soak(seed=3, n_requests=48,
                                     device="cpu")
        assert rep.lost == 0
        assert rep.postmortems, "faults fired, so post-mortems must exist"
        for pm in rep.postmortems:
            assert str(pm["track"]).startswith("recovery")
            assert pm["events"] and all("name" in e for e in pm["events"])
        json.dumps(rep.postmortems)           # plain-JSON by construction
        assert "postmortems" not in rep.counters()

    def test_soak_is_deterministic_with_postmortems(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        r1 = faults.run_chaos_soak(seed=5, n_requests=32, device="cpu")
        serving.reset_stats()
        serving.clear_plan_cache()
        r2 = faults.run_chaos_soak(seed=5, n_requests=32, device="cpu")
        assert r1.counters() == r2.counters()
        assert [pm["track"] for pm in r1.postmortems] == \
            [pm["track"] for pm in r2.postmortems]


# ---------------------------------------------------------------------------
# the SLO burn-rate monitor
# ---------------------------------------------------------------------------

#: one second-scale rule so tests script whole-second event trains:
#: burn >= 2 on the trailing 10 s AND the trailing 2 s
RULE = BurnRule(long_s=10.0, short_s=2.0, threshold=2.0)


def _monitor(clock, **kw):
    kw.setdefault("latency_slo_s", 0.05)
    kw.setdefault("latency_target", 0.9)
    kw.setdefault("rejection_target", 0.9)
    kw.setdefault("rules", (RULE,))
    return SLOMonitor(clock, **kw)


class TestBurnRule:
    def test_validation(self):
        with pytest.raises(ValueError):
            BurnRule(long_s=1.0, short_s=2.0, threshold=1.0)
        with pytest.raises(ValueError):
            BurnRule(long_s=1.0, short_s=0.0, threshold=1.0)
        with pytest.raises(ValueError):
            BurnRule(long_s=2.0, short_s=1.0, threshold=0.0)
        assert DEFAULT_RULES[0].threshold == 14.4

    def test_monitor_validation(self):
        clk = VirtualClock()
        with pytest.raises(ValueError):
            SLOMonitor(clk, latency_slo_s=0.1, rules=())
        with pytest.raises(ValueError):
            SLOMonitor(clk, latency_slo_s=0.1, latency_target=1.0)


class TestPinnedAlertInstants:
    def _script(self, mon, clock):
        """good@1, bad@2, good@3..5: the canonical fire/resolve train."""
        for t, latency in ((1.0, 0.01), (2.0, 0.10), (3.0, 0.01),
                           (4.0, 0.01), (5.0, 0.01)):
            clock.advance_to(t)
            mon.observe_latency(latency)

    def test_latency_alert_fires_and_resolves_at_exact_instants(self):
        clock = VirtualClock()
        mon = _monitor(clock)
        self._script(mon, clock)
        alert = mon.alerts[LATENCY]
        # the bad event at t=2 put burn at 5.0 (>2) on both windows ->
        # fires AT that observation; the short window goes clean once
        # the t=2 event ages out of the trailing 2 s -> resolves at t=5
        assert alert.fired_at == [2.0]
        assert alert.resolved_at == [5.0]
        assert not alert.active and alert.fired == 1

    def test_counters_round_trip_instants_in_us(self):
        clock = VirtualClock()
        mon = _monitor(clock)
        self._script(mon, clock)
        c = mon.counters()
        assert c["latency_alerts_fired"] == 1
        assert c["latency_alert_active"] == 0
        assert c["latency_first_fire_us"] == 2_000_000.0
        assert c["latency_first_resolve_us"] == 5_000_000.0
        assert c["latency_bad_events"] == 1
        assert c["latency_events"] == 5
        assert c["rejections_events"] == 0

    def test_rerun_is_bit_identical(self):
        outs = []
        for _ in range(2):
            clock = VirtualClock()
            mon = _monitor(clock)
            self._script(mon, clock)
            outs.append((mon.counters(),
                         obs.prometheus_text(mon.metrics)))
        assert outs[0] == outs[1]

    def test_rejection_objective_fires(self):
        clock = VirtualClock()
        mon = _monitor(clock)
        clock.advance_to(1.0)
        mon.observe_admission()
        clock.advance_to(2.0)
        mon.observe_rejection()
        assert mon.alerts[REJECTIONS].fired_at == [2.0]
        assert mon.alerts[LATENCY].fired_at == []

    def test_single_bad_blip_after_healthy_history_does_not_page(self):
        # one bad event against a healthy long window: burn(long) stays
        # under threshold, so the multi-window rule does not page
        clock = VirtualClock()
        mon = _monitor(clock)
        for k in range(10):
            clock.advance_to(float(k + 1))
            mon.observe_latency(0.01)
        clock.advance_to(11.0)
        mon.observe_latency(0.10)      # 1 bad of 11 in the long window
        assert mon.alerts[LATENCY].fired_at == []
        assert mon.burn_rate(LATENCY, RULE.long_s) < RULE.threshold

    def test_window_trimming_bounds_memory(self):
        clock = VirtualClock()
        mon = _monitor(clock)
        for k in range(100):
            clock.advance_to(float(k))
            mon.observe_latency(0.01)
        # horizon is the longest window (10 s): old events are dropped
        assert len(mon._events[LATENCY]) <= 12
        assert mon.counters()["latency_events"] == 100

    def test_slo_instants_reach_the_tracer(self):
        clock = VirtualClock()
        trc = obs.Tracer(clock=clock)
        mon = _monitor(clock)
        with obs.installed(trc):
            self._script(mon, clock)
        fires = [s for s in trc.spans if s.name == "slo.fire"]
        resolves = [s for s in trc.spans if s.name == "slo.resolve"]
        assert len(fires) == 1 and fires[0].t0 == 2.0
        assert fires[0].attrs["objective"] == LATENCY
        assert len(resolves) == 1 and resolves[0].t0 == 5.0


class TestPrometheusExport:
    def test_alert_state_in_exposition(self):
        clock = VirtualClock()
        mon = _monitor(clock)
        clock.advance_to(1.0)
        mon.observe_latency(0.01)
        clock.advance_to(2.0)
        mon.observe_latency(0.10)          # fires
        text = obs.prometheus_text(mon.metrics)
        assert '# TYPE slo_alert_active gauge' in text
        assert 'slo_alert_active{objective="latency"} 1' in text
        assert 'slo_alerts_fired{objective="latency"} 1' in text
        assert 'slo_bad_events{objective="latency"} 1' in text
        assert 'slo_burn_rate{objective="latency",window="2s"} 5.0' \
            in text
        assert 'slo_burn_rate{objective="latency",window="10s"} 5.0' \
            in text


class TestAsyncWiring:
    def _engine(self, clock, mon, **kw):
        serving.reset_stats()
        serving.clear_plan_cache()
        return AsyncGeometryServer(
            device="cpu", clock=clock, slo_monitor=mon,
            slo=SLOConfig(max_wait_s=0.01, target_rows=4), **kw)

    def test_latency_and_admission_events_flow(self):
        clock = VirtualClock()
        mon = _monitor(clock, latency_slo_s=1.0)
        eng_ = self._engine(clock, mon)
        for _ in range(3):
            eng_.submit_async(_chain2(), _pts(6))
        eng_.drain()
        c = mon.counters()
        assert c["rejections_events"] == 3     # three admissions, no bad
        assert c["rejections_bad_events"] == 0
        assert c["latency_events"] == 3        # three resolutions
        assert mon.alerts[LATENCY].fired_at == []

    def test_rejections_feed_the_monitor(self):
        clock = VirtualClock()
        mon = _monitor(clock)
        eng_ = self._engine(
            clock, mon,
            admission=serving.AdmissionConfig(max_queue_depth=1,
                                              tenant_share=1.0))
        eng_.submit_async(_chain2(), _pts(4))
        with pytest.raises(serving.QueueFullError):
            eng_.submit_async(_chain2(), _pts(4))
        eng_.drain()
        c = mon.counters()
        assert c["rejections_events"] == 2
        assert c["rejections_bad_events"] == 1

    def test_default_is_unmonitored(self):
        serving.reset_stats()
        serving.clear_plan_cache()
        eng_ = AsyncGeometryServer(device="cpu", clock=VirtualClock())
        assert eng_.slo_monitor is None
        eng_.submit_async(_chain2(), _pts(4))
        eng_.drain()


# ---------------------------------------------------------------------------
# the copies against the JAX package's modules
# ---------------------------------------------------------------------------

def _scripted(o, clock_cls):
    """One tracer script and one registry, through ``o`` (either
    package's ``obs``)."""
    clk = clock_cls()
    trc = o.Tracer(clock=clk, recorder=o.FlightRecorder(4))
    sid = trc.begin("flush", requests=2)
    b = trc.begin("bucket.assemble", track="2D:TS|ref|<f4|8", tickets=(0, 1))
    clk.advance(0.001)
    trc.instant("launch", track="2D:TS|ref|<f4|8", rows=2)
    trc.complete("queue.wait", 0.0, 0.0005, ticket=1)
    trc.end(b, kind="diag")
    clk.advance(0.002)
    trc.end(sid)
    reg = o.MetricsRegistry("srv")
    reg.counter("launches", help="dispatched").inc(3)
    reg.counter("by_tenant", labels=("tenant",)).labels(tenant="a").inc(2)
    reg.gauge("depth").track_max(7)
    h = reg.histogram("lat")
    for v in (0.0004, 0.02, 0.3, 7.0):
        h.observe(v)
    return trc, reg


def test_exports_equal_the_reference_byte_for_byte(tmp_path):
    trc, reg = _scripted(obs, VirtualClock)
    jtrc, jreg = _scripted(jobs, JVirtualClock)
    assert obs.chrome_trace(trc) == jobs.chrome_trace(jtrc)
    obs.dump_chrome_trace(trc, str(tmp_path / "a.json"))
    jobs.dump_chrome_trace(jtrc, str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert obs.prometheus_text(reg) == jobs.prometheus_text(jreg)
    assert trc.recorder.snapshot() == jtrc.recorder.snapshot()
    for q in (0, 50, 99, 100):
        assert obs.percentile([3.0, 1.0, 2.0, 9.0], q) == \
            jobs.percentile([3.0, 1.0, 2.0, 9.0], q)


def test_slo_monitor_equals_the_reference():
    runs = []
    for mod, clock_cls in ((obs, VirtualClock), (jobs, JVirtualClock)):
        clock = clock_cls()
        mon = (SLOMonitor if mod is obs else jslo.SLOMonitor)(
            clock, latency_slo_s=0.05, latency_target=0.9,
            rejection_target=0.9,
            rules=((BurnRule if mod is obs else jslo.BurnRule)(
                long_s=10.0, short_s=2.0, threshold=2.0),))
        rng = np.random.default_rng(82)
        for k in range(200):
            clock.advance_to(k * 0.25)
            mon.observe_latency(float(rng.exponential(0.03)))
            if rng.random() < 0.2:
                mon.observe_rejection()
            else:
                mon.observe_admission()
        runs.append((mon.counters(), mod.prometheus_text(mon.metrics)))
    assert runs[0] == runs[1]
    assert runs[0][0]["latency_alerts_fired"] > 0


def test_profile_names_are_not_ported_yet():
    """The names that raised ``NotPortedError`` until the autotune slice
    now resolve to ``obs.profile``'s (the profiler's own tests are
    ``tests/test_torch_profile.py``)."""
    from repro_torch.obs import profile
    for name in ("Profile", "LaunchGroup", "ProfileNode",
                 "dump_span_stream", "load_span_stream"):
        assert getattr(obs, name) is getattr(profile, name)
        assert name in obs.__all__
    with pytest.raises(AttributeError):
        obs.nope
    assert obs.SLOMonitor is SLOMonitor


def test_module_registry_is_the_stats_view():
    srv = _fresh()
    srv.submit(_chain2(), _pts(4))
    srv.flush()
    assert engine.REGISTRY.value("launches") == serving.stats["launches"] \
        == srv.metrics.value("launches") == 1
    text = obs.prometheus_text(engine.REGISTRY)
    assert "serving_launches 1" in text.splitlines()

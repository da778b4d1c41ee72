"""The port's deterministic scheduler against the JAX package's:
VirtualClock semantics, the shared nearest-rank percentile, the
deadline-times-fill flush policy pinned against hand-computed instants,
per-tenant fairness under starvation, typed backpressure rejection
codes, and p50/p99 latency telemetry on a fixed arrival script.

Mirrors ``tests/test_clock.py`` case by case; everything is exact (``==``
on floats) because the clock is virtual.  The parity cases run one
seeded arrival script through both packages' ``AsyncGeometryServer``:
admission decisions, the flush order and the virtual p50/p99 are equal.
"""
import math

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.core import transform_chain as jtc  # noqa: E402
from repro.serving import async_engine as jasync  # noqa: E402
from repro.serving import clock as jclock  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.admission import (AdmissionConfig,  # noqa: E402
                                           AdmissionController,
                                           QueueFullError, RateLimitError,
                                           TokenBucket)
from repro_torch.serving.async_engine import (AsyncGeometryServer,  # noqa: E402
                                              SLOConfig)
from repro_torch.serving.clock import (MonotonicClock,  # noqa: E402
                                       VirtualClock, percentile)


def _fresh_async(**kw):
    serving.reset_stats()
    serving.clear_plan_cache()
    kw.setdefault("clock", VirtualClock())
    return AsyncGeometryServer(device="cpu", **kw)


def _pts(rng, n, dim):
    return rng.uniform(-1, 1, (n, dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

def test_virtual_clock_advances_only_on_request():
    clk = VirtualClock()
    assert clk.now() == 0.0
    assert clk.advance(1.5) == 1.5
    assert clk.now() == 1.5
    clk.sleep(0.5)
    assert clk.now() == 2.0
    clk.sleep(0.0)                      # no-op, not an error
    assert clk.now() == 2.0


def test_virtual_clock_never_rewinds():
    clk = VirtualClock(start=10.0)
    with pytest.raises(ValueError):
        clk.advance(-0.1)
    assert clk.advance_to(3.0) == 10.0   # past instants are a no-op
    assert clk.advance_to(12.5) == 12.5


def test_monotonic_clock_is_monotone():
    clk = MonotonicClock()
    a = clk.now()
    clk.sleep(0.001)
    assert clk.now() >= a


# ---------------------------------------------------------------------------
# the shared percentile definition (nearest rank)
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank_pinned():
    xs = [4, 1, 3, 2]                   # order must not matter
    assert percentile(xs, 0) == 1
    assert percentile(xs, 25) == 1
    assert percentile(xs, 50) == 2
    assert percentile(xs, 75) == 3
    assert percentile(xs, 99) == 4
    assert percentile(xs, 100) == 4
    assert percentile([7.0], 50) == 7.0


def test_percentile_edge_cases():
    assert math.isnan(percentile([], 50))
    with pytest.raises(ValueError):
        percentile([1], 101)
    with pytest.raises(ValueError):
        percentile([1], -1)


# ---------------------------------------------------------------------------
# the deadline-times-fill flush policy, pinned
# ---------------------------------------------------------------------------

def test_deadline_shrinks_with_fill():
    """due_in = max_wait * (1 - fill) - age, hand-computed per submit."""
    rng = np.random.default_rng(0)
    chain = workload.chain_for(rng, 2, "TST")
    eng = _fresh_async(backend="ref",
                       slo=SLOConfig(max_wait_s=0.01, target_rows=4))
    eng.submit_async(chain, _pts(rng, 3, 2))
    assert eng.next_due_in() == pytest.approx(0.0075)   # fill 1/4
    eng.submit_async(chain, _pts(rng, 3, 2))
    assert eng.next_due_in() == pytest.approx(0.005)    # fill 2/4
    eng.submit_async(chain, _pts(rng, 3, 2))
    assert eng.next_due_in() == pytest.approx(0.0025)   # fill 3/4
    eng.submit_async(chain, _pts(rng, 3, 2))
    assert eng.next_due_in() == 0.0                     # full: due NOW
    assert eng.poll() == 4


def test_deadline_expiry_flushes_partial_bucket():
    rng = np.random.default_rng(1)
    chain = workload.chain_for(rng, 2, "TST")
    clk = VirtualClock()
    eng = _fresh_async(backend="ref", clock=clk,
                       slo=SLOConfig(max_wait_s=0.01, target_rows=4))
    t = eng.submit_async(chain, _pts(rng, 3, 2))
    clk.advance(0.0074)
    assert eng.poll() == 0              # 0.1 ms early: not due yet
    clk.advance(0.0001)
    assert eng.poll() == 1              # deadline 0.0075 reached
    assert t.latency == pytest.approx(0.0075)


def test_deadline_expiry_flush_ordering():
    """Two groups past deadline in one poll: the one whose oldest
    request has waited longest launches first (visible in the flush's
    bucket report order)."""
    rng = np.random.default_rng(2)
    late = workload.chain_for(rng, 2, "TST")     # submitted first
    fresh = workload.chain_for(rng, 3, "TRS")    # submitted second
    clk = VirtualClock()
    eng = _fresh_async(backend="ref", clock=clk,
                       slo=SLOConfig(max_wait_s=0.01, target_rows=4))
    eng.submit_async(late, _pts(rng, 3, 2))
    clk.advance(0.002)
    eng.submit_async(fresh, _pts(rng, 3, 3))
    clk.advance(0.008)                  # both deadlines have passed
    assert eng.poll() == 2
    structures = [r.structure for r in eng.server.last_report]
    assert structures == ["2D:TST", "3D:TRS"]

    # and in the mirror order when arrival order flips
    eng2 = _fresh_async(backend="ref", clock=VirtualClock(),
                        slo=SLOConfig(max_wait_s=0.01, target_rows=4))
    eng2.submit_async(fresh, _pts(rng, 3, 3))
    eng2.clock.advance(0.002)
    eng2.submit_async(late, _pts(rng, 3, 2))
    eng2.clock.advance(0.008)
    assert eng2.poll() == 2
    assert [r.structure for r in eng2.server.last_report] \
        == ["3D:TRS", "2D:TST"]


def test_poll_leaves_undue_groups_queued():
    rng = np.random.default_rng(3)
    a = workload.chain_for(rng, 2, "TST")
    b = workload.chain_for(rng, 3, "TRS")
    clk = VirtualClock()
    eng = _fresh_async(backend="ref", clock=clk,
                       slo=SLOConfig(max_wait_s=0.01, target_rows=4))
    eng.submit_async(a, _pts(rng, 3, 2))
    clk.advance(0.005)
    tb = eng.submit_async(b, _pts(rng, 3, 3))
    clk.advance(0.0025)                 # a's deadline (0.0075) fires
    assert eng.poll() == 1
    assert not tb.done()
    assert eng.stats["waiting_groups"] == 1
    assert eng.next_due_in() == pytest.approx(0.005)   # b due at 0.0125


# ---------------------------------------------------------------------------
# admission: fairness, backpressure, and typed rejection codes
# ---------------------------------------------------------------------------

def test_tenant_fair_share_prevents_starvation():
    """A flooding tenant saturates ITS share while a light tenant still
    admits -- then the global bound closes the queue for everyone."""
    clk = VirtualClock()
    ctrl = AdmissionController(
        AdmissionConfig(max_queue_depth=8, tenant_share=0.5), clk)
    admitted_heavy = 0
    for _ in range(10):                  # heavy tenant floods
        try:
            ctrl.admit("heavy")
            admitted_heavy += 1
        except QueueFullError:
            pass
    assert admitted_heavy == 4           # ceil(8 * 0.5)
    for _ in range(4):                   # light tenant is NOT starved
        ctrl.admit("light")
    with pytest.raises(QueueFullError):  # now the queue itself is full
        ctrl.admit("light")
    assert ctrl.queue_full_rejections == 7
    # releases reopen the gate (for a tenant still under its own cap)
    ctrl.release("light")
    ctrl.admit("light")
    assert ctrl.depth == 8


def test_rejection_codes_are_stable_and_typed():
    rng = np.random.default_rng(4)
    chain = workload.chain_for(rng, 2, "TST")
    eng = _fresh_async(
        backend="ref",
        admission=AdmissionConfig(max_queue_depth=2, tenant_share=1.0))
    eng.submit_async(chain, _pts(rng, 2, 2))
    eng.submit_async(chain, _pts(rng, 2, 2))
    with pytest.raises(QueueFullError) as exc:
        eng.submit_async(chain, _pts(rng, 2, 2))
    assert exc.value.code == "queue-full"
    assert isinstance(exc.value, serving.RequestError)
    assert eng.stats["queue_full_rejections"] == 1
    assert serving.stats["queue_full_rejections"] == 1
    eng.drain()                          # frees the queue
    eng.submit_async(chain, _pts(rng, 2, 2))


def test_token_bucket_refills_in_clock_time():
    b = TokenBucket(rate=100.0, burst=2.0)
    assert b.take(0.0) and b.take(0.0)
    assert not b.take(0.0)               # burst exhausted
    assert b.next_admissible_in(0.0) == pytest.approx(0.01)
    assert b.take(0.01)                  # one token refilled
    assert not b.take(0.01)


def test_rate_limited_engine_rejects_with_typed_error():
    rng = np.random.default_rng(5)
    chain = workload.chain_for(rng, 2, "TST")
    clk = VirtualClock()
    eng = _fresh_async(
        backend="ref", clock=clk,
        admission=AdmissionConfig(tenant_rate=100.0, tenant_burst=2.0))
    eng.submit_async(chain, _pts(rng, 2, 2), tenant="t0")
    eng.submit_async(chain, _pts(rng, 2, 2), tenant="t0")
    with pytest.raises(RateLimitError) as exc:
        eng.submit_async(chain, _pts(rng, 2, 2), tenant="t0")
    assert exc.value.code == "rate-limit"
    # a DIFFERENT tenant has its own bucket
    eng.submit_async(chain, _pts(rng, 2, 2), tenant="t1")
    # and clock time refills t0's
    clk.advance(0.01)
    eng.submit_async(chain, _pts(rng, 2, 2), tenant="t0")
    assert eng.stats["rate_limit_rejections"] == 1
    assert serving.stats["rate_limit_rejections"] == 1


def test_depth_rejection_spends_no_rate_token():
    clk = VirtualClock()
    ctrl = AdmissionController(
        AdmissionConfig(max_queue_depth=1, tenant_share=1.0,
                        tenant_rate=10.0, tenant_burst=2.0), clk)
    ctrl.admit("t")
    with pytest.raises(QueueFullError):
        ctrl.admit("t")                  # depth gate fires first
    ctrl.release("t")
    ctrl.admit("t")                      # the second token is still there
    assert ctrl.rate_limit_rejections == 0


# ---------------------------------------------------------------------------
# latency telemetry pinned on a fixed arrival script
# ---------------------------------------------------------------------------

def test_p50_p99_pinned_on_fixed_arrival_script():
    """Arrivals at t = 0, 1, 2, 3 ms into a 4-row bucket: the 4th fill
    triggers the flush at t = 3 ms, so latencies are exactly
    [3, 2, 1, 0] ms -- p50 = 1 ms (nearest rank), p99 = 3 ms, and the
    sustained rate is 4 requests over 3 ms."""
    rng = np.random.default_rng(6)
    chain = workload.chain_for(rng, 2, "TST")
    clk = VirtualClock()
    eng = _fresh_async(backend="ref", clock=clk,
                       slo=SLOConfig(max_wait_s=0.05, target_rows=4))
    tickets = []
    for k in range(4):
        clk.advance_to(k * 0.001)
        tickets.append(eng.submit_async(chain, _pts(rng, 3, 2)))
    assert eng.next_due_in() == 0.0
    assert eng.poll() == 4
    assert [t.latency for t in tickets] == \
        pytest.approx([0.003, 0.002, 0.001, 0.0])
    st = eng.stats
    assert st["p50_latency_s"] == pytest.approx(0.001)
    assert st["p99_latency_s"] == pytest.approx(0.003)
    assert st["max_latency_s"] == pytest.approx(0.003)
    assert st["sustained_rps"] == pytest.approx(4 / 0.003)


def test_queue_depth_telemetry():
    rng = np.random.default_rng(7)
    chain = workload.chain_for(rng, 2, "TST")
    eng = _fresh_async(backend="ref")
    for _ in range(3):
        eng.submit_async(chain, _pts(rng, 2, 2))
    st = eng.stats
    assert st["queue_depth"] == 3
    assert st["max_queue_depth_seen"] == 3
    assert st["resolved"] == 0
    eng.drain()
    st = eng.stats
    assert st["queue_depth"] == 0
    assert st["max_queue_depth_seen"] == 3   # high-water mark sticks
    assert st["resolved"] == 3
    assert serving.stats["admitted_requests"] == 3


def test_slo_config_validation():
    with pytest.raises(ValueError):
        SLOConfig(max_wait_s=-0.001)
    with pytest.raises(ValueError):
        SLOConfig(target_rows=0)
    with pytest.raises(ValueError):
        AdmissionConfig(max_queue_depth=0)
    with pytest.raises(ValueError):
        AdmissionConfig(tenant_share=0.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=2.0)


# ---------------------------------------------------------------------------
# the same arrival script through both packages
# ---------------------------------------------------------------------------

def _arrivals(seed: int, n: int):
    """A seeded arrival script: (time, tenant, template index, points) --
    exponential gaps, three tenants, four templates of two dims."""
    rng = np.random.default_rng([0xC10C, seed])
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(0.0004))
        tenant = ("a", "a", "b", "c")[int(rng.integers(0, 4))]
        k = int(rng.integers(0, 4))
        dim = 2 if k < 2 else 3
        pts = rng.uniform(-1, 1, (int(rng.integers(1, 60)), dim))
        out.append((t, tenant, k, pts.astype(np.float32)))
    return out


def _drive(pkg: str, script, chains):
    """Serve ``script`` through one package's async engine: submit at
    each arrival instant (typed rejections counted by code), poll after
    each, then drain.  Returns (the engine's stats, the rejection codes,
    the flush order as bucket structures, the module counters)."""
    if pkg == "port":
        mod_serving, clk = serving, VirtualClock()
        eng = AsyncGeometryServer(
            device="cpu", clock=clk,
            slo=SLOConfig(max_wait_s=0.004, target_rows=4),
            admission=AdmissionConfig(max_queue_depth=8, tenant_share=0.5,
                                      tenant_rate=900.0, tenant_burst=6.0))
    else:
        mod_serving, clk = jserving, jclock.VirtualClock()
        eng = jasync.AsyncGeometryServer(
            backend="ref", clock=clk,
            slo=jasync.SLOConfig(max_wait_s=0.004, target_rows=4),
            admission=jserving.AdmissionConfig(
                max_queue_depth=8, tenant_share=0.5, tenant_rate=900.0,
                tenant_burst=6.0))
        chains = [jtc.TransformChain(c.dim, c.kinds, c.params)
                  for c in chains]
    mod_serving.reset_stats()
    mod_serving.clear_plan_cache()
    codes = []
    for t, tenant, k, pts in script:
        nd = eng.next_due_in()
        while nd is not None and clk.now() + nd <= t:
            clk.advance(nd)
            eng.poll()
            nd = eng.next_due_in()
        clk.advance_to(t)
        try:
            eng.submit_async(chains[k], pts, tenant=tenant)
        except mod_serving.RequestError as e:
            codes.append(e.code)
        eng.poll()
    eng.drain()
    order = [r.structure for r in eng.server.reports]
    keys = ("launches", "buckets", "requests", "admitted_requests",
            "queue_full_rejections", "rate_limit_rejections")
    return (eng.stats, codes, order,
            {k: mod_serving.stats[k] for k in keys})


def test_arrival_script_matches_reference():
    rng = np.random.default_rng(9)
    chains = [workload.chain_for(rng, 2, "TST"),
              workload.chain_for(rng, 2, "TSRT"),
              workload.chain_for(rng, 3, "TRS"),
              workload.chain_for(rng, 3, "SAT")]
    script = _arrivals(4, 400)
    port = _drive("port", script, chains)
    ref = _drive("reference", script, chains)
    jserving.clear_plan_cache()
    stats, codes, order, counters = port
    assert stats == ref[0]
    assert codes == ref[1] and order == ref[2] and counters == ref[3]
    # the script exercised every gate and both launch reasons
    assert {"queue-full", "rate-limit"} <= set(codes)
    assert stats["resolved"] == stats["admitted"] > 0
    assert stats["p99_latency_s"] > stats["p50_latency_s"] > 0.0
    assert counters["launches"] < stats["admitted"]


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_p50_p99_pinned_in_both_packages(pkg):
    """The hand-computed script of ``test_p50_p99_pinned_on_fixed_arrival_
    script`` gives the same pinned values through either package."""
    rng = np.random.default_rng(6)
    chain = workload.chain_for(rng, 2, "TST")
    if pkg == "port":
        clk = VirtualClock()
        eng = _fresh_async(clock=clk,
                           slo=SLOConfig(max_wait_s=0.05, target_rows=4))
    else:
        jserving.reset_stats()
        clk = jclock.VirtualClock()
        eng = jasync.AsyncGeometryServer(
            backend="ref", clock=clk,
            slo=jasync.SLOConfig(max_wait_s=0.05, target_rows=4))
        chain = jtc.TransformChain(chain.dim, chain.kinds, chain.params)
    for k in range(4):
        clk.advance_to(k * 0.001)
        eng.submit_async(chain, rng.uniform(-1, 1, (3, 2)).astype(
            np.float32))
    assert eng.poll() == 4
    st = eng.stats
    assert st["p50_latency_s"] == pytest.approx(0.001)
    assert st["p99_latency_s"] == pytest.approx(0.003)
    assert st["sustained_rps"] == pytest.approx(4 / 0.003)

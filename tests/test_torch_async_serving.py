"""Sync/async equivalence and fault tolerance of the port's
continuous-batching front-end: the same seeded workload through
``GeometryServer.flush`` and through ``AsyncGeometryServer`` gives
bitwise-identical per-ticket results and identical launch/byte counters
for every plan kind (diagonal, matrix, projective, fixed-point), the
awaitable-ticket protocol delivers the same values, and the
zero-lost-requests invariant holds under fault injection THROUGH the
async path -- with the reference's resolutions and counters.

Mirrors ``tests/test_async_serving.py`` case by case on the CPU.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.core import transform_chain as jtc  # noqa: E402
from repro.serving import async_engine as jasync  # noqa: E402
from repro.serving import clock as jclock  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.core.transform_chain import TransformChain  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.async_engine import (AsyncGeometryServer,  # noqa: E402
                                              SLOConfig)
from repro_torch.serving.clock import VirtualClock  # noqa: E402


def _reset():
    serving.reset_stats()
    serving.clear_plan_cache()


def _fresh_async(**kw):
    _reset()
    kw.setdefault("clock", VirtualClock())
    return AsyncGeometryServer(device="cpu", **kw)


#: the counters that must be IDENTICAL between one synchronous flush and
#: an async drain of the same submissions -- the front-end decides when
#: buckets launch, never what a launch computes or moves
_ECONOMY = ("launches", "buckets", "requests", "payload_points",
            "padded_points", "plan_compiles", "traces")


def _snap():
    return {k: serving.stats[k] for k in _ECONOMY}


def _assert_same_result(a, b):
    """Bitwise equality, including the projective cull mask."""
    mask_a = getattr(a, "mask", None)
    mask_b = getattr(b, "mask", None)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (mask_a is None) == (mask_b is None)
    if mask_a is not None:
        np.testing.assert_array_equal(np.asarray(mask_a),
                                      np.asarray(mask_b))


# ---------------------------------------------------------------------------
# sync/async bitwise equivalence, per plan kind and mixed
# ---------------------------------------------------------------------------

#: one workload generator per plan kind the engine compiles
_KINDS = {
    "diag": lambda rng: (workload.chain_for(rng, 2, "TST"), None),
    "matrix": lambda rng: (workload.chain_for(rng, 3, "TRS"), None),
    "projective": lambda rng: (workload.chain_for(rng, 3, "TSRP"), None),
    "q8.7": lambda rng: (workload.chain_for(rng, 2, "TTSS"), "q8.7"),
}


def _kind_workload(kind: str, n: int, seed: int):
    rng = np.random.default_rng([0xA51C, seed])
    reqs = []
    for _ in range(n):
        chain, qname = _KINDS[kind](rng)
        pts = rng.uniform(-2, 2, (int(rng.integers(1, 40)),
                                  chain.dim)).astype(np.float32)
        reqs.append((chain, pts, qname))
    return reqs


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_sync_async_bitwise_equivalence(kind):
    reqs = _kind_workload(kind, 24, seed=3)

    _reset()
    sync = serving.GeometryServer(device="cpu")
    for chain, pts, qname in reqs:
        sync.submit(chain, pts, qformat=qname)
    sync_results = sync.flush()
    sync_counters = _snap()

    eng = _fresh_async()
    tickets = [eng.submit_async(chain, pts, qformat=qname)
               for chain, pts, qname in reqs]
    eng.drain()
    async_counters = _snap()

    assert async_counters == sync_counters
    for t, expected in zip(tickets, sync_results):
        assert t.done()
        _assert_same_result(t.result(), expected)


def test_sync_async_equivalence_mixed_lanes():
    """All plan kinds and both dtype lanes in ONE flush: the async drain
    must reproduce the synchronous bucket composition exactly."""
    reqs = workload.mixed_lane_workload(7, 48)
    assert any(q for _, _, q in reqs) and \
        any(c.is_projective for c, _, _ in reqs)

    _reset()
    sync = serving.GeometryServer(device="cpu")
    for chain, pts, qname in reqs:
        sync.submit(chain, pts, qformat=qname)
    sync_results = sync.flush()
    sync_counters = _snap()
    assert sync_counters["launches"] < len(reqs)   # batching did happen

    eng = _fresh_async()
    tickets = [eng.submit_async(chain, pts, qformat=qname)
               for chain, pts, qname in reqs]
    eng.drain()
    assert _snap() == sync_counters
    for t, expected in zip(tickets, sync_results):
        _assert_same_result(t.result(), expected)
    st = eng.stats
    assert st["resolved"] == len(reqs) and st["failed"] == 0
    assert st["queue_depth"] == 0


def test_async_results_deterministic_across_engines():
    """Two engines, same submissions, same (virtual) schedule -> bitwise
    identical resolutions: the determinism the soak gate stands on."""
    reqs = workload.mixed_lane_workload(13, 24)

    def serve():
        eng = _fresh_async()
        ts = [eng.submit_async(c, p, qformat=q) for c, p, q in reqs]
        eng.drain()
        return [np.asarray(t.result()) for t in ts]

    for a, b in zip(serve(), serve()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# awaitable tickets
# ---------------------------------------------------------------------------

def test_ticket_await_protocol():
    rng = np.random.default_rng(0)
    chain = workload.chain_for(rng, 3, "TRS")
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    eng = _fresh_async(
                       slo=SLOConfig(max_wait_s=0.001, target_rows=64))

    async def request_stream():
        t = eng.submit_async(chain, pts)
        assert not t.done()
        out = await t
        return np.asarray(out)

    got, = eng.run(request_stream())
    exp = chain.apply(pts, device="cpu").numpy()
    np.testing.assert_array_equal(got, exp)


def test_run_interleaves_multiple_streams():
    """Coroutines submitting at different virtual instants all resolve,
    and each awaited value matches that stream's own request."""
    rng = np.random.default_rng(1)
    chain = workload.chain_for(rng, 2, "TSRT")
    eng = _fresh_async(
                       slo=SLOConfig(max_wait_s=0.002, target_rows=4))
    payloads = [rng.normal(size=(n, 2)).astype(np.float32)
                for n in (3, 5, 7)]

    async def stream(pts):
        first = await eng.submit_async(chain, pts)
        second = await eng.submit_async(chain, pts * 2)
        return np.asarray(first), np.asarray(second)

    results = eng.run(*[stream(p) for p in payloads])
    for pts, (first, second) in zip(payloads, results):
        exp1 = chain.apply(pts, device="cpu").numpy()
        exp2 = chain.apply(pts * 2, device="cpu").numpy()
        np.testing.assert_array_equal(first, exp1)
        np.testing.assert_array_equal(second, exp2)


def test_ticket_result_before_resolution_raises():
    rng = np.random.default_rng(2)
    chain = workload.chain_for(rng, 2, "TST")
    eng = _fresh_async()
    t = eng.submit_async(chain, np.ones((3, 2), np.float32))
    with pytest.raises(RuntimeError, match="pending"):
        t.result()
    assert t.latency is None
    eng.drain()
    assert t.latency == 0.0          # same virtual instant


def test_gather_returns_results_in_ticket_order():
    rng = np.random.default_rng(3)
    chain = workload.chain_for(rng, 2, "TST")
    eng = _fresh_async(
                       slo=SLOConfig(max_wait_s=0.004, target_rows=64))
    pts = [np.full((2, 2), i, np.float32) for i in range(5)]
    tickets = [eng.submit_async(chain, p) for p in pts]
    results = eng.gather(tickets)
    assert all(t.done() for t in tickets)
    for r, p in zip(results, pts):
        exp = chain.apply(p, device="cpu").numpy()
        np.testing.assert_array_equal(np.asarray(r), exp)


# ---------------------------------------------------------------------------
# identity chains ride the always-due passthrough
# ---------------------------------------------------------------------------

def test_identity_chain_resolves_on_first_poll():
    eng = _fresh_async(
                       slo=SLOConfig(max_wait_s=10.0, target_rows=64))
    pts = np.arange(8, dtype=np.float32).reshape(4, 2)
    t = eng.submit_async(TransformChain.identity(2), pts)
    assert eng.next_due_in() == 0.0     # no launch to amortise
    assert eng.poll() == 1
    np.testing.assert_array_equal(np.asarray(t.result()), pts)
    assert serving.stats["launches"] == 0


# ---------------------------------------------------------------------------
# typed rejections at the async intake
# ---------------------------------------------------------------------------

def test_validation_rejection_releases_admission_slot():
    rng = np.random.default_rng(4)
    chain = workload.chain_for(rng, 2, "TST")
    eng = _fresh_async()
    with pytest.raises(serving.RequestError) as exc:
        eng.submit_async(chain, np.ones((3, 3), np.float32))  # wrong dim
    assert exc.value.code == "shape"
    # the request never queued: slot, admitted count, and module stats
    assert eng.queue_depth == 0
    st = eng.stats
    assert st["admitted"] == 0
    assert serving.stats["admitted_requests"] == 0
    assert serving.stats["rejected_requests"] == 1
    # the engine still serves afterwards
    t = eng.submit_async(chain, np.ones((3, 2), np.float32))
    eng.drain()
    assert t.done()


# ---------------------------------------------------------------------------
# fault tolerance composes with continuous batching
# ---------------------------------------------------------------------------

def test_chaos_zero_lost_through_async_path():
    """Every admitted request resolves to points or a typed error under
    fault injection -- the zero-lost invariant, now on the async path."""
    reqs = workload.mixed_lane_workload(21, 48)
    inj = serving.FaultInjector(seed=21, flaky_rate=0.1, backend_rate=0.08,
                                corrupt_rate=0.08, poison_rate=0.05)
    eng = _fresh_async(injector=inj,
                       fault_config=serving.FaultConfig(backoff_base_s=0.0))
    tickets = [eng.submit_async(c, p, qformat=q) for c, p, q in reqs]
    eng.drain()

    assert all(t.done() for t in tickets)
    failed = [t for t in tickets if serving.is_error(t.result())]
    resolved = [t for t in tickets if not serving.is_error(t.result())]
    # the injector's rates guarantee the ladder actually ran
    assert serving.stats["launch_failures"] > 0
    for t in failed:
        assert isinstance(t.result(), serving.LaunchError)
        assert t.result().ticket == t.id
    st = eng.stats
    assert st["resolved"] == len(resolved)
    assert st["failed"] == len(failed)
    assert st["resolved"] + st["failed"] == st["admitted"] == len(reqs)
    assert st["queue_depth"] == 0

    # recovered results are the true values, bit for bit
    for t, (chain, pts, qname) in zip(tickets, reqs):
        if serving.is_error(t.result()) or chain.is_projective:
            continue
        exp = chain.apply(pts, dtype=qname, device="cpu").numpy()
        np.testing.assert_array_equal(np.asarray(t.result()), exp)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_frozen_clock_drain_builds_the_sync_buckets():
    """A drain under a frozen clock schedules exactly the buckets one
    synchronous flush builds: the same reports, in the same order."""
    reqs = workload.mixed_lane_workload(5, 40)
    _reset()
    sync = serving.GeometryServer(device="cpu")
    for chain, pts, qname in reqs:
        sync.submit(chain, pts, qformat=qname)
    sync.flush()
    eng = _fresh_async()
    for chain, pts, qname in reqs:
        eng.submit_async(chain, pts, qformat=qname)
    assert eng.clock.now() == 0.0
    eng.drain()
    assert eng.server.last_report == sync.last_report


def test_chaos_through_async_path_matches_reference():
    """The same workload and injector through both packages' async
    front-ends (one-rung ladders): the same tickets fail, and the
    recovery counters and the engines' stats are equal."""
    reqs = workload.mixed_lane_workload(21, 48)
    rates = dict(seed=21, flaky_rate=0.1, backend_rate=0.08,
                 corrupt_rate=0.08, poison_rate=0.05)
    eng = _fresh_async(injector=serving.FaultInjector(**rates),
                       fault_config=serving.FaultConfig(backoff_base_s=0.0))
    tickets = [eng.submit_async(c, p, qformat=q) for c, p, q in reqs]
    eng.drain()
    jserving.reset_stats()
    jserving.clear_plan_cache()
    jeng = jasync.AsyncGeometryServer(
        backend="ref", clock=jclock.VirtualClock(),
        injector=jserving.FaultInjector(**rates),
        fault_config=jserving.FaultConfig(backoff_base_s=0.0))
    jtickets = [jeng.submit_async(jtc.TransformChain(c.dim, c.kinds,
                                                     c.params), p, qformat=q)
                for c, p, q in reqs]
    jeng.drain()
    jserving.clear_plan_cache()
    failed = [t.id for t in tickets if serving.is_error(t.result())]
    assert failed == [t.id for t in jtickets
                      if jserving.is_error(t.result())]
    assert failed
    keys = ("launches", "launch_failures", "retries", "bisections",
            "recovered_requests", "failed_requests", "admitted_requests")
    assert {k: serving.stats[k] for k in keys} == \
        {k: jserving.stats[k] for k in keys}
    assert eng.stats == jeng.stats


# ---------------------------------------------------------------------------
# the Poisson soak: the reference driver's settings and counters
# ---------------------------------------------------------------------------

def _reference_soak_bench():
    """``benchmarks/soak_bench.py`` of the JAX package, loaded by path."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "soak_bench.py")
    spec = importlib.util.spec_from_file_location("soak_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_driver_matches_reference():
    """The port's copy of the soak driver and the JAX package's own, on
    the same settings and 1000 arrivals: every counter the reference's
    gate compares is equal, both admission gates' outcomes included."""
    import torch_chaos
    _reset()
    port = torch_chaos.drive_soak(1000, device="cpu")
    bench = _reference_soak_bench()
    assert (bench.SEED, bench.POOL) == (torch_chaos.SOAK_SEED,
                                        torch_chaos.SOAK_POOL)
    jserving.reset_stats()
    jserving.clear_plan_cache()
    ref = bench.drive_soak(1000, backend="ref")
    jserving.clear_plan_cache()
    assert {k: port[k] for k in torch_chaos.SOAK} == \
        {k: ref[k] for k in torch_chaos.SOAK}
    assert port["rate_limited"] > 0 and port["lost"] == 0


def test_soak_gives_the_pinned_counters():
    """The full soak of ``chip_smoke.py`` on the CPU: the reference's
    counters at ``SOAK_ARRIVALS`` arrivals, exactly."""
    import torch_chaos
    _reset()
    got = torch_chaos.drive_soak(torch_chaos.SOAK_ARRIVALS, device="cpu")
    assert {k: got[k] for k in torch_chaos.SOAK} == torch_chaos.SOAK

"""The chaos soak's pinned counters, in one place (a helper module, not a
test file): ``run_chaos_soak(seed=SEED, n_requests=N_REQUESTS)`` of the
JAX package with a one-rung ladder (``backend="ref"``) and a two-rung
ladder (``backend="interpret"``, which degrades to ``"ref"``) gives these
exact values, and so must the port's: on the CPU its ladder is one rung,
``("ref",)``, and on a CUDA server two, ``("cuda", "ref")``.  The parity
tests hold both packages to them, and ``chip_smoke.py`` holds the port's
card run to ``TWO_RUNG``.

Every value is a pure function of (seed, ticket): the workload, the
injector's roles (``np.random.default_rng([0xFA17, seed, ticket])``) and
the bucketing are seeded, and the recovery ladder walks in one order.

The async front end's Poisson soak lives here too: ``drive_soak`` is the
port's copy of the JAX package's soak driver (``benchmarks/soak_bench.py``,
``drive_soak``) with that driver's documented settings, and ``SOAK`` its
counters at ``SOAK_ARRIVALS`` arrivals, all pure functions of the seed
on the virtual clock.  ``chip_smoke.py`` holds the port's card run to
them; a parity test holds the two drivers to each other.
"""
import time

SEED, N_REQUESTS = 11, 64

#: the counters both ladders share: the workload, the malformed
#: submissions and the buckets do not depend on the ladder
_COMMON = {"seed": SEED, "requests": 65, "malformed": 7,
           "rejected_at_submit": 7, "lost": 0, "mismatches": 0,
           "faulted_buckets": 12, "launches": 48, "q_fallbacks": 1,
           "injected_corruptions": 1}

#: ("ref",): a ``backend`` ticket has no rung to degrade to, so it fails
ONE_RUNG = {**_COMMON, "resolved": 57, "failed_requests": 8,
            "launch_failures": 56, "retries": 41, "backend_fallbacks": 0,
            "bisections": 7, "recovered_requests": 11,
            "injected_launch_faults": 55}

#: two rungs: ``backend`` tickets recover on the second, only the
#: ``poison`` tickets fail
TWO_RUNG = {**_COMMON, "resolved": 62, "failed_requests": 3,
            "launch_failures": 52, "retries": 37, "backend_fallbacks": 5,
            "bisections": 2, "recovered_requests": 16,
            "injected_launch_faults": 51}


#: the JAX package's soak settings (``benchmarks/soak_bench.py``: ``SEED``,
#: ``POOL`` and ``drive_soak``'s defaults): 150 000 arrivals/s offered,
#: four tenants drawn uniformly, token buckets of 30 000/s and 64 tokens
#: a tenant (4 x 30 000 < 150 000, so rate limiting must fire), depth
#: 1024, a tenant's share 0.5, the flush policy's 20 ms deadline and
#: 32-row target, over a pool of 384 mixed-lane requests of 1-48 points
#: (affine, projective and q8.7), replayed in turn
SOAK_SEED, SOAK_POOL, SOAK_MAX_POINTS = 17, 384, 48
SOAK_RATE_RPS, SOAK_TENANTS = 150_000.0, 4
SOAK_ADMISSION = dict(max_queue_depth=1024, tenant_share=0.5,
                      tenant_rate=30_000.0, tenant_burst=64.0)
SOAK_SLO = dict(max_wait_s=0.02, target_rows=32)
SOAK_ARRIVALS = 20_000

#: ``drive_soak(SOAK_ARRIVALS, backend="ref")`` of the JAX package's
#: ``benchmarks/soak_bench.py``: the counters its gate compares exactly
SOAK = {"requests": 20000, "admitted": 16308, "rate_limited": 3692,
        "queue_full": 0, "resolved": 16308, "failed": 0, "lost": 0,
        "launches": 1058, "buckets": 1058, "payload_points": 138585,
        "padded_points": 218328, "retries": 0, "backend_fallbacks": 0,
        "bisections": 0, "polls": 1058, "p50_virtual_us": 3208.67,
        "p99_virtual_us": 16250.0, "virtual_rps": 106393.0,
        "virtual_span_s": 0.153281}


def drive_soak(n_requests: int, *, device: str) -> dict:
    """One seeded Poisson soak through the port's ``AsyncGeometryServer``
    on ``device``, the reference driver's loop step for step: the clock
    goes to the next arrival or the engine's next deadline, whichever is
    first; a rejected submission is counted by the admission controller;
    the tail retires on its own deadlines.  Returns the counters of
    ``SOAK`` and ``wall_s``, the host seconds of the loop."""
    import numpy as np

    from repro_torch import serving
    from repro_torch.serving import workload

    pool = workload.mixed_lane_workload(SOAK_SEED, SOAK_POOL,
                                        max_points=SOAK_MAX_POINTS)
    clock = serving.VirtualClock()
    eng = serving.AsyncGeometryServer(
        device=device, clock=clock, slo=serving.SLOConfig(**SOAK_SLO),
        admission=serving.AdmissionConfig(**SOAK_ADMISSION))
    rng = np.random.default_rng([0x50AF, SOAK_SEED])
    base = dict(serving.stats)
    next_arrival, polls, i = 0.0, 0, 0
    wall0 = time.perf_counter()
    while i < n_requests:
        nd = eng.next_due_in()
        if nd is not None and clock.now() + nd < next_arrival:
            clock.advance(nd)
            eng.poll()
            polls += 1
            continue
        clock.advance_to(next_arrival)
        tenant = f"t{int(rng.integers(SOAK_TENANTS))}"
        chain, pts, qname = pool[i % SOAK_POOL]
        try:
            eng.submit_async(chain, pts, tenant=tenant, qformat=qname)
        except (serving.QueueFullError, serving.RateLimitError):
            pass
        i += 1
        next_arrival += float(rng.exponential(1.0 / SOAK_RATE_RPS))
    while (nd := eng.next_due_in()) is not None:
        clock.advance(nd)
        eng.poll()
        polls += 1
    wall_s = time.perf_counter() - wall0
    st = eng.stats
    delta = {k: serving.stats[k] - base[k] for k in base}
    return {"requests": n_requests, "admitted": st["admitted"],
            "rate_limited": st["rate_limit_rejections"],
            "queue_full": st["queue_full_rejections"],
            "resolved": st["resolved"], "failed": st["failed"],
            "lost": st["admitted"] - st["resolved"] - st["failed"],
            **{k: delta[k] for k in ("launches", "buckets",
                                     "payload_points", "padded_points",
                                     "retries", "backend_fallbacks",
                                     "bisections")},
            "polls": polls,
            "p50_virtual_us": round(st["p50_latency_s"] * 1e6, 2),
            "p99_virtual_us": round(st["p99_latency_s"] * 1e6, 2),
            "virtual_rps": round(st["sustained_rps"], 1),
            "virtual_span_s": round(clock.now(), 6), "wall_s": wall_s}

"""Admission control and backpressure for the continuous-batching front-end.

The port of ``repro/serving/admission.py`` (the same gates, codes and
counters).

A server that accepts every request under overload does not serve more
traffic -- it serves the same traffic later, with every request's
latency inflated by the queue it had to wait behind.  The admission
layer moves that failure to the intake boundary, exactly like the
malformed-request taxonomy did for bad payloads: an inadmissible request
is refused *at submit* with a typed, machine-readable rejection code,
never silently queued into an SLO violation.

Three gates, all clock-driven through the injectable ``serving.clock``
interface (so every decision is deterministic under a ``VirtualClock``):

  * **bounded queue depth** -- at most ``max_queue_depth`` admitted
    requests may be waiting; past that, ``QueueFullError``
    (code ``"queue-full"``).  Backpressure, not buffering: the caller
    learns *now* that it must slow down.
  * **per-tenant fair share** -- no single tenant may hold more than
    ``ceil(max_queue_depth * tenant_share)`` of the queue.  A flooding
    tenant hits ITS cap while the queue still has room, so a light
    tenant is never starved by a heavy one (the starvation test in
    ``tests/test_clock.py`` pins this).
  * **per-tenant token bucket** -- sustained rate ``tenant_rate``
    requests/s with burst capacity ``tenant_burst``; an empty bucket
    rejects with ``RateLimitError`` (code ``"rate-limit"``).  Buckets
    refill continuously in clock time, so a rejected tenant's next
    admissible instant is computable (and, under a virtual clock,
    exact).

Both rejection classes subclass ``repro_torch.errors.RequestError``:
callers already catching the typed taxonomy at submit handle
backpressure with zero new code paths, and the stable ``code`` strings
are what telemetry and tests group by.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch import errors
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serving.clock import Clock


class QueueFullError(errors.RequestError):
    """The bounded admission queue (global depth, or this tenant's fair
    share of it) has no room: backpressure -- retry after a flush, or
    slow down.  Rejected at submit so the request never waits out an
    SLO it has already lost."""
    code = "queue-full"


class RateLimitError(errors.RequestError):
    """This tenant's token bucket is empty: its sustained submission
    rate exceeds the configured requests/s.  The message names the
    earliest admissible instant."""
    code = "rate-limit"


@dataclasses.dataclass
class TokenBucket:
    """A continuously-refilling token bucket on an injected timeline.

    Holds at most ``burst`` tokens, refills at ``rate`` tokens/s of
    *clock* time (virtual or monotonic -- the bucket never reads a wall
    clock itself), and ``take`` spends one token per admitted request.
    Pure arithmetic on ``now`` values: two buckets fed the same take
    timestamps make identical decisions, which is what lets the soak
    benchmark gate rejection counts exactly."""
    rate: float                    # tokens per second of clock time
    burst: float                   # bucket capacity (initial fill)
    tokens: float = None           # type: ignore[assignment]
    stamp: float = 0.0             # clock time of the last refill

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"token rate must be > 0, got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.tokens is None:
            self.tokens = float(self.burst)

    def _refill(self, now: float) -> None:
        if now > self.stamp:
            self.tokens = min(float(self.burst),
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = max(self.stamp, now)

    def take(self, now: float) -> bool:
        """Spend one token if available; False = rate-limited."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def next_admissible_in(self, now: float) -> float:
        """Seconds until a token will be available (0 if one is now)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Backpressure policy knobs for one ``AsyncGeometryServer``.

    ``tenant_rate=None`` disables rate limiting (the queue-depth gates
    still apply); ``tenant_share=1.0`` disables the fair-share cap
    (a single tenant may then fill the whole queue)."""
    max_queue_depth: int = 1024
    tenant_share: float = 0.5      # max fraction of the queue per tenant
    tenant_rate: float | None = None   # sustained requests/s per tenant
    tenant_burst: float = 32.0

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1, got "
                             f"{self.max_queue_depth}")
        if not 0.0 < self.tenant_share <= 1.0:
            raise ValueError("tenant_share must be in (0, 1], got "
                             f"{self.tenant_share}")

    @property
    def tenant_cap(self) -> int:
        """Queued requests one tenant may hold: its fair share of the
        bounded queue, never below 1 (a tenant must always be able to
        make progress when the queue itself has room)."""
        return max(1, math.ceil(self.max_queue_depth * self.tenant_share))


class AdmissionController:
    """Tracks queue occupancy per tenant and arbitrates admission.

    The engine calls ``admit`` at submit (raises the typed rejection) and
    ``release`` when a request leaves the queue for a launch.  Counters
    (``admitted`` / ``queue_full_rejections`` / ``rate_limit_rejections``)
    are registry-backed per controller (read them as plain ints exactly
    as before -- they are properties over ``repro_torch.obs.metrics``
    counters, with per-tenant rejection labels on the side); the engine mirrors
    them into ``serving.stats`` by delta.
    """

    def __init__(self, config: AdmissionConfig, clock: Clock,
                 metrics: obsm.MetricsRegistry | None = None):
        self.config = config
        self.clock = clock
        self.depth = 0                               # total queued
        self.tenant_depth: dict[str, int] = {}       # queued per tenant
        self._buckets: dict[str, TokenBucket] = {}
        self.metrics = metrics if metrics is not None \
            else obsm.MetricsRegistry("admission")
        self._c_admitted = self.metrics.counter("admitted")
        self._c_queue_full = self.metrics.counter("queue_full_rejections")
        self._c_rate_limit = self.metrics.counter("rate_limit_rejections")
        self._rejections = self.metrics.counter(
            "rejections", labels=("tenant", "code"))

    # back-compat integer views over the registry counters ------------------

    @property
    def admitted(self) -> int:
        return self._c_admitted.value

    @property
    def queue_full_rejections(self) -> int:
        return self._c_queue_full.value

    @property
    def rate_limit_rejections(self) -> int:
        return self._c_rate_limit.value

    def _reject(self, counter: obsm.Counter, tenant: str,
                code: str, gate: str) -> None:
        counter.inc()
        self._rejections.labels(tenant=tenant, code=code).inc()
        trc = obst.active()
        if trc.enabled:
            trc.instant("admission.reject", tenant=tenant, code=code,
                        gate=gate)

    def _bucket(self, tenant: str) -> TokenBucket | None:
        if self.config.tenant_rate is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = TokenBucket(rate=self.config.tenant_rate,
                            burst=self.config.tenant_burst,
                            stamp=self.clock.now())
            self._buckets[tenant] = b
        return b

    def admit(self, tenant: str) -> None:
        """Admit one request for ``tenant`` or raise the typed rejection.

        Gate order: queue depth (cheapest, protects the server), then
        the tenant's fair share, then the tenant's token bucket -- a
        request rejected for depth does NOT spend a rate token, so
        backpressure never doubles as a rate penalty."""
        cfg = self.config
        if self.depth >= cfg.max_queue_depth:
            self._reject(self._c_queue_full, tenant, QueueFullError.code,
                         "depth")
            raise QueueFullError(
                f"queue full ({self.depth}/{cfg.max_queue_depth} waiting); "
                f"retry after the next flush")
        held = self.tenant_depth.get(tenant, 0)
        if held >= cfg.tenant_cap:
            self._reject(self._c_queue_full, tenant, QueueFullError.code,
                         "fair-share")
            raise QueueFullError(
                f"tenant {tenant!r} holds its fair share of the queue "
                f"({held}/{cfg.tenant_cap} of {cfg.max_queue_depth})")
        bucket = self._bucket(tenant)
        if bucket is not None and not bucket.take(self.clock.now()):
            self._reject(self._c_rate_limit, tenant, RateLimitError.code,
                         "token-bucket")
            wait = bucket.next_admissible_in(self.clock.now())
            raise RateLimitError(
                f"tenant {tenant!r} over {cfg.tenant_rate:g} req/s "
                f"(burst {cfg.tenant_burst:g}); admissible in {wait:.6f} s")
        self._c_admitted.inc()
        self.depth += 1
        self.tenant_depth[tenant] = held + 1

    def unadmit(self, tenant: str) -> None:
        """Roll back an ``admit`` whose request never reached the queue
        (validation refused it): the slot and the admitted count go
        back, but not any spent rate token -- the tenant did submit."""
        self.release(tenant)
        self._c_admitted.inc(-1)

    def release(self, tenant: str) -> None:
        """One queued request of ``tenant`` left the queue for a launch."""
        self.depth -= 1
        self.tenant_depth[tenant] -= 1
        assert self.depth >= 0 and self.tenant_depth[tenant] >= 0, \
            "admission release without a matching admit"

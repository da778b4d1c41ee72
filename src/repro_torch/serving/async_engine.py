"""Continuous-batching async front-end over the plan-bucketed GeometryServer.

The port of ``repro/serving/async_engine.py``: the same admission gates,
flush policy, tickets and telemetry over the port's ``GeometryServer``.

The synchronous engine answers "how do N pending requests execute in the
fewest launches"; this module answers the production question above it:
requests ARRIVE on a timeline, and the server must decide WHEN each
plan bucket launches -- too eager and the launch economy collapses back
to per-request dispatch, too patient and tail latency blows through the
SLO.  The design is the continuous-batching loop of production LLM
servers, mapped onto this repo's substrate:

  1. **Admit** -- ``submit_async`` runs the admission gates
     (``serving.admission``: bounded queue depth, per-tenant fair share,
     per-tenant token buckets) and then the SAME validation boundary as
     the synchronous ``submit`` (``GeometryServer.validate`` -- one
     ticket sequence, one taxonomy).  Admitted requests return an
     awaitable ``Ticket`` immediately; rejected ones raise a typed
     ``RequestError`` subclass with a stable code.
  2. **Schedule** -- admitted entries wait in per-bucket groups (keyed
     exactly like the engine's plan buckets: structure + backend +
     dtype/format + padded size class).  The flush policy couples the
     max-wait deadline to the bucket fill fraction:

         due  <=>  fill >= 1  or  age >= max_wait_s * (1 - fill)

     a full bucket launches immediately, an empty-ish one waits out the
     deadline, and everything in between interpolates -- the fuller a
     bucket, the less reason to keep its requests waiting.
  3. **Launch** -- ``poll`` hands every due group to the inner
     ``GeometryServer`` (deadline order: the group whose oldest request
     has waited longest flushes first) and resolves tickets with the
     flush results -- including typed ``LaunchError`` resolutions from
     the recovery ladder, which runs unchanged under this front-end
     (the zero-lost-requests invariant is re-asserted through the async
     path by ``tests/test_torch_async_serving.py``).

**All timing flows through the injectable ``serving.clock.Clock``** --
the engine never reads a wall clock.  Under a ``VirtualClock`` every
scheduling decision, deadline expiry, latency sample, and admission
refill is a deterministic function of the arrival script, which is what
makes the scheduler *testable*: ``tests/test_torch_clock.py`` pins
flush ordering and p50/p99 values against hand-computed numbers and the
JAX package's.  Under the default ``MonotonicClock`` the same code
serves real traffic.

The backend is the inner server's own, resolved from its device at
construction (``dispatch.backend_for``) and passed explicitly: grouping
never reads the default that ``dispatch.use_backend`` sets.

Sync/async equivalence contract (``tests/test_torch_async_serving.py``):
the
same seeded workload submitted while the clock is frozen and then
``drain``ed produces bitwise-identical per-ticket results and identical
launch/byte counters to one synchronous ``flush`` -- the front-end only
decides WHEN groups launch, never changes WHAT a launch computes, and a
drain schedules exactly the synchronous bucket composition.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serving import engine
from repro_torch.serving import errors as serrors
from repro_torch.serving.admission import (AdmissionConfig,
                                           AdmissionController)
from repro_torch.serving.clock import Clock, MonotonicClock

_UNSET = object()

#: deadline residuals below a nanosecond snap to "due now": float64
#: rounding in ``max_wait * (1 - fill) - age`` can leave a remainder
#: smaller than the clock value's own ulp, which a VirtualClock advance
#: cannot consume -- without the snap, poll/advance livelocks on it
_DUE_EPS = 1e-9


class Ticket:
    """An admitted request's handle: resolves to the transformed points
    (or a typed error object, mirroring the synchronous ``flush`` result
    slots) when the flush policy launches its bucket.

    Awaitable: ``await ticket`` inside a coroutine driven by
    ``AsyncGeometryServer.run`` suspends until resolution.  The await
    protocol is the plain generator one (it yields the pending ticket to
    the driving trampoline), deliberately independent of any asyncio
    event loop -- determinism under a ``VirtualClock`` requires the
    engine, not a wall-clock-driven loop, to decide when time moves."""

    __slots__ = ("id", "tenant", "submitted_at", "resolved_at", "_value")

    def __init__(self, ticket_id: int, tenant: str, submitted_at: float):
        self.id = ticket_id
        self.tenant = tenant
        self.submitted_at = submitted_at
        self.resolved_at: float | None = None
        self._value = _UNSET

    def done(self) -> bool:
        """Whether the ticket has resolved (value or typed error)."""
        return self._value is not _UNSET

    def result(self):
        """The resolved value: transformed points, or the typed error
        object the request resolved to (check with ``serving.is_error``,
        exactly as for synchronous ``flush`` slots)."""
        if self._value is _UNSET:
            raise RuntimeError(
                f"ticket {self.id} is still pending; drive the engine "
                "(poll/drain/gather/run) before reading results")
        return self._value

    @property
    def latency(self) -> float | None:
        """Clock seconds from admission to resolution (None if pending)."""
        if self.resolved_at is None:
            return None
        return self.resolved_at - self.submitted_at

    def _resolve(self, value, now: float) -> None:
        self._value = value
        self.resolved_at = now

    def __await__(self):
        while not self.done():
            yield self
        return self._value

    def __repr__(self):
        state = "pending" if not self.done() else \
            type(self._value).__name__
        return (f"Ticket(id={self.id}, tenant={self.tenant!r}, "
                f"{state})")


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """The flush policy's latency/throughput trade, per engine.

    ``max_wait_s`` is the scheduling-latency SLO knob: the longest any
    admitted request may wait before its bucket launches, even alone.
    ``target_rows`` defines a "full" bucket (the batch size the launch
    economy is tuned for); the effective deadline of a bucket at fill
    fraction f is ``max_wait_s * (1 - f)``, so deadline and fill are one
    coupled policy, not two racing timers."""
    max_wait_s: float = 0.005
    target_rows: int = 32

    def __post_init__(self):
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.target_rows < 1:
            raise ValueError(f"target_rows must be >= 1, got "
                             f"{self.target_rows}")


@dataclasses.dataclass
class _Waiting:
    """One admitted request parked in a flush-policy group."""
    pending: engine._Pending
    ticket: Ticket
    tenant: str
    arrival: float


@dataclasses.dataclass
class _Group:
    """Requests destined for one plan bucket, waiting to launch."""
    key: tuple
    entries: list[_Waiting] = dataclasses.field(default_factory=list)

    @property
    def oldest_arrival(self) -> float:
        """Arrival time of the head entry (appends are in arrival order)."""
        return self.entries[0].arrival

    def due_in(self, now: float, slo: SLOConfig) -> float:
        """Clock seconds until this group's coupled deadline fires
        (0 = due now).  Identity groups are always due -- there is no
        launch to amortise, so there is nothing to wait for."""
        if self.key[0] == "identity":
            return 0.0
        fill = min(1.0, len(self.entries) / slo.target_rows)
        if fill >= 1.0:
            return 0.0
        age = now - self.oldest_arrival
        rem = slo.max_wait_s * (1.0 - fill) - age
        return rem if rem > _DUE_EPS else 0.0


class AsyncGeometryServer:
    """Continuous-batching front-end: async submission, admission
    control, and a clock-driven flush policy over a ``GeometryServer``.

        clock = VirtualClock()            # or MonotonicClock() in prod
        srv = AsyncGeometryServer(clock=clock)   # the GPU; device="cpu"
        t = srv.submit_async(chain, pts, tenant="render")
        ...
        srv.poll()        # launch whatever the policy says is due
        t.result()        # after resolution

    Driving: call ``poll`` from a serving loop at whatever cadence the
    deployment has (each call launches exactly the due groups),
    ``drain`` to launch everything (shutdown, and the sync-equivalence
    path), ``gather(tickets)`` to drive until specific tickets resolve,
    or ``run(*coros)`` to trampoline request-stream coroutines that
    ``await`` tickets.  Per-request fault tolerance is inherited
    unchanged from the inner engine: a ticket resolves to points or to a
    typed error, never silence."""

    def __init__(self, *, device: str | torch.device = "cuda",
                 backend: str | None = None,
                 clock: Clock | None = None,
                 slo: SLOConfig | None = None,
                 admission: AdmissionConfig | None = None,
                 slo_monitor=None,
                 **server_kw):
        self.clock = clock if clock is not None else MonotonicClock()
        self.slo = slo or SLOConfig()
        #: optional ``obs.slo.SLOMonitor`` (any duck with
        #: observe_latency / observe_admission / observe_rejection):
        #: fed at the admission gate and at every resolution, so its
        #: burn-rate arithmetic sees exactly the events the engine's
        #: own telemetry counts.  None (the default) costs one branch
        #: per event -- monitoring, like tracing, is opt-in and must
        #: never steer the serving counters.
        self.slo_monitor = slo_monitor
        self._server = engine.GeometryServer(device=device, backend=backend,
                                             **server_kw)
        self._admission = AdmissionController(
            admission or AdmissionConfig(), self.clock)
        self._groups: dict[tuple, _Group] = {}   # insertion = first arrival
        # telemetry (per engine; deterministic under a VirtualClock):
        # registry-backed -- the ``stats`` property is a back-compat view
        # over these instruments
        self.metrics = obsm.MetricsRegistry("async")
        self._h_latency = self.metrics.histogram(
            "request_latency_s", help="admission-to-resolution seconds")
        self._c_resolved = self.metrics.counter("resolved")
        self._c_failed = self.metrics.counter("failed")
        self._g_depth = self.metrics.gauge("max_queue_depth_seen")
        self._first_arrival: float | None = None
        self._last_resolution: float | None = None
        # last-mirrored admission totals: the module aggregate is bumped
        # by DELTAS so several engines never clobber each other's counts
        self._mirrored = {"queue_full_rejections": 0,
                          "rate_limit_rejections": 0}

    # -- intake --------------------------------------------------------------

    @property
    def server(self) -> engine.GeometryServer:
        """The inner synchronous engine (reports, fault config, injector)."""
        return self._server

    @property
    def queue_depth(self) -> int:
        """Requests currently queued behind admission control."""
        return self._admission.depth

    def submit_async(self, chain, points, *, tenant: str = "default",
                     qformat=None) -> Ticket:
        """Admit + validate one request; returns its awaitable ticket.

        Gate order: admission first (backpressure must shed load BEFORE
        paying per-request validation cost), then the shared validation
        boundary.  Raises the typed taxonomy either way --
        ``QueueFullError`` / ``RateLimitError`` with stable codes for
        backpressure, the intake family for malformed payloads -- so a
        caller's error handling is one ``except RequestError``.  (The
        scene path, ``submit_scene_async``, comes with the scene-graph
        slice, ROADMAP.md queue 1 item 7.)"""
        trc = obst.active()
        sid = trc.begin("request.submit", tenant=tenant) \
            if trc.enabled else None
        try:
            self._admission.admit(tenant)    # raises typed rejection
        except BaseException as e:
            self._mirror_admission_stats()
            if self.slo_monitor is not None:
                self.slo_monitor.observe_rejection()
            if sid is not None:
                trc.end(sid, outcome="rejected",
                        gate="admission",
                        code=getattr(e, "code", type(e).__name__))
            raise
        try:
            p = self._server.validate(chain, points, qformat=qformat)
        except BaseException as e:
            # never queued: the slot (but not the spent rate token --
            # the tenant did submit) goes back
            self._admission.unadmit(tenant)
            if sid is not None:
                trc.end(sid, outcome="rejected", gate="validate",
                        code=getattr(e, "code", type(e).__name__))
            raise
        finally:
            self._mirror_admission_stats()
        now = self.clock.now()
        ticket = Ticket(p.ticket, tenant, now)
        key = self._group_key(p)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(key)
        group.entries.append(_Waiting(p, ticket, tenant, now))
        if self._first_arrival is None:
            self._first_arrival = now
        self._g_depth.track_max(self.queue_depth)
        if self.slo_monitor is not None:
            self.slo_monitor.observe_admission()
        self._server._bump("admitted_requests")
        self.metrics.counter("tenant_requests", labels=("tenant",)) \
            .labels(tenant=tenant).inc()
        if sid is not None:
            trc.end(sid, ticket=p.ticket, outcome="admitted")
        return ticket

    def _group_key(self, p: engine._Pending) -> tuple:
        """The flush-policy grouping key: the engine's own bucket key,
        so policy groups land 1:1 on plan buckets (an identity chain has
        no bucket -- flush passes it through -- and gets its own
        always-due group)."""
        if len(p.chain) == 0:
            return ("identity", p.chain.dim)
        return self._server._bucket_key(p)

    def _mirror_admission_stats(self) -> None:
        """Mirror the controller's rejection counters into the module
        ``serving.stats`` aggregate and this engine's registry by DELTA.
        The old absolute-assignment mirror silently clobbered the
        aggregate when two engines served side by side (last writer
        wins); deltas compose, so the module view is now the true sum
        across engines."""
        ctrl = self._admission
        for name, total in (
                ("queue_full_rejections", ctrl.queue_full_rejections),
                ("rate_limit_rejections", ctrl.rate_limit_rejections)):
            delta = total - self._mirrored[name]
            if delta:
                self._mirrored[name] = total
                self._server._bump(name, delta)

    # -- scheduling ----------------------------------------------------------

    def next_due_in(self) -> float | None:
        """Clock seconds until the earliest group deadline fires (0 =
        something is due now; None = nothing is waiting).  ``gather``
        and the soak driver advance a virtual clock by exactly this."""
        if not self._groups:
            return None
        now = self.clock.now()
        return min(g.due_in(now, self.slo) for g in self._groups.values())

    def poll(self) -> int:
        """Launch every group whose coupled deadline has fired, oldest
        deadline first; returns the number of requests resolved.  One
        inner flush serves all due groups (each is its own plan bucket,
        so deadline order is bucket launch order)."""
        now = self.clock.now()
        due = [g for g in self._groups.values()
               if g.due_in(now, self.slo) <= 0.0]
        due.sort(key=lambda g: g.oldest_arrival)
        trc = obst.active()
        if trc.enabled:
            for g in due:
                # why this group launches NOW: the fill-vs-deadline
                # decision the flush policy just made
                if g.key[0] == "identity":
                    reason = "identity"
                elif len(g.entries) >= self.slo.target_rows:
                    reason = "fill"
                else:
                    reason = "deadline"
                trc.instant("policy.launch", reason=reason,
                            rows=len(g.entries),
                            age=now - g.oldest_arrival,
                            tickets=tuple(e.pending.ticket
                                          for e in g.entries))
        return self._flush_groups(due)

    def drain(self) -> int:
        """Launch EVERYTHING waiting, deadlines notwithstanding
        (shutdown, and the sync-equivalence path): entries are enqueued
        in ticket order -- exactly the order one synchronous flush of
        the same submissions would see -- so a drain reproduces the
        synchronous bucket composition bit for bit."""
        entries = sorted((e for g in self._groups.values()
                          for e in g.entries),
                         key=lambda e: e.pending.ticket)
        trc = obst.active()
        if trc.enabled and entries:
            trc.instant("policy.drain", groups=len(self._groups),
                        rows=len(entries))
        self._groups.clear()
        return self._flush_entries(entries)

    def _flush_groups(self, groups: list[_Group]) -> int:
        entries = [e for g in groups for e in g.entries]
        for g in groups:
            self._groups.pop(g.key, None)
        return self._flush_entries(entries)

    def _flush_entries(self, entries: list[_Waiting]) -> int:
        if not entries:
            return 0
        trc = obst.active()
        launch_at = self.clock.now()
        if trc.enabled:
            # retroactive: each entry's time parked in the policy queue,
            # closed at the instant its bucket was handed to the engine
            for e in entries:
                trc.complete("queue.wait", e.arrival, launch_at,
                             ticket=e.pending.ticket, tenant=e.tenant)
        for e in entries:
            self._server.enqueue(e.pending)
        results = self._server.flush()
        done = self.clock.now()   # monotonic: includes execution time
        for e, res in zip(entries, results):
            e.ticket._resolve(res, done)
            self._admission.release(e.tenant)
            self._h_latency.observe(done - e.arrival)
            if self.slo_monitor is not None:
                self.slo_monitor.observe_latency(done - e.arrival)
            if serrors.is_error(res):
                self._c_failed.inc()
            else:
                self._c_resolved.inc()
        self._last_resolution = done
        return len(entries)

    # -- drivers -------------------------------------------------------------

    def gather(self, tickets: typing.Sequence[Ticket],
               max_steps: int = 1_000_000) -> list:
        """Drive the engine (poll, then advance/sleep to the next
        deadline) until every ticket resolves; returns their results in
        order.  Deterministic under a ``VirtualClock`` -- the clock
        jumps from deadline to deadline, never by an arbitrary tick."""
        for _ in range(max_steps):
            if all(t.done() for t in tickets):
                return [t.result() for t in tickets]
            if self.poll() == 0:
                nd = self.next_due_in()
                if nd is None:
                    raise RuntimeError(
                        "pending tickets but nothing queued: tickets from "
                        "another engine?")
                self.clock.sleep(nd)
        raise RuntimeError(f"gather did not converge in {max_steps} steps")

    def run(self, *coros, max_steps: int = 1_000_000) -> list:
        """Trampoline request-stream coroutines that ``await`` tickets:
        each round steps every live coroutine once, then -- when all of
        them are parked on pending tickets -- polls, advancing the clock
        to the next deadline when nothing is due.  Returns each
        coroutine's return value, in argument order.  This is the async
        consumption shape (``t = srv.submit_async(...); r = await t``)
        without an asyncio loop: the ENGINE owns time, which is what
        keeps a VirtualClock run bit-reproducible."""
        results: list = [None] * len(coros)
        live = {i: c for i, c in enumerate(coros)}
        for _ in range(max_steps):
            if not live:
                return results
            parked = True
            for i, coro in list(live.items()):
                try:
                    waiting_on = coro.send(None)
                except StopIteration as stop:
                    results[i] = stop.value
                    del live[i]
                    parked = False
                else:
                    if not (isinstance(waiting_on, Ticket)
                            and not waiting_on.done()):
                        parked = False   # progressed past an await
            if parked and live:
                if self.poll() == 0:
                    nd = self.next_due_in()
                    if nd is None:
                        raise RuntimeError(
                            "coroutines parked on tickets but nothing is "
                            "queued: awaiting tickets from another engine?")
                    self.clock.sleep(nd)
        raise RuntimeError(f"run did not converge in {max_steps} steps")

    # -- telemetry -----------------------------------------------------------

    @property
    def stats(self) -> dict:
        """This engine's serving telemetry (all values deterministic
        under a ``VirtualClock``): admission counters, queue depth,
        nearest-rank p50/p99 scheduling latency, and sustained
        requests/s over the clock span from first arrival to last
        resolution.  Module-wide launch counters stay in
        ``serving.stats``; this dict is PER ENGINE."""
        ctrl = self._admission
        elapsed = 0.0
        if self._first_arrival is not None \
                and self._last_resolution is not None:
            elapsed = self._last_resolution - self._first_arrival
        h = self._h_latency
        settled = self._c_resolved.value + self._c_failed.value
        return {
            "admitted": ctrl.admitted,
            "queue_full_rejections": ctrl.queue_full_rejections,
            "rate_limit_rejections": ctrl.rate_limit_rejections,
            "queue_depth": ctrl.depth,
            "max_queue_depth_seen": int(self._g_depth.value),
            "waiting_groups": len(self._groups),
            "resolved": self._c_resolved.value,
            "failed": self._c_failed.value,
            "p50_latency_s": h.percentile(50) if h.count else 0.0,
            "p99_latency_s": h.percentile(99) if h.count else 0.0,
            "max_latency_s": h.max if h.count else 0.0,
            "sustained_rps": settled / elapsed if elapsed > 0 else 0.0,
        }

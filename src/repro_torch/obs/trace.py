"""Deterministic span-tree tracing for the serving stack.

A copy of the JAX package's ``repro/obs/trace.py`` (which imports no jax):
the port imports nothing of that package, so it keeps its own.

The paper is a *performance analysis*: its contribution is stage-by-stage
accounting of where cycles and bytes go.  This module gives the
reproduction the same discipline at serving scale -- every request
lifecycle stage (validate -> admission -> queue wait -> bucket assembly
-> pack -> launch attempts -> recovery rungs -> unpack -> resolution)
emits a span into one flat, append-only event stream from which
per-request trees, per-bucket timelines, and exact CI-gateable counts
are all reconstructable.

Design rules (each one is load-bearing):

  * **Injectable clock.**  A ``Tracer`` reads time only through the
    object passed as ``clock=`` -- any ``serving.clock.Clock`` duck
    (``.now() -> float``).  Under a ``serving.clock.VirtualClock`` every
    timestamp, duration, and therefore the entire exported Chrome trace
    is a bit-deterministic function of the seeded workload: two runs
    produce byte-identical JSON, which is what lets CI gate span counts
    EXACTLY (the obs-smoke lane does).  The default is the process
    monotonic clock for real traffic.
  * **Flat stream, reconstructable trees.**  Spans append to one list in
    deterministic id order; parentage comes from a begin/end stack.
    ``span_tree(ticket)`` rebuilds a request's tree after the fact by
    collecting every span tagged with its ticket (``ticket=`` for
    request-scoped spans, ``tickets=`` for bucket-scoped ones whose
    launch covers many requests) and re-nesting by the nearest collected
    ancestor.  Nothing is indexed eagerly -- tracing cost on the hot
    path is one append.
  * **Near-zero cost when off.**  The module-level active tracer
    defaults to a ``NullTracer`` whose ``enabled`` is False; every
    instrumentation hook in the engine guards with a single
    ``if trc.enabled:`` branch, so a disabled build pays one attribute
    load + one branch per hook and allocates nothing.  The acceptance
    contract (pinned by ``tests/test_obs.py`` and the soak benchmark's
    overhead row) is that counters with tracing disabled are
    bit-identical to a build that never imported this module.
  * **Flight recording.**  A tracer may carry a ``recorder`` sink
    (``obs.recorder.FlightRecorder``); every finished span is offered to
    it, so the last-N-events window is always current when a
    ``LaunchError`` post-mortem wants a snapshot.

This module deliberately imports nothing from ``repro_torch.serving`` (the
engine imports *us*; a clock import back into the package would cycle).
Clock compatibility is duck-typed on ``.now()``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import typing

from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass
class Span:
    """One event in the flat stream.  ``t1 is None`` while open;
    ``instant`` marks zero-extent events (``ph: "i"`` in the Chrome
    export).  ``ticket`` tags request-scoped spans; ``tickets`` tags
    bucket/launch-scoped spans covering many requests; ``track`` names
    the export timeline (one per plan bucket, one per recovery ladder)."""
    __slots__ = ("sid", "parent", "name", "t0", "t1", "ticket", "tickets",
                 "track", "instant", "attrs")
    sid: int
    parent: int | None
    name: str
    t0: float
    t1: float | None
    ticket: int | None
    tickets: tuple
    track: str | None
    instant: bool
    attrs: dict

    @property
    def duration(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def as_dict(self) -> dict:
        """A plain-JSON event record (deterministic key order)."""
        d = {"sid": self.sid, "parent": self.parent, "name": self.name,
             "t0": self.t0, "t1": self.t1}
        if self.ticket is not None:
            d["ticket"] = self.ticket
        if self.tickets:
            d["tickets"] = list(self.tickets)
        if self.track is not None:
            d["track"] = self.track
        if self.instant:
            d["instant"] = True
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


@dataclasses.dataclass
class SpanNode:
    """One node of a reconstructed per-request tree."""
    span: Span
    children: list["SpanNode"] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return self.span.name

    def walk(self) -> typing.Iterator[Span]:
        yield self.span
        for c in self.children:
            yield from c.walk()


class NullTracer:
    """The disabled default: every hook sees ``enabled == False`` and
    skips its span emission behind one branch.  The methods still exist
    (as no-ops) so non-hot-path call sites may skip the guard."""

    enabled = False
    recorder = None
    spans: tuple = ()

    def begin(self, name: str, **kw) -> int:
        return -1

    def end(self, sid: int, **kw) -> None:
        pass

    def instant(self, name: str, **kw) -> None:
        pass

    def complete(self, name: str, t0: float, t1: float, **kw) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str, **kw):
        yield -1


class Tracer:
    """The live tracer: a flat append-only span stream with stack-based
    parenting and sequential ids.

        trc = Tracer(clock=VirtualClock())
        sid = trc.begin("flush")
        trc.instant("launch", tickets=(0, 1), backend="ref")
        trc.end(sid, buckets=2)
        trc.span_tree(0)     # -> [SpanNode, ...] roots for ticket 0

    ``begin``/``end`` nest via an explicit stack (the engine's phases are
    strictly nested, so a stack is sufficient and allocation-free);
    ``complete`` records a retroactive span (queue-wait spans are known
    only once the wait is over); ``instant`` records a zero-extent event.
    Keyword arguments become span attributes except the reserved
    ``ticket`` / ``tickets`` / ``track`` tags."""

    enabled = True

    def __init__(self, clock=None, recorder=None):
        #: any ``.now() -> float`` duck; serving.clock.Clock instances
        #: qualify, and a VirtualClock makes the stream deterministic
        self.clock = clock
        self._now = clock.now if clock is not None else time.monotonic
        #: optional FlightRecorder sink offered every finished span
        self.recorder = recorder
        self.spans: list[Span] = []
        self._stack: list[int] = []
        #: the counters traced work adds at its span boundaries
        #: (``obs.steps``: the serve step's MoE entries, by phase)
        self.metrics = MetricsRegistry("trace")

    def now(self) -> float:
        """The tracer's clock."""
        return self._now()

    # -- emission ------------------------------------------------------------

    def _push(self, name: str, t0: float, t1: float | None, instant: bool,
              ticket, tickets, track, attrs: dict) -> Span:
        s = Span(sid=len(self.spans),
                 parent=self._stack[-1] if self._stack else None,
                 name=name, t0=t0, t1=t1, ticket=ticket,
                 tickets=tuple(tickets) if tickets else (),
                 track=track, instant=instant, attrs=attrs)
        self.spans.append(s)
        if t1 is not None and self.recorder is not None:
            self.recorder.record(s)
        return s

    def begin(self, name: str, *, ticket=None, tickets=(), track=None,
              **attrs) -> int:
        """Open a span; returns its id for the matching ``end``."""
        s = self._push(name, self._now(), None, False,
                       ticket, tickets, track, attrs)
        self._stack.append(s.sid)
        return s.sid

    def end(self, sid: int, *, ticket=None, **attrs) -> None:
        """Close span ``sid``; late keyword arguments merge into its
        attributes (outcomes are usually known only at the end), and a
        late ``ticket=`` tags a span whose request id was assigned after
        it opened (the async submit span)."""
        s = self.spans[sid]
        s.t1 = self._now()
        if attrs:
            s.attrs.update(attrs)
        if ticket is not None:
            s.ticket = ticket
        # the engine's phases close in strict LIFO order; tolerate an
        # out-of-order close (exception unwind paths) by popping through
        while self._stack and self._stack[-1] != sid:
            self._stack.pop()
        if self._stack:
            self._stack.pop()
        if self.recorder is not None:
            self.recorder.record(s)

    def instant(self, name: str, *, ticket=None, tickets=(), track=None,
                **attrs) -> None:
        """A zero-extent event at now (launch dispatches, policy
        decisions, resolutions)."""
        t = self._now()
        self._push(name, t, t, True, ticket, tickets, track, attrs)

    def complete(self, name: str, t0: float, t1: float, *, ticket=None,
                 tickets=(), track=None, **attrs) -> None:
        """A retroactive span over ``[t0, t1]`` (queue waits: the span is
        only known once the wait ends)."""
        self._push(name, t0, t1, False, ticket, tickets, track, attrs)

    @contextlib.contextmanager
    def span(self, name: str, **kw):
        """``with trc.span("flush"):`` -- begin/end with unwind safety."""
        sid = self.begin(name, **kw)
        try:
            yield sid
        finally:
            if self.spans[sid].t1 is None:
                self.end(sid)

    # -- derived views -------------------------------------------------------

    @property
    def n_events(self) -> int:
        """Every emitted record, instants included."""
        return len(self.spans)

    @property
    def n_spans(self) -> int:
        """Extent-carrying spans only (instants excluded)."""
        return sum(1 for s in self.spans if not s.instant)

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)

    def tickets_seen(self) -> list[int]:
        seen: set[int] = set()
        for s in self.spans:
            if s.ticket is not None:
                seen.add(s.ticket)
            seen.update(s.tickets)
        return sorted(seen)

    def spans_for(self, ticket: int) -> list[Span]:
        """Every span touching this ticket, in stream (= time) order."""
        return [s for s in self.spans
                if s.ticket == ticket or ticket in s.tickets]

    def span_tree(self, ticket: int) -> list[SpanNode]:
        """Reconstruct the request's tree from the flat stream: collect
        its spans, then nest each under its nearest collected ancestor
        (spans of OTHER requests in between -- a shared flush span's
        other buckets -- drop out, so the tree is this request's view).
        Returns the roots (submission and flush epochs are disjoint, so
        one request usually has 2-3 roots: validate, queue wait, and its
        flush-side spans)."""
        mine = self.spans_for(ticket)
        by_sid = {s.sid: s for s in mine}
        nodes = {s.sid: SpanNode(s) for s in mine}
        roots: list[SpanNode] = []
        for s in mine:
            p = s.parent
            while p is not None and p not in by_sid:
                p = self.spans[p].parent
            if p is None:
                roots.append(nodes[s.sid])
            else:
                nodes[p].children.append(nodes[s.sid])
        return roots


# -- the ambient tracer -------------------------------------------------------

_NULL = NullTracer()
_ACTIVE: NullTracer | Tracer = _NULL


def active() -> NullTracer | Tracer:
    """The ambient tracer every instrumentation hook consults.  Defaults
    to the shared ``NullTracer`` (one branch per hook, zero allocation)."""
    return _ACTIVE


def install(tracer: Tracer | None) -> None:
    """Install (or, with ``None``, uninstall) the ambient tracer."""
    global _ACTIVE
    _ACTIVE = tracer if tracer is not None else _NULL


@contextlib.contextmanager
def installed(tracer: Tracer | None):
    """Scoped install: the previous ambient tracer is restored on exit
    (benchmarks trace one soak without leaking into the next)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else _NULL
    try:
        yield tracer
    finally:
        _ACTIVE = prev

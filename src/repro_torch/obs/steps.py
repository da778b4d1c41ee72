"""Spans and counts of the model's layers inside a serve step, and the
serve's phases on the profiler's clock.

Layer spans.  ``region(name, **attrs)`` brackets a part of a model
step (``embed``, ``layer``, ``norm``, ``attention``, ``attention.core``,
``ssm``, ``ffn``, ``moe.route`` ...) and ``armed().count(name, value)``
adds to a counter at the same boundary.  Both do nothing -- one branch --
unless a ``StepSpans`` is armed for the step (``recording``), which
``launch.serve`` does only while an ``obs.Tracer`` is installed and
off a mesh.  On the card each edge is a timed CUDA event made with
``external=True``: recorded during a CUDA graph's capture it becomes an
event-record node of the graph, so every replay times each region on
the device, and the Python here runs only during the eager first step
and the capture, never in a replay.  On the CPU an edge is the host
clock.  A count is a Python int known when the step is recorded (once a
run) or a 0-d tensor added on the device into a buffer the ``StepSpans``
owns (so a replay adds it again); ``take_counts`` reads the buffers
once.  After a step ran and the device finished it, ``emit`` puts its
regions into the tracer through ``Tracer.complete``, on the tracer's
clock by one ``Anchor`` (a synchronise, then an event and the tracer's
clock read together).

Serve phases.  ``phase(name, **attrs)`` opens a host range of
``torch.profiler`` while it records (so the range lands in the same
trace as the card's kernels) and a span of the installed tracer; with
neither, it is one branch.  The range is a host op
(``_RecordFunctionFast``), not ``record_function``'s user annotation:
the profiler mirrors a user annotation onto the device's timeline over
the kernels it launched, and a reader of device activity would count
that span, idle gaps and all, as device work.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.obs import trace

#: the ``StepSpans`` armed for the step being recorded (``recording``)
_ARMED: "StepSpans | None" = None
_NULL = contextlib.nullcontext()
#: the tracks of the prefill's and the decode step's layer spans
TRACKS = ("prefill", "decode")
#: the spans that cover a step one after another (none inside another)
TOP = ("reset", "embed", "encoder", "layer", "head", "greedy")


class _Region:
    __slots__ = ("rec", "i")

    def __init__(self, rec: "StepSpans", name: str, attrs: dict):
        self.rec = rec
        self.i = rec.open(name, attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec.close(self.i)


def region(name: str, **attrs):
    """A span of the armed step around the ``with`` body; children take
    their parent's attributes (a ``layer``'s index)."""
    rec = _ARMED
    return _NULL if rec is None else _Region(rec, name, attrs)


def armed() -> "StepSpans | None":
    """The ``StepSpans`` armed for the step being recorded, if any: a
    count costs device work, so a layer counts only into an armed one."""
    return _ARMED


@contextlib.contextmanager
def recording(rec: "StepSpans"):
    """Arm ``rec`` for the step run (or captured) inside: its regions are
    recorded anew, its device buffers keep their sums."""
    global _ARMED
    rec.reset()
    prev, _ARMED = _ARMED, rec
    try:
        yield rec
    finally:
        _ARMED = prev


class StepSpans:
    """The regions and counts of one step: of an eager run, or of a CUDA
    graph (recorded at its capture, re-timed by each replay).
    ``regions`` holds [name, attrs, start edge, end edge] in the order
    they opened, so a parent comes before its children."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.regions: list = []
        self._host: dict = {}        # name -> int a run
        self._device: dict = {}      # name -> 0-d int64 buffer
        self._stack: list = []
        self._events: list = []      # reused run after run
        self._used = 0

    def reset(self) -> None:
        self.regions, self._host, self._stack = [], {}, []
        self._used = 0

    def _edge(self):
        """One region edge: a timed CUDA event recorded on the current
        stream (an event-record node under a capture), or the host
        clock.  The events of the eager run are recorded again by the
        capture that follows it, so none is created under a capture."""
        if not self.cuda:
            return time.perf_counter()
        if self._used == len(self._events):
            self._events.append(torch.cuda.Event(enable_timing=True,
                                                 external=True))
        ev = self._events[self._used]
        self._used += 1
        ev.record()
        return ev

    def open(self, name: str, attrs: dict) -> int:
        if self._stack:
            attrs = {**self.regions[self._stack[-1]][1], **attrs}
        self.regions.append([name, attrs, self._edge(), None])
        self._stack.append(len(self.regions) - 1)
        return self._stack[-1]

    def close(self, i: int) -> None:
        self.regions[i][3] = self._edge()
        self._stack.pop()

    def count(self, name: str, value) -> None:
        if not isinstance(value, torch.Tensor):
            self._host[name] = self._host.get(name, 0) + int(value)
            return
        buf = self._device.get(name)
        if buf is None:
            if self.cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"counter {name!r} first counted under a capture: its "
                    "buffer would be zeroed by every replay")
            buf = self._device[name] = torch.zeros(
                (), dtype=torch.int64, device=value.device)
        buf.add_(value)

    def emit(self, tracer, anchor: "Anchor", track: str, **attrs) -> None:
        """The last run's regions as spans of ``tracer`` on ``track``
        (waits for the device), and its per-run counts into
        ``tracer.metrics`` labelled by ``phase=track``."""
        if self.cuda:
            torch.cuda.synchronize()
        for name, own, a, b in self.regions:
            tracer.complete(name, anchor.at(a), anchor.at(b), track=track,
                            **{**attrs, **own})
        for name, n in self._host.items():
            _counter(tracer, name, track).inc(n)

    def take_counts(self, tracer, track: str) -> None:
        """Add the device buffers' sums into ``tracer.metrics`` labelled
        by ``phase=track`` and zero them (one read)."""
        for name, buf in self._device.items():
            _counter(tracer, name, track).inc(int(buf))
            buf.zero_()


def _counter(tracer, name: str, track: str):
    return tracer.metrics.counter(name, labels=("phase",)).labels(
        phase=track)


class Anchor:
    """A moment read on the device (an event, after a synchronise) and on
    the tracer's clock together; ``at(edge)`` puts a region edge on the
    tracer's clock."""

    def __init__(self, tracer, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            torch.cuda.synchronize()
            self.edge = torch.cuda.Event(enable_timing=True)
            self.edge.record()
            self.edge.synchronize()
        else:
            self.edge = time.perf_counter()
        # read last: the edges land no earlier than they were
        self.now = tracer.now()

    def at(self, edge) -> float:
        if self.cuda:
            return self.now + self.edge.elapsed_time(edge) * 1e-3
        return self.now + (edge - self.edge)


class _Phase:
    __slots__ = ("name", "attrs", "tracer", "sid", "range")

    def __init__(self, tracer, name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.sid = self.range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        if self.tracer.enabled:
            self.sid = self.tracer.begin(self.name, **self.attrs)
        return self

    def __exit__(self, *exc):
        if self.sid is not None:
            self.tracer.end(self.sid)
        if self.range is not None:
            self.range.__exit__(*exc)


def phase(name: str, **attrs):
    """A serve phase around the ``with`` body: a host range while
    ``torch.profiler`` records, a span of the installed tracer while one
    is; otherwise nothing."""
    tracer = trace.active()
    if not (tracer.enabled or torch.autograd._profiler_enabled()):
        return _NULL
    return _Phase(tracer, name, attrs)


def summary(tracer) -> dict:
    """The layer spans a tracer holds, by ``(track, prompt, graph)``
    (``graph``: replays, not eager runs): ``steps`` the steps run, ``ms``
    each span name's ms a step (every layer's summed), ``step_ms`` the
    mean ms from a step's first edge to its last, ``top_share`` the least
    share of that under the ``TOP`` spans; and under ``"counts"`` the
    tracer's counters, by name and phase.  A step is a run of spans of
    one track and step index that no other span interrupts (``emit``
    puts one step's in a row)."""
    groups, key = [], None
    for s in tracer.spans:
        if s.track not in TRACKS:
            key = None
            continue
        k = (s.track, s.attrs.get("prompt"), s.attrs.get("graph"),
             s.attrs.get("step"))
        if k != key:
            groups.append([])
            key = k
        groups[-1].append(s)
    out: dict = {}
    for g in groups:
        a = g[0].attrs
        d = out.setdefault((g[0].track, a.get("prompt"), a.get("graph")),
                           {"steps": 0, "ms": {}, "step_ms": 0.0,
                            "top_share": 1.0})
        whole = max(s.t1 for s in g) - min(s.t0 for s in g)
        top = sum(s.t1 - s.t0 for s in g if s.name in TOP)
        d["steps"] += 1
        d["step_ms"] += whole * 1e3
        d["top_share"] = min(d["top_share"], top / whole if whole > 0
                             else 1.0)
        for s in g:
            d["ms"][s.name] = d["ms"].get(s.name, 0.0) + (s.t1 - s.t0) * 1e3
    for d in out.values():
        d["step_ms"] /= d["steps"]
        d["ms"] = {k: v / d["steps"] for k, v in d["ms"].items()}
    out["counts"] = {name: {k[0]: c.value for k, c in fam.children.items()}
                     for name, fam in tracer.metrics.families.items()}
    return out

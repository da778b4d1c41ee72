"""Flight recorder: a bounded ring buffer over the span stream for
post-mortems.

A copy of the JAX package's ``repro/obs/recorder.py`` (which imports no jax):
the port imports nothing of that package, so it keeps its own.

A full trace of a long soak is hundreds of thousands of events; what a
failure investigation actually needs is the last N events *leading into*
the failure.  The ``FlightRecorder`` is that window: attach one to a
``Tracer`` (``Tracer(recorder=...)``) and every finished span lands in a
``deque(maxlen=capacity)`` -- O(1) per event, bounded memory no matter
how long the process runs.

Consumers:

  * the serving engine snapshots the recorder into every terminal
    ``LaunchError`` resolution (``err.flight``) -- the request that
    exhausted its recovery ladder carries the event window that led
    there;
  * ``serving.faults.run_chaos_soak`` runs under a recorder-equipped
    tracer and attaches per-bucket recovery post-mortems to its
    ``ChaosReport`` (``report.postmortems``), so a chaos failure in CI
    is debuggable from the report alone.

Snapshots are lists of plain-JSON event dicts (``Span.as_dict``), cheap
to embed in error objects and reports and safe to serialize.
"""
from __future__ import annotations

import collections


class FlightRecorder:
    """Last-N-events window over a tracer's finished spans."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        #: total events ever offered (recorded - len(buffer) = dropped)
        self.recorded = 0

    def record(self, span) -> None:
        """Sink hook called by the tracer for every finished span."""
        self._buf.append(span)
        self.recorded += 1

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def snapshot(self) -> list[dict]:
        """The window as plain-JSON event dicts, oldest first."""
        return [s.as_dict() for s in self._buf]

    def clear(self) -> None:
        self._buf.clear()
        self.recorded = 0

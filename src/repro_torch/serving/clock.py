"""Injectable clocks: every timing decision in the serving stack flows
through a ``Clock`` so schedulers are testable as pure functions of time.

A copy of the JAX package's ``repro/serving/clock.py`` (which imports no jax):
the port imports nothing of that package, so it keeps its own.

Schedulers are where correctness quietly dies: a flush policy that reads
``time.monotonic()`` directly can only be tested statistically, and its
latency telemetry is noise on a loaded CI host.  The continuous-batching
front-end (``serving.async_engine``) therefore never touches the wall
clock -- it asks an injected ``Clock`` instead:

  * ``MonotonicClock`` -- production: ``time.monotonic`` / ``time.sleep``.
  * ``VirtualClock``   -- tests and the seeded soak benchmark: time is a
    number that moves only when the test (or the soak's arrival script)
    says so.  Every scheduling decision, deadline expiry, and latency
    sample becomes a deterministic function of the arrival script, so
    p50/p99 values can be pinned against hand-computed numbers and the
    soak's latency telemetry sits in the exact-match CI gate.

``percentile`` is the shared nearest-rank estimator -- the ONE
definition, so hand-computed test values, engine telemetry, and
benchmark rows cannot disagree about what "p99" means.  It lives in
``repro_torch.obs.metrics`` (the metrics layer's histograms consume it too)
and is re-exported here unchanged for the serving-side callers.
"""
from __future__ import annotations

import abc
import time

from repro_torch.obs.metrics import percentile


class Clock(abc.ABC):
    """The timing interface the serving schedulers consume."""

    @abc.abstractmethod
    def now(self) -> float:
        """Seconds on this clock's timeline (monotone, arbitrary epoch)."""

    @abc.abstractmethod
    def sleep(self, seconds: float) -> None:
        """Block (or virtually advance) for ``seconds`` (clamped >= 0)."""


class MonotonicClock(Clock):
    """Real time: ``time.monotonic`` / ``time.sleep`` (production traffic)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock(Clock):
    """Deterministic simulated time: ``now`` moves only via ``advance`` /
    ``sleep``.  Never goes backwards; advancing by a negative amount is a
    caller bug and raises rather than silently rewinding history."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        """Move time forward by ``seconds``; returns the new now."""
        if seconds < 0:
            raise ValueError(f"cannot advance a clock by {seconds} s")
        self._now += float(seconds)
        return self._now

    def advance_to(self, t: float) -> float:
        """Move time forward to the absolute instant ``t`` (no-op when
        ``t`` is already in the past: arrival scripts may round)."""
        if t > self._now:
            self._now = float(t)
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self.advance(seconds)


__all__ = ["Clock", "MonotonicClock", "VirtualClock", "percentile"]

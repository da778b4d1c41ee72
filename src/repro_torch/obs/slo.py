"""Multi-window burn-rate SLO monitoring over the serving error budget.

A copy of the JAX package's ``repro/obs/slo.py`` (which imports no jax):
the port imports nothing of that package, so it keeps its own.

An SLO ("99% of requests resolve inside the scheduling deadline") defines
an error budget: the 1% of requests ALLOWED to be bad.  The monitor
tracks how fast that budget is being spent -- the **burn rate**, bad
fraction in a trailing window divided by the budget fraction -- and
fires an alert only when the burn is high on a LONG window (the spend is
sustained, not a blip) AND on a SHORT window (it is still happening
right now).  That is the multi-window pattern production SRE practice
settled on: the long window keeps one bad bucket from paging, the short
window un-pages the moment the bleeding stops.

Two objectives, matching the async front-end's ``SLOConfig`` contract:

  * ``latency`` -- a resolved request is *bad* when its
    admission-to-resolution latency exceeds the threshold (defaults to
    the engine's ``max_wait_s``: the scheduling-latency SLO knob).
  * ``rejections`` -- a submission is *bad* when admission refuses it
    (queue-full / rate-limit); admitted submissions are the good events.

**Determinism is the design driver** (same rule as the tracer): the
monitor reads time ONLY through the injectable clock, so under a
``serving.clock.VirtualClock`` every burn-rate value, alert firing
instant, and resolution instant is a bit-deterministic function of the
arrival script -- ``tests/test_slo.py`` pins firing times to exact
virtual seconds, and the ``slo_burn_smoke`` benchmark row gates them.
Alert state lives in a ``MetricsRegistry`` (``slo_*`` instruments), so
the existing ``obs.export.prometheus_text`` exposes it unchanged.

Wiring::

    clock = VirtualClock()
    mon = SLOMonitor(clock, latency_slo_s=0.02)
    eng = AsyncGeometryServer(clock=clock, slo_monitor=mon, ...)
    ...serve...
    print(prometheus_text(mon.metrics))     # slo_alert_active{...} etc.
"""
from __future__ import annotations

import collections
import dataclasses
import typing

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs import trace as obst

#: the objective label values (the one label dimension of every slo_*
#: instrument)
LATENCY = "latency"
REJECTIONS = "rejections"


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One (long, short) window pair: the alert condition is
    ``burn(long) >= threshold AND burn(short) >= threshold``.  A burn
    of 1.0 spends exactly the budget over the window; the classic page
    thresholds (14.4 over 1h/5m, 6 over 6h/30m) scale to whatever
    timescale the deployment's windows use."""
    long_s: float
    short_s: float
    threshold: float

    def __post_init__(self):
        if not 0 < self.short_s <= self.long_s:
            raise ValueError(
                f"windows must satisfy 0 < short <= long, got "
                f"{self.short_s}/{self.long_s}")
        if self.threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")


#: the SRE-book pairs, on their canonical hour scale; virtual-clock
#: tests and the soak pass second-scale rules explicitly
DEFAULT_RULES = (BurnRule(long_s=3600.0, short_s=300.0, threshold=14.4),
                 BurnRule(long_s=21600.0, short_s=1800.0, threshold=6.0))


@dataclasses.dataclass
class AlertState:
    """One objective's alert: current activity plus the full transition
    history (virtual-clock instants -- pinnable)."""
    objective: str
    active: bool = False
    fired_at: list[float] = dataclasses.field(default_factory=list)
    resolved_at: list[float] = dataclasses.field(default_factory=list)

    @property
    def fired(self) -> int:
        return len(self.fired_at)


class SLOMonitor:
    """Error-budget accounting for one serving engine.

    Feed it events (``observe_latency`` / ``observe_admission`` /
    ``observe_rejection``); it timestamps each through the injectable
    clock, maintains the trailing windows, and re-evaluates the burn
    rules on every event -- so an alert fires AT the event that crossed
    the threshold, a deterministic instant under a virtual clock.
    """

    def __init__(self, clock, *, latency_slo_s: float,
                 latency_target: float = 0.99,
                 rejection_target: float = 0.99,
                 rules: typing.Sequence[BurnRule] = DEFAULT_RULES,
                 registry: MetricsRegistry | None = None):
        if not rules:
            raise ValueError("SLOMonitor needs at least one BurnRule")
        for name, target in (("latency", latency_target),
                             ("rejection", rejection_target)):
            if not 0 < target < 1:
                raise ValueError(f"{name}_target must be in (0, 1), "
                                 f"got {target}")
        self.clock = clock
        self.latency_slo_s = latency_slo_s
        self.rules = tuple(rules)
        self.targets = {LATENCY: latency_target,
                        REJECTIONS: rejection_target}
        self._horizon = max(r.long_s for r in self.rules)
        #: per-objective event windows: (t, bad) in time order
        self._events: dict[str, collections.deque] = {
            LATENCY: collections.deque(), REJECTIONS: collections.deque()}
        self.alerts = {LATENCY: AlertState(LATENCY),
                       REJECTIONS: AlertState(REJECTIONS)}
        self.metrics = registry if registry is not None \
            else MetricsRegistry("slo")
        self._c_events = self.metrics.counter(
            "events", help="SLO-classified events", labels=("objective",))
        self._c_bad = self.metrics.counter(
            "bad_events", help="events that spent error budget",
            labels=("objective",))
        self._c_fired = self.metrics.counter(
            "alerts_fired", help="alert activations",
            labels=("objective",))
        self._g_active = self.metrics.gauge(
            "alert_active", help="1 while the alert is firing",
            labels=("objective",))
        self._g_burn = self.metrics.gauge(
            "burn_rate", help="budget burn over the trailing window",
            labels=("objective", "window"))

    # -- event intake ---------------------------------------------------------

    def observe_latency(self, latency_s: float) -> None:
        """One resolved request; bad when it blew the latency SLO."""
        self._observe(LATENCY, bad=latency_s > self.latency_slo_s)

    def observe_admission(self) -> None:
        """One admitted submission (a good rejection-objective event)."""
        self._observe(REJECTIONS, bad=False)

    def observe_rejection(self) -> None:
        """One refused submission (queue-full / rate-limit): budget
        spend on the rejection objective."""
        self._observe(REJECTIONS, bad=True)

    def _observe(self, objective: str, *, bad: bool) -> None:
        now = self.clock.now()
        events = self._events[objective]
        events.append((now, bad))
        cutoff = now - self._horizon
        while events and events[0][0] < cutoff:
            events.popleft()
        self._c_events.labels(objective=objective).inc()
        if bad:
            self._c_bad.labels(objective=objective).inc()
        self._evaluate(objective, now)

    # -- burn arithmetic ------------------------------------------------------

    def bad_fraction(self, objective: str, window_s: float,
                     now: float | None = None) -> float:
        """Bad events / all events over the trailing window (0.0 when
        the window is empty: an idle engine spends no budget)."""
        now = self.clock.now() if now is None else now
        cutoff = now - window_s
        total = bad = 0
        for t, b in self._events[objective]:
            if t >= cutoff:
                total += 1
                bad += b
        return bad / total if total else 0.0

    def burn_rate(self, objective: str, window_s: float,
                  now: float | None = None) -> float:
        """Budget burn over the window: 1.0 = spending exactly the
        budget, N = burning it N times too fast."""
        budget = 1.0 - self.targets[objective]
        return self.bad_fraction(objective, window_s, now) / budget

    def _evaluate(self, objective: str, now: float) -> None:
        burns: dict[float, float] = {}

        def burn(w: float) -> float:
            if w not in burns:
                burns[w] = self.burn_rate(objective, w, now)
            return burns[w]

        firing = any(burn(r.long_s) >= r.threshold
                     and burn(r.short_s) >= r.threshold
                     for r in self.rules)
        # export the burn gauges for every window the rules read
        for r in self.rules:
            for w in (r.long_s, r.short_s):
                self._g_burn.labels(objective=objective,
                                    window=f"{w:g}s").set(burn(w))
        alert = self.alerts[objective]
        if firing and not alert.active:
            alert.active = True
            alert.fired_at.append(now)
            self._c_fired.labels(objective=objective).inc()
            self._g_active.labels(objective=objective).set(1)
            trc = obst.active()
            if trc.enabled:
                trc.instant("slo.fire", objective=objective,
                            burn=max(burns.values()))
        elif not firing and alert.active:
            alert.active = False
            alert.resolved_at.append(now)
            self._g_active.labels(objective=objective).set(0)
            trc = obst.active()
            if trc.enabled:
                trc.instant("slo.resolve", objective=objective)

    # -- reads ----------------------------------------------------------------

    def counters(self) -> dict:
        """The deterministic summary (virtual-clock instants in µs, so
        they survive a round trip through benchmark rows exactly)."""
        out = {}
        for obj, alert in sorted(self.alerts.items()):
            out[f"{obj}_alerts_fired"] = alert.fired
            out[f"{obj}_alert_active"] = int(alert.active)
            out[f"{obj}_bad_events"] = \
                self.metrics.value("bad_events", objective=obj)
            out[f"{obj}_events"] = \
                self.metrics.value("events", objective=obj)
            if alert.fired_at:
                out[f"{obj}_first_fire_us"] = \
                    round(alert.fired_at[0] * 1e6, 1)
            if alert.resolved_at:
                out[f"{obj}_first_resolve_us"] = \
                    round(alert.resolved_at[0] * 1e6, 1)
        return out

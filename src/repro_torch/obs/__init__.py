"""Observability of the port: deterministic tracing, typed metrics,
exporters, a flight recorder and the SLO burn-rate monitor.

The modules are copies of the JAX package's ``repro/obs`` modules of the
same names (which import no jax): the port imports nothing of that
package, so it keeps its own.

  * ``obs.trace``    -- span-tree tracer with an injectable clock; under
    ``serving.clock.VirtualClock`` every timestamp and span count is
    bit-deterministic.  Disabled by default (``NullTracer``): each engine
    hook is one branch.
  * ``obs.metrics``  -- typed registry (counters / gauges / histograms
    with the shared nearest-rank ``percentile``) behind the serving
    stack's ``stats`` views, with labeled dimensions (tenant, plan kind,
    backend, dtype/qformat, size class).
  * ``obs.export``   -- Chrome-trace-event JSON (Perfetto: one track per
    plan bucket + one per recovery ladder) and Prometheus text
    exposition.
  * ``obs.recorder`` -- bounded ring-buffer flight recorder dumped into
    ``LaunchError`` / chaos post-mortems.
  * ``obs.slo``      -- multi-window burn-rate alerting over the latency
    and rejection error budgets, deterministic under a virtual clock.

Not ported yet: ``obs.profile`` (``Profile``, ``LaunchGroup``, ...) folds
the autotune cost model's per-launch predictions, so it comes with the
autotune slice (ROADMAP.md queue 1 item 5), and ``obs.bench_history``
reads the benchmark record, which waits for item 9.  Their names raise
``NotPortedError``.

Quickstart::

    from repro_torch import obs
    from repro_torch.serving.clock import VirtualClock

    trc = obs.Tracer(clock=VirtualClock(),
                     recorder=obs.FlightRecorder(256))
    with obs.installed(trc):
        ...serve...
    obs.dump_chrome_trace(trc, "out.json")       # open in Perfetto
    print(obs.prometheus_text(my_registry))
"""
from repro_torch.errors import NotPortedError
from repro_torch.obs.export import (chrome_trace, chrome_trace_events,
                                    dump_chrome_trace, prometheus_text)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatsView, percentile)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import (NullTracer, Span, SpanNode, Tracer, active,
                                   install, installed)

#: the SLO monitor resolves lazily (PEP 562), as in the JAX package
_LAZY = {"BurnRule": "slo", "SLOMonitor": "slo"}

#: the analysis layer's names that come with a later slice
_NOT_PORTED = {"LaunchGroup", "Profile", "ProfileNode", "dump_span_stream",
               "load_span_stream"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotPortedError(f"repro_torch.obs.{name} (obs/profile.py)",
                             "queue 1 item 5 (autotune)")
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    value = getattr(importlib.import_module(f"repro_torch.obs.{submodule}"),
                    name)
    globals()[name] = value
    return value


__all__ = [
    "BurnRule", "Counter", "FlightRecorder", "Gauge", "Histogram",
    "MetricsRegistry", "NullTracer", "SLOMonitor", "Span", "SpanNode",
    "StatsView", "Tracer", "active", "chrome_trace", "chrome_trace_events",
    "dump_chrome_trace", "install", "installed", "percentile",
    "prometheus_text",
]

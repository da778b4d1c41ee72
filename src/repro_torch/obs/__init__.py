"""Observability of the port: deterministic tracing, typed metrics,
exporters, a flight recorder, the cost-model-attributed profiler and the
SLO burn-rate monitor.

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
  * ``obs.profile``  -- folds a traced run's span stream into a
    self/child attribution tree and per-kernel launch tables, with the
    cost model's per-launch predictions (attached at dispatch time)
    compared against observed traffic; ``python -m
    repro_torch.obs.profile``.
  * ``obs.slo``      -- multi-window burn-rate alerting over the latency
    and rejection error budgets, deterministic under a virtual clock.

Not ported: ``obs.bench_history``, which reads the JAX package's
benchmark record (ROADMAP.md queue 1 item 9).

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
from repro_torch.obs.export import (chrome_trace, chrome_trace_events,
                                    dump_chrome_trace, prometheus_text)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatsView, percentile)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import (NullTracer, Span, SpanNode, Tracer, active,
                                   install, installed)

#: the analysis layer resolves lazily (PEP 562), as in the JAX package:
#: ``obs.profile`` is also a ``python -m`` entry point, and an eager
#: package-level import of it would trip runpy's double-import warning
_LAZY = {
    "LaunchGroup": "profile", "Profile": "profile",
    "ProfileNode": "profile", "dump_span_stream": "profile",
    "load_span_stream": "profile",
    "BurnRule": "slo", "SLOMonitor": "slo",
}


def __getattr__(name):
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
    "LaunchGroup", "MetricsRegistry", "NullTracer", "Profile",
    "ProfileNode", "SLOMonitor", "Span", "SpanNode", "StatsView", "Tracer",
    "active", "chrome_trace", "chrome_trace_events", "dump_chrome_trace",
    "dump_span_stream", "install", "installed", "load_span_stream",
    "percentile", "prometheus_text",
]

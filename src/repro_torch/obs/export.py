"""Exporters: Chrome-trace-event JSON (Perfetto-loadable) and Prometheus
text exposition.

A copy of the JAX package's ``repro/obs/export.py`` (which imports no jax):
the port imports nothing of that package, so it keeps its own.

The Chrome export maps the flat span stream onto the trace-event format
(one ``"X"`` complete event per extent span, one ``"i"`` instant event
per instant), with one *track* (tid) per span ``track`` tag -- the
engine tags bucket-scoped spans with their bucket signature and recovery
spans with ``recovery:<bucket>``, so Perfetto renders one timeline per
plan bucket plus one per recovery ladder, with request-scoped spans on
the main track.  Timestamps are clock seconds scaled to the format's
microseconds; under a ``VirtualClock`` they are exact rationals of the
seed, so the serialized file is byte-identical across runs -- the
obs-smoke CI lane diffs two independent runs and the committed trace.

The Prometheus exposition is the standard text format, families sorted
by name and label sets sorted by value tuple, so the output is also
deterministic and snapshot-gateable.  Histograms render as real
cumulative histograms -- ``_bucket{le="<bound>"}`` series over
``Histogram.BOUNDS`` ending in ``le="+Inf"``, then ``_sum`` and
``_count`` -- so downstream ``histogram_quantile()`` works on the
scrape, not just on our nearest-rank summaries.
"""
from __future__ import annotations

import json

from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import NullTracer, Tracer

#: the track instant/request-scoped spans land on when untagged
MAIN_TRACK = "serve"


def chrome_trace_events(tracer: Tracer | NullTracer,
                        pid: int = 1) -> list[dict]:
    """The ``traceEvents`` list: thread-name metadata first (tracks in
    first-seen order, so tids are deterministic), then one event per
    span in stream order."""
    tids: dict[str, int] = {}

    def tid_of(track: str | None) -> int:
        name = track if track is not None else MAIN_TRACK
        if name not in tids:
            tids[name] = len(tids)
        return tids[name]

    events: list[dict] = []
    for s in tracer.spans:
        args: dict = {}
        if s.ticket is not None:
            args["ticket"] = s.ticket
        if s.tickets:
            args["tickets"] = list(s.tickets)
        args.update(s.attrs)
        ev = {"name": s.name, "ph": "i" if s.instant else "X",
              "ts": round(s.t0 * 1e6, 3), "pid": pid,
              "tid": tid_of(s.track), "args": args}
        if s.instant:
            ev["s"] = "t"       # thread-scoped instant marker
        else:
            t1 = s.t1 if s.t1 is not None else s.t0
            ev["dur"] = round((t1 - s.t0) * 1e6, 3)
        events.append(ev)
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": track}} for track, tid in tids.items()]
    return meta + events


def chrome_trace(tracer: Tracer | NullTracer) -> dict:
    """The full Chrome/Perfetto JSON object."""
    return {"traceEvents": chrome_trace_events(tracer),
            "displayTimeUnit": "ms"}


def dump_chrome_trace(tracer: Tracer | NullTracer, path: str) -> dict:
    """Serialize deterministically (sorted keys, fixed separators, one
    trailing newline) so equal streams give byte-identical files."""
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    return doc


# -- Prometheus ---------------------------------------------------------------

def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _name(namespace: str, metric: str) -> str:
    base = f"{namespace}_{metric}" if namespace else metric
    return "".join(c if c.isalnum() or c == "_" else "_" for c in base)


def _labelstr(labelnames: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{ln}="{_escape(v)}"' for ln, v in zip(labelnames, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def prometheus_text(*registries: MetricsRegistry) -> str:
    """Text exposition (version 0.0.4) of one or more registries.
    Families sort by exposition name and children by label values, so
    equal registry states render byte-identically -- the obs-smoke lane
    snapshots this output."""
    lines: list[str] = []
    fams = sorted(
        ((_name(reg.namespace, fam.name), fam)
         for reg in registries for fam in reg.families.values()),
        key=lambda p: p[0])
    for name, fam in fams:
        if fam.help:
            lines.append(f"# HELP {name} {_escape(fam.help)}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for values in sorted(fam.children):
            child = fam.children[values]
            if isinstance(child, Histogram):
                counts = child.bucket_counts()
                for bound, c in zip(Histogram.BOUNDS, counts):
                    lelabel = 'le="%g"' % bound
                    lines.append(
                        f"{name}_bucket"
                        f"{_labelstr(fam.labelnames, values, lelabel)}"
                        f" {c}")
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket"
                    f"{_labelstr(fam.labelnames, values, inf)}"
                    f" {child.count}")
                lines.append(f"{name}_sum"
                             f"{_labelstr(fam.labelnames, values)}"
                             f" {_fmt(child.sum)}")
                lines.append(f"{name}_count"
                             f"{_labelstr(fam.labelnames, values)}"
                             f" {child.count}")
            else:
                lines.append(f"{name}{_labelstr(fam.labelnames, values)}"
                             f" {_fmt(child.value)}")
    return "\n".join(lines) + "\n" if lines else ""

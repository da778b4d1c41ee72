"""Cost-model-attributed profiler: fold the span stream into attribution.

A copy of the JAX package's ``repro/obs/profile.py`` (which imports no
jax): the port imports nothing of that package, so it keeps its own.  Its
``launch`` instants come from the port's ``serving.engine``, with the
port's cost model's predictions (``autotune.costmodel.predict_launch``).

The source paper's deliverable is a *performance analysis* -- per-stage
cycle and byte accounting, predicted analytically and checked against
measurement.  This module is that deliverable at serving scale: it folds
a ``repro_torch.obs.trace`` span stream into

  * an **attribution tree** -- spans grouped by their name path, with
    call counts, total wall time, and SELF wall time (total minus child
    extents), so "where does a flush spend its time" is one table;
  * **per-kernel / per-bucket / per-plan-kind launch tables** -- every
    ``launch`` instant carries its kernel, bucket track, plan kind,
    observed HBM bytes, and the cost model's dispatch-time prediction
    (``autotune.costmodel.predict_launch``: bytes / FLOPs / M1-cycle
    projection), so launches aggregate along all three axes without
    re-deriving launch shapes;
  * **model-error ratios** -- observed/predicted HBM bytes per launch.
    The byte formulas are shared between ``kernels.opcount`` (what the
    engine records) and ``costmodel.packed_chain_cost`` (what it
    predicts), so the ratio is EXACTLY 1.0 by construction and any
    drift is a real accounting bug; ``chip_smoke.py`` gates
    ``byte_ratio_exact`` on the card's traced flush.

Determinism contract: every COUNTER-valued quantity (span counts, launch
counts, bytes, predictions, ratios) is bit-deterministic under a
``serving.clock.VirtualClock`` -- ``counters()`` returns exactly those.
Wall-clock quantities (the time columns of the report) are reported for
humans and NEVER gated.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.profile --smoke
    PYTHONPATH=src python -m repro_torch.obs.profile --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.obs.profile --spans dump.jsonl \
        --markdown report.md --chrome trace.json

``--smoke`` drives a small seeded workload through a traced
``GeometryServer`` on a virtual clock (on the GPU unless ``--device
cpu``); ``--spans`` loads a raw span
stream written by ``dump_span_stream`` (the Chrome export is lossy --
it drops span ids and parent links -- so the profiler round-trips
through its own JSON-lines dump format).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import typing

from repro_torch.obs.metrics import percentile
from repro_torch.obs.trace import NullTracer, Span, Tracer


@dataclasses.dataclass
class ProfileNode:
    """One attribution-tree node: every span with this name path.

    ``self_s`` is ``total_s`` minus the extents of child spans -- the
    time this stage spent NOT delegating -- which is the number that
    makes a hot stage stand out even when its children are cheap."""
    name: str
    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    children: dict[str, "ProfileNode"] = dataclasses.field(
        default_factory=dict)

    def child(self, name: str) -> "ProfileNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = ProfileNode(name)
        return node

    def walk(self, depth: int = 0) -> typing.Iterator[
            tuple[int, "ProfileNode"]]:
        """Depth-first, children in first-seen (= stream) order."""
        yield depth, self
        for c in self.children.values():
            yield from c.walk(depth + 1)


@dataclasses.dataclass
class LaunchGroup:
    """Launch instants aggregated along one axis (kernel, bucket track,
    or plan kind).  All fields are deterministic counters."""
    key: str
    launches: int = 0
    rows: int = 0              # packed requests across the launches
    padded_points: int = 0     # rows * lpad, summed
    hbm_bytes: int = 0         # observed (opcount) bytes
    pred_hbm_bytes: int = 0    # cost-model bytes
    pred_flops: int = 0
    pred_m1_cycles: int = 0

    def add(self, s: Span) -> None:
        a = s.attrs
        self.launches += 1
        self.rows += a.get("rows", 0)
        self.padded_points += a.get("rows", 0) * a.get("lpad", 0)
        self.hbm_bytes += a.get("hbm_bytes", 0)
        self.pred_hbm_bytes += a.get("pred_hbm_bytes", 0)
        self.pred_flops += a.get("pred_flops", 0)
        self.pred_m1_cycles += a.get("pred_m1_cycles", 0)


def _launch_key_kernel(s: Span) -> str:
    a = s.attrs
    k = a.get("kernel")
    if k:
        return k
    # pre-prediction streams: reconstruct the kernel name from kind + q
    return f"{a.get('kind', '?')}{'_q' if a.get('q') else ''}"


class Profile:
    """A folded span stream: attribution tree + launch tables + model
    error.  Build with ``Profile.from_tracer`` (or ``from_spans`` for a
    loaded dump)."""

    def __init__(self, spans: typing.Sequence[Span]):
        self.root = ProfileNode("")          # virtual root; depth-0 spans
        self.kernels: dict[str, LaunchGroup] = {}
        self.buckets: dict[str, LaunchGroup] = {}
        self.kinds: dict[str, LaunchGroup] = {}
        #: per-launch observed/predicted HBM byte ratios, stream order
        #: (empty when the stream predates prediction attachment)
        self.byte_ratios: list[float] = []
        self.n_events = len(spans)
        self.n_spans = sum(1 for s in spans if not s.instant)
        node_of: dict[int, ProfileNode] = {}
        for s in spans:
            parent = node_of.get(s.parent) if s.parent is not None \
                else None
            node = (parent if parent is not None else self.root) \
                .child(s.name)
            node_of[s.sid] = node
            node.count += 1
            dur = s.duration
            node.total_s += dur
            node.self_s += dur
            if not s.instant and parent is not None:
                parent.self_s -= dur       # child extent is not parent self
            if s.name == "launch":
                self._fold_launch(s)

    @classmethod
    def from_tracer(cls, tracer: Tracer | NullTracer) -> "Profile":
        return cls(list(tracer.spans))

    @classmethod
    def from_spans(cls, spans: typing.Sequence[Span]) -> "Profile":
        return cls(list(spans))

    def _fold_launch(self, s: Span) -> None:
        a = s.attrs
        for table, key in (
                (self.kernels, _launch_key_kernel(s)),
                (self.buckets, s.track or "?"),
                (self.kinds,
                 f"{a.get('kind', '?')}{'_q' if a.get('q') else ''}")):
            group = table.get(key)
            if group is None:
                group = table[key] = LaunchGroup(key)
            group.add(s)
        if a.get("pred_hbm_bytes"):
            self.byte_ratios.append(a["hbm_bytes"] / a["pred_hbm_bytes"])

    # -- deterministic reads --------------------------------------------------

    @property
    def launches(self) -> int:
        return sum(g.launches for g in self.kernels.values())

    @property
    def byte_ratio_exact(self) -> bool:
        """True when every launch's observed/predicted byte ratio is
        exactly 1.0 (and at least one launch carried a prediction)."""
        return bool(self.byte_ratios) \
            and all(r == 1.0 for r in self.byte_ratios)

    def counters(self) -> dict:
        """The bit-deterministic quantities (under a virtual clock):
        what the profile benchmark rows gate on.  No wall time here."""
        return {
            "events": self.n_events,
            "spans": self.n_spans,
            "launches": self.launches,
            "kernels": len(self.kernels),
            "launch_buckets": len(self.buckets),
            "hbm_bytes": sum(g.hbm_bytes for g in self.kernels.values()),
            "pred_hbm_bytes": sum(g.pred_hbm_bytes
                                  for g in self.kernels.values()),
            "pred_flops": sum(g.pred_flops for g in self.kernels.values()),
            "pred_m1_cycles": sum(g.pred_m1_cycles
                                  for g in self.kernels.values()),
            "byte_ratio_exact": int(self.byte_ratio_exact),
        }

    # -- rendering ------------------------------------------------------------

    def render_markdown(self) -> str:
        """The human report: attribution tree, launch tables, model
        error.  Counter columns are deterministic; the wall-time columns
        are reported, never gated."""
        out = ["# Serving profile", "",
               f"{self.n_events} events ({self.n_spans} extent spans, "
               f"{self.launches} launches)", "",
               "## Attribution tree (self vs total wall time; "
               "counts are exact)", "",
               "| stage | count | total ms | self ms |",
               "| --- | ---: | ---: | ---: |"]
        for depth, node in self.root.walk():
            if node is self.root:
                continue
            pad = "&nbsp;" * 2 * (depth - 1)
            out.append(f"| {pad}{node.name} | {node.count} "
                       f"| {node.total_s * 1e3:.3f} "
                       f"| {node.self_s * 1e3:.3f} |")
        for title, table in (("kernel", self.kernels),
                             ("bucket", self.buckets),
                             ("plan kind", self.kinds)):
            out += ["", f"## Launches by {title}", "",
                    f"| {title} | launches | rows | padded pts "
                    "| HBM bytes | pred bytes | pred MFLOP "
                    "| pred M1 cycles |",
                    "| --- | ---: | ---: | ---: | ---: | ---: | ---: "
                    "| ---: |"]
            for key in sorted(table):
                g = table[key]
                out.append(
                    f"| {g.key} | {g.launches} | {g.rows} "
                    f"| {g.padded_points} | {g.hbm_bytes} "
                    f"| {g.pred_hbm_bytes} "
                    f"| {g.pred_flops / 1e6:.3f} | {g.pred_m1_cycles} |")
        out += ["", "## Model error (observed / predicted HBM bytes)", ""]
        if self.byte_ratios:
            rs = self.byte_ratios
            out += [f"- launches with predictions: {len(rs)}",
                    f"- min {min(rs):.6f} / p50 {percentile(rs, 50):.6f} "
                    f"/ p99 {percentile(rs, 99):.6f} / max {max(rs):.6f}",
                    f"- exact (every ratio == 1.0): "
                    f"{self.byte_ratio_exact}"]
        else:
            out.append("- no launches carried predictions "
                       "(pre-prediction span stream)")
        return "\n".join(out) + "\n"


# -- span-stream persistence --------------------------------------------------

def dump_span_stream(tracer: Tracer | NullTracer, path: str) -> int:
    """Write the raw span stream as JSON lines (one ``Span.as_dict`` per
    line, deterministic key order) -- the lossless dump the profiler can
    reload.  The Chrome export cannot serve here: it drops span ids and
    parent links, which the attribution tree needs.  Returns the number
    of records written."""
    with open(path, "w") as f:
        for s in tracer.spans:
            f.write(json.dumps(s.as_dict(), sort_keys=True,
                               separators=(",", ":")) + "\n")
    return len(tracer.spans)


def load_span_stream(path: str) -> list[Span]:
    """Reload a ``dump_span_stream`` file as ``Span`` records."""
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            spans.append(Span(
                sid=d["sid"], parent=d.get("parent"), name=d["name"],
                t0=d["t0"], t1=d.get("t1"), ticket=d.get("ticket"),
                tickets=tuple(d.get("tickets", ())),
                track=d.get("track"), instant=bool(d.get("instant")),
                attrs=d.get("attrs", {})))
    return spans


# -- CLI ----------------------------------------------------------------------

def profile_smoke_workload(n_requests: int = 64, *,
                           device: str = "cuda", backend: str | None = None,
                           seed: int = 17, max_points: int = 48):
    """Serve one seeded mixed-lane workload under a traced virtual
    clock, from cold plan caches, on ``device`` (the GPU unless the
    caller asks for the CPU); returns ``(tracer, server)``.  The JAX
    package's workload and settings, so the two packages' counters
    agree."""
    # late imports: obs sits BELOW serving in the import graph; only the
    # CLI entry points reach upward
    from repro_torch.core import transform_chain as tc
    from repro_torch.serving import engine, workload
    from repro_torch.serving.clock import VirtualClock
    from repro_torch.obs import trace as obst
    engine.clear_plan_cache()
    tc.clear_plan_cache()
    clock = VirtualClock()
    tracer = Tracer(clock=clock)
    server = engine.GeometryServer(device=device, backend=backend)
    pool = workload.mixed_lane_workload(seed, n_requests,
                                        max_points=max_points)
    with obst.installed(tracer):
        for chain, pts, qname in pool:
            server.submit(chain, pts, qformat=qname)
        server.flush()
    return tracer, server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.profile",
        description="fold a span stream into the attribution report")
    ap.add_argument("--spans", default=None, metavar="DUMP.jsonl",
                    help="profile a span stream written by "
                         "dump_span_stream")
    ap.add_argument("--smoke", action="store_true",
                    help="drive the seeded 64-request smoke workload "
                         "through a traced server and profile that")
    ap.add_argument("--markdown", default=None, metavar="OUT.md",
                    help="write the markdown report here (default: "
                         "print to stdout)")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="also export the stream as Chrome-trace JSON")
    ap.add_argument("--spans-out", default=None, metavar="OUT.jsonl",
                    help="with --smoke: dump the raw span stream")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="with --smoke: where the workload is served")
    args = ap.parse_args(argv)
    if (args.spans is None) == (not args.smoke):
        ap.error("exactly one of --spans / --smoke is required")

    if args.smoke:
        tracer, _server = profile_smoke_workload(device=args.device)
        spans = list(tracer.spans)
    else:
        spans = load_span_stream(args.spans)
        tracer = None

    prof = Profile.from_spans(spans)
    report = prof.render_markdown()
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(report)
        print(f"profile: wrote {args.markdown} "
              f"({prof.launches} launches, {prof.n_events} events)")
    else:
        print(report, end="")
    if args.chrome:
        from repro_torch.obs.export import dump_chrome_trace
        holder = tracer if tracer is not None else Tracer()
        holder.spans = spans
        dump_chrome_trace(holder, args.chrome)
        print(f"profile: wrote {args.chrome}")
    if args.spans_out:
        if tracer is None:
            ap.error("--spans-out needs --smoke (the stream came from "
                     "a dump already)")
        dump_span_stream(tracer, args.spans_out)
        print(f"profile: wrote {args.spans_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

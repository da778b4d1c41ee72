"""Bench-trajectory analytics: the committed ``BENCH_*.json`` files as a
time series -- a copy of the JAX package's ``obs/bench_history.py`` (it
imports nothing of jax), which reads any directory of such records.

Every PR commits a ``benchmarks/BENCH_<timestamp>.json`` record, and CI's
exact-match gate (``tools/check_bench.py``) pins a fresh run against the
LATEST one.  That gate is blind to one whole class of regression: a PR
that makes a counter worse AND commits the worse value -- the fresh run
matches the new record exactly, so the gate passes while the trajectory
degrades.  This module closes that hole by reading the committed files
as a history and checking DIRECTION across consecutive records: for
counters where lower is strictly better (launches, padded bytes, lost
requests, failures), a later record may equal or improve on its
predecessor for the same row, never worsen.  ``tools/bench_trend.py`` is
the CLI gate; it exits nonzero on any such drift.

The comparison is name-matched per row over the intersection of
consecutive record pairs, exactly like the exact-match gate -- a row
that appears, disappears, or is renamed is not a regression (new
benchmarks arrive every PR), only a shared row whose directional counter
moved the wrong way is.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import typing

#: derived fields where a LARGER value in a later committed record for
#: the SAME row name is a genuine regression: the launch economy
#: (launches / shards / padded traffic / bytes moved), the padding
#: waste ratio, and the never-acceptable loss counters.  Deliberately
#: absent: admission rejections (queue_full / rate_limited shed load BY
#: DESIGN), recovery counters driven by injected fault schedules
#: (retries / bisections follow the injector seed, not code quality),
#: and every wall-clock field (noise).
LOWER_IS_BETTER = frozenset({
    "launches", "shards", "padded_points", "hbm_bytes",
    "padding_waste", "extra_launches",
    "lost", "mismatches", "failed_requests", "launch_failures",
    # scene-graph fold economy (scene_* rows): fold work creeping up for
    # the same animated edit schedule means the CSE cache or the dirty
    # propagation regressed (cse_hits is deliberately absent: it is
    # exact-gated, and "more hits" is not monotonically good)
    "folds", "folds_per_frame", "refolds", "dirtied",
})


@dataclasses.dataclass(frozen=True)
class BenchRecord:
    """One committed benchmark record."""
    path: str
    timestamp: str
    smoke: bool
    rows: dict[str, dict]

    @property
    def name(self) -> str:
        return os.path.basename(self.path)


@dataclasses.dataclass(frozen=True)
class Regression:
    """One directional drift: ``row.field`` worsened between two
    consecutive committed records."""
    row: str
    field: str
    prev_record: str
    record: str
    prev: typing.Any
    value: typing.Any

    def __str__(self) -> str:
        return (f"{self.row}: {self.field} worsened {self.prev!r} -> "
                f"{self.value!r} ({self.prev_record} -> {self.record})")


def load_history(bench_dir: str) -> list[BenchRecord]:
    """Every committed ``BENCH_*.json`` in filename (= timestamp) order."""
    records = []
    for path in sorted(glob.glob(os.path.join(bench_dir, "BENCH_*.json"))):
        with open(path) as f:
            doc = json.load(f)
        records.append(BenchRecord(
            path=path, timestamp=doc.get("timestamp", ""),
            smoke=bool(doc.get("smoke", False)),
            rows={row["name"]: row for row in doc.get("rows", [])}))
    return records


def series(history: typing.Sequence[BenchRecord], row: str,
           field: str) -> list[tuple[str, typing.Any]]:
    """One counter's trajectory: ``(record name, value)`` for every
    record that carries the row and field."""
    out = []
    for rec in history:
        r = rec.rows.get(row)
        if r is not None and field in r:
            out.append((rec.name, r[field]))
    return out


def _comparable(a, b) -> bool:
    return isinstance(a, (int, float)) and isinstance(b, (int, float)) \
        and not isinstance(a, bool) and not isinstance(b, bool)


def find_regressions(
        history: typing.Sequence[BenchRecord],
        fields: frozenset = LOWER_IS_BETTER) -> list[Regression]:
    """Directional drift across every consecutive record pair: for each
    shared row, each lower-is-better field present in both must not
    increase.  Equal is fine (the common case: deterministic counters
    repeat exactly); smaller is an improvement."""
    out = []
    for prev, cur in zip(history, history[1:]):
        for name in sorted(set(prev.rows) & set(cur.rows)):
            p_row, c_row = prev.rows[name], cur.rows[name]
            for field in sorted(fields & set(p_row) & set(c_row)):
                p, c = p_row[field], c_row[field]
                if _comparable(p, c) and c > p:
                    out.append(Regression(
                        row=name, field=field, prev_record=prev.name,
                        record=cur.name, prev=p, value=c))
    return out


def drift_report(history: typing.Sequence[BenchRecord]) -> str:
    """Markdown summary of the trajectory: record inventory, then the
    per-counter drift (first -> last value over the records sharing the
    row) for every directional field, improvements flagged."""
    lines = ["# Bench trajectory", "",
             f"{len(history)} committed records:", ""]
    for rec in history:
        lines.append(f"- `{rec.name}` (smoke={rec.smoke}, "
                     f"{len(rec.rows)} rows)")
    lines += ["", "## Directional counters (lower is better)", "",
              "| row | field | first | last | drift |",
              "| --- | --- | ---: | ---: | --- |"]
    rows_seen: dict[tuple[str, str], None] = {}
    for rec in history:
        for name, row in rec.rows.items():
            for field in sorted(LOWER_IS_BETTER & set(row)):
                rows_seen.setdefault((name, field))
    for name, field in sorted(rows_seen):
        traj = series(history, name, field)
        if len(traj) < 2:
            continue
        (_, first), (_, last) = traj[0], traj[-1]
        if not _comparable(first, last):
            continue
        drift = "flat" if last == first else \
            ("IMPROVED" if last < first else "WORSENED")
        lines.append(f"| {name} | {field} | {first} | {last} "
                     f"| {drift} |")
    return "\n".join(lines) + "\n"

"""Typed metrics registry: counters, gauges, histograms, and the
back-compat dict views that replace the serving stack's ad-hoc ``stats``
dicts.

A copy of the JAX package's ``repro/obs/metrics.py`` (which imports no jax):
the port imports nothing of that package, so it keeps its own.

Before this module the repo's runtime telemetry was four disjoint
conventions: a module-level dict in ``serving.engine``, plain int
attributes on ``AdmissionController``, private lists on
``AsyncGeometryServer``, and ``BucketReport`` dataclasses.  The registry
unifies them behind three typed instrument kinds:

  * ``Counter`` -- monotone event counts (launches, retries, rejections).
  * ``Gauge``   -- point-in-time levels (queue depth, high-water marks).
  * ``Histogram`` -- sample distributions (request latency) whose
    quantiles come from the repo's ONE nearest-rank ``percentile``
    definition (defined here; ``serving.clock`` re-exports it), so
    hand-pinned test values, engine telemetry, benchmark rows, and the
    Prometheus exposition cannot disagree about what "p99" means.

Instruments live in families keyed by name; a family declared with
``labels=(...)`` fans out into children per label-value combination
(tenant, plan kind, backend, dtype/qformat, size class -- the serving
dimensions), reachable via ``family.labels(tenant="render")``.  Every
value is readable back (``registry.value(name, **labels)``), dumpable
(``as_dict``) and resettable -- determinism under seeded workloads is
preserved because instruments hold plain Python numbers, never wall
time.

``StatsView`` is the compatibility shim: a ``MutableMapping`` facade
over a fixed key set of counters so the module-level ``serving.stats``
dict -- read, iterated, compared, ``+=``-incremented and zeroed by
every existing test, benchmark, and example -- keeps its exact dict
semantics while the storage moves into the registry.
"""
from __future__ import annotations

import math
from collections.abc import MutableMapping


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest element with at least
    ``q``% of the sample at or below it (``sorted[ceil(q/100 * n)]``,
    1-indexed).  Exact set membership -- p50 of [1, 2, 3, 4] is 2, p99
    is 4 -- which is what makes hand-pinned telemetry tests possible;
    interpolating estimators would make every pinned value a float
    artifact of the interpolation rule.  Returns ``nan`` on an empty
    sample."""
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = sorted(values)
    if not xs:
        return math.nan
    if q == 0:
        return xs[0]
    rank = math.ceil(q / 100.0 * len(xs))
    return xs[rank - 1]


class Counter:
    """A monotone-by-convention event count.  ``set`` exists for the
    back-compat dict view (tests zero counters by assignment) and for
    absolute mirrors of an external source of truth."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v


class Gauge:
    """A point-in-time level; ``track_max`` keeps high-water marks."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def track_max(self, v) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """A sample distribution: stores the samples (the serving stack's
    populations are bounded by the soak sizes) and answers count / sum /
    max / nearest-rank quantiles.  Prometheus exposition renders it as a
    real cumulative histogram (``_bucket{le=...}`` series over
    ``BOUNDS`` plus ``_sum``/``_count``); bucket counts are integers
    over fixed bounds, so the exposition stays byte-deterministic under
    seeded workloads."""

    __slots__ = ("samples",)

    QUANTILES = (50.0, 99.0)

    #: cumulative upper bounds for the Prometheus ``_bucket`` series
    #: (seconds -- the serving stack's histograms are latencies); the
    #: ``+Inf`` bucket is implicit in the exposition
    BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
              0.5, 1.0, 2.5)

    def __init__(self):
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(v)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return sum(self.samples)

    @property
    def max(self) -> float:
        return max(self.samples) if self.samples else 0.0

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def bucket_counts(self, bounds=None) -> list[int]:
        """Cumulative counts at each upper bound (samples <= bound); the
        implicit ``+Inf`` bucket is ``count``, appended by the exporter."""
        bs = self.BOUNDS if bounds is None else bounds
        return [sum(1 for s in self.samples if s <= b) for b in bs]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """All instruments sharing one name: the unlabeled default child
    and/or one child per label-value combination."""

    __slots__ = ("name", "kind", "help", "labelnames", "children")

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: tuple = ()):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.children: dict[tuple, object] = {}

    def labels(self, **kv):
        """The child instrument for this label-value combination
        (created on first use).  Values stringify -- size classes are
        ints at the call site, label values in the exposition."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = _KINDS[self.kind]()
        return child

    def default(self):
        """The unlabeled instrument (only valid without labelnames)."""
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} is labeled by {self.labelnames}; "
                "use .labels(...)")
        return self.labels()


class MetricsRegistry:
    """One scope's instruments (the process-global serving aggregate, or
    one server's own registry), keyed by name in declaration order.

        m = MetricsRegistry("serving")
        m.counter("launches").inc()
        m.counter("requests", labels=("tenant",)).labels(tenant="a").inc()
        m.value("launches")                 # -> 1
        obs.export.prometheus_text(m)       # exposition

    Declaring the same name twice returns the same family (and checks
    the kind/labels agree), so modules can declare lazily at use sites.
    """

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self.families: dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str,
                labels: tuple) -> _Family:
        fam = self.families.get(name)
        if fam is None:
            fam = self.families[name] = _Family(name, kind, help,
                                                tuple(labels))
        elif fam.kind != kind or fam.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-declared as {kind}{tuple(labels)} "
                f"(was {fam.kind}{fam.labelnames})")
        if help and not fam.help:
            fam.help = help
        return fam

    def counter(self, name: str, help: str = "", labels: tuple = ()):
        fam = self._family(name, "counter", help, labels)
        return fam if labels else fam.default()

    def gauge(self, name: str, help: str = "", labels: tuple = ()):
        fam = self._family(name, "gauge", help, labels)
        return fam if labels else fam.default()

    def histogram(self, name: str, help: str = "", labels: tuple = ()):
        fam = self._family(name, "histogram", help, labels)
        return fam if labels else fam.default()

    # -- read side -----------------------------------------------------------

    def value(self, name: str, **labels):
        """The numeric value of a counter/gauge (0 for a never-touched
        name -- reading must not create state the exposition then shows)."""
        fam = self.families.get(name)
        if fam is None:
            return 0
        key = tuple(str(labels[ln]) for ln in fam.labelnames) \
            if labels or fam.labelnames else ()
        child = fam.children.get(key)
        return 0 if child is None else child.value

    def as_dict(self) -> dict:
        """Unlabeled counter/gauge values by name (the debugging dump;
        labeled children and histograms have richer dedicated reads)."""
        out = {}
        for name, fam in self.families.items():
            if fam.kind == "histogram" or fam.labelnames:
                continue
            child = fam.children.get(())
            out[name] = 0 if child is None else child.value
        return out

    def reset(self) -> None:
        """Zero every instrument in place (families and label children
        survive, so held instrument references stay live)."""
        for fam in self.families.values():
            for child in fam.children.values():
                if isinstance(child, Histogram):
                    child.samples.clear()
                else:
                    child.value = 0


class StatsView(MutableMapping):
    """The back-compat dict facade: a fixed key set of counters in a
    registry, behaving exactly like the plain dict it replaces --
    ``stats["launches"] += 1``, ``for k in stats``, ``dict(stats)``,
    ``stats == {...}``, ``stats[k] = 0`` all work unchanged.  The key
    set is CLOSED: an unknown key raises ``KeyError`` like the old dict
    (typos in counter names must not mint new counters silently)."""

    __slots__ = ("_registry", "_counters")

    def __init__(self, registry: MetricsRegistry, keys: tuple,
                 help_by_key: dict | None = None):
        self._registry = registry
        helps = help_by_key or {}
        self._counters = {k: registry.counter(k, help=helps.get(k, ""))
                          for k in keys}

    def __getitem__(self, key: str):
        return self._counters[key].value

    def __setitem__(self, key: str, value) -> None:
        if key not in self._counters:
            raise KeyError(key)
        self._counters[key].set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("StatsView keys are fixed; counters cannot be "
                        "deleted")

    def __iter__(self):
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __contains__(self, key) -> bool:
        return key in self._counters

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"

"""Size-bucketing policy: pad request lengths onto a coarse geometric grid.

Packing heterogeneous requests into one batch requires a common padded
length per launch.  Padding every request in a bucket to the bucket
maximum would let one long request blow the padding waste of every short
one, so lengths are snapped onto a fixed grid of *allowed* sizes and the
grid size becomes part of the bucket key: requests only share a launch if
they share a padded length.

The grid is power-of-two doubling from ``min_len``, refined with
intermediate sizes whenever a plain doubling could not honour the waste
cap: consecutive allowed sizes keep a ratio <= 1/(1 - waste_cap), which
bounds per-request padding waste (L - n)/L strictly below ``waste_cap``
for any n >= min_len.  ``waste_cap=0.5`` is pure powers of two.  The
functions are the JAX package's, so both packages bucket a workload
identically.
"""
from __future__ import annotations

import math

from repro_torch.autotune import cache as tuning

MIN_LEN = 8          #: default grid floor
WASTE_CAP = 0.5      #: default cap -- pure power-of-two grid


def grid_for(backend: str, *, min_len: int | None = None,
             waste_cap: float | None = None,
             n: int = 0) -> tuple[int, float, str]:
    """Resolve the size grid the serving engine runs, in the JAX
    package's order: explicit arguments win; unset knobs come from the
    tuning cache when autotuning is enabled (kernel ``serving_grid`` on
    ``backend``), else the module defaults.  ``n`` is the workload's
    largest request length -- the size class grid winners are cached
    under (the engine passes its pending queue's maximum at flush time).
    Returns ``(min_len, waste_cap, source)`` with ``source`` naming where
    the knobs came from: ``explicit`` (both passed), ``default`` /
    ``cached`` / ``tuned`` (neither passed), or ``explicit+<that>`` when
    they mix."""
    if min_len is not None and waste_cap is not None:
        return min_len, waste_cap, "explicit"
    cfg = tuning.config_for("serving_grid", backend, n=n)
    resolved_min = cfg.grid_min_len if cfg.grid_min_len is not None \
        else MIN_LEN
    resolved_cap = cfg.grid_waste_cap if cfg.grid_waste_cap is not None \
        else WASTE_CAP
    source = cfg.source if min_len is None and waste_cap is None \
        else f"explicit+{cfg.source}"
    return (min_len if min_len is not None else resolved_min,
            waste_cap if waste_cap is not None else resolved_cap,
            source)


def padded_length(n: int, *, min_len: int = MIN_LEN,
                  waste_cap: float = WASTE_CAP) -> int:
    """Smallest allowed padded length >= n.

    Guarantees for n >= min_len: result >= n, and padding waste
    (result - n) / result < waste_cap.  Requests shorter than ``min_len``
    pad to the grid floor (the floor, not the cap, bounds their waste).
    """
    if not 0.0 < waste_cap < 1.0:
        raise ValueError(f"waste_cap must be in (0, 1), got {waste_cap}")
    if min_len < 1:
        raise ValueError(f"min_len must be >= 1, got {min_len}")
    ratio = 1.0 / (1.0 - waste_cap)
    size = min_len
    while size < n:
        # next rung: geometric step, but never finer than +1 and never
        # skipping past the power-of-two doubling rung
        size = min(max(size + 1, math.ceil(size * ratio)), 2 * size)
    return size


def waste_fraction(n: int, lpad: int) -> float:
    """Padding waste of serving an n-point request at padded length lpad."""
    return (lpad - n) / lpad if lpad else 0.0

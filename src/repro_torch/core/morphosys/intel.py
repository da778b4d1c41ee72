"""Intel 80386/80486/Pentium instruction-level cycle models (Tables 3-5).

The port's copy of ``repro/core/morphosys/intel.py``: the same code, the
imports renamed and a one-line docstring on each public name that had
none.  Numpy only, so the port keeps the M1 emulator (the cycle oracle)
without importing the JAX package.

The paper compares the M1 mapping against hand-written x86 loops.  We
re-implement the per-instruction cycle accounting of Tables 3 and 4 exactly
and expose the published Table 5 constants for the two matrix algorithms
(for which the paper prints no instruction listing).

Known paper arithmetic slips (documented, reproduced in EXPERIMENTS.md):
Table 3's 64-element totals (769T on 80486, 1723T on 80386) are inconsistent
with Table 3's own per-instruction clocks, which give 706T and 1732T -- the
8-element totals (90T / 220T) and *all* Table 4 totals match our model
exactly.  ``translation_cycles`` returns the model value; the published
figure is available via PAPER_TABLE5.
"""
from __future__ import annotations

import dataclasses

CLOCK_MHZ = {"m1": 100.0, "80486": 100.0, "80386": 40.0, "pentium": 133.0}

# Table 3: MOV/MOV/ADD/MOV/INC/INC/INC/DEC body + JNZ (taken/fall-through)
_TRANSLATION = {
    "80486": dict(setup=4 * 1, body=8 * 1, jnz_taken=3, jnz_fall=1),
    "80386": dict(setup=4 * 2, body=4 + 4 + 2 + 2 + 2 + 2 + 2 + 2, jnz_taken=7, jnz_fall=3),
}

# Table 4: MOV/ADD/MOV/INC/INC/DEC body + JNZ
_SCALING = {
    "80486": dict(setup=4 * 1, body=6 * 1, jnz_taken=3, jnz_fall=1),
    "80386": dict(setup=4 * 2, body=4 + 2 + 2 + 2 + 2 + 2, jnz_taken=7, jnz_fall=3),
}


def _loop_cycles(params: dict, n: int) -> int:
    taken = params["body"] + params["jnz_taken"]
    last = params["body"] + params["jnz_fall"]
    return params["setup"] + (n - 1) * taken + last


def translation_cycles(cpu: str, n: int) -> int:
    """Table 3 model: vector-vector add loop of ``n`` elements."""
    return _loop_cycles(_TRANSLATION[cpu], n)


def scaling_cycles(cpu: str, n: int) -> int:
    """Table 4 model: vector-scalar loop of ``n`` elements."""
    return _loop_cycles(_SCALING[cpu], n)


def time_us(cpu: str, cycles: int) -> float:
    """Microseconds of ``cycles`` at ``cpu``'s clock."""
    return cycles / CLOCK_MHZ[cpu]


@dataclasses.dataclass(frozen=True)
class Table5Row:
    """One published row of the paper's Table 5."""
    algorithm: str
    system: str
    n_elements: int
    cycles: int
    speedup: float | None       # vs M1, as published (None for the M1 rows)
    total_time_us: float
    elements_per_cycle: float
    cycles_per_element: float


# Published Table 5, verbatim (the ground truth our reproduction validates
# against; speedups are published cycle ratios vs the M1 row above them).
PAPER_TABLE5: list[Table5Row] = [
    Table5Row("translation", "m1", 64, 96, None, 0.96, 0.667, 1.5),
    Table5Row("translation", "80486", 64, 769, 8.01, 7.69, 0.083, 12.0),
    Table5Row("translation", "80386", 64, 1723, 17.94, 43.075, 0.037, 26.9),
    Table5Row("scaling", "m1", 64, 55, None, 0.55, 1.16, 0.859),
    Table5Row("scaling", "80486", 64, 578, 10.51, 5.78, 0.047, 9.03),
    Table5Row("scaling", "80386", 64, 1348, 24.51, 33.7, 0.11, 21.2),
    Table5Row("rotation_matmul", "m1", 64, 256, None, 2.56, 0.25, 4.0),
    Table5Row("rotation_matmul", "pentium", 64, 10151, 39.65, 76.32, 0.006, 158.6),
    Table5Row("rotation_matmul", "80486", 64, 27038, 105.62, 270.38, 0.002, 422.4),
    Table5Row("composite_ii", "m1", 16, 70, None, 0.7, 0.228, 4.375),
    Table5Row("composite_ii", "pentium", 16, 1328, 18.97, 9.98, 0.012, 83.0),
    Table5Row("composite_ii", "80486", 16, 3354, 47.91, 33.54, 0.0047, 209.6),
    Table5Row("translation", "m1", 8, 21, None, 0.21, 0.38, 2.625),
    Table5Row("translation", "80486", 8, 90, 4.29, 0.9, 0.088, 11.36),
    Table5Row("translation", "80386", 8, 220, 10.48, 5.5, 0.036, 27.5),
    Table5Row("scaling", "m1", 8, 14, None, 0.14, 0.57, 1.75),
    Table5Row("scaling", "80486", 8, 74, 5.28, 0.74, 0.108, 9.25),
    Table5Row("scaling", "80386", 8, 172, 12.29, 4.3, 0.46, 21.7),
]


def paper_row(algorithm: str, system: str, n: int) -> Table5Row:
    """The published Table 5 row of (algorithm, system, n)."""
    for row in PAPER_TABLE5:
        if (row.algorithm, row.system, row.n_elements) == (algorithm, system, n):
            return row
    raise KeyError((algorithm, system, n))

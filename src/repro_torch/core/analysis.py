"""Performance-analysis calculators (paper section 6) + validation helpers.

The port's copy of ``repro/core/analysis.py`` (``PerfRow``, ``derive``,
``format_table``): the same code, a one-line docstring on each public
name, and the clock table from the port's own copy of the M1 emulator.

The paper's methodology: for each (algorithm, system) pair report cycles,
total time at the system clock, elements/cycle, cycles/element, and speedup
as the ratio of execution cycles.  These helpers compute the derived columns
from cycle counts so benchmarks can print paper-format tables from either
the published constants, our emulator, or our Intel models.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.morphosys.intel import CLOCK_MHZ


@dataclasses.dataclass(frozen=True)
class PerfRow:
    """One row of a paper-format performance table."""
    algorithm: str
    system: str
    n_elements: int
    cycles: int
    speedup_vs: float | None       # cycle ratio vs the reference system
    total_time_us: float
    elements_per_cycle: float
    cycles_per_element: float
    source: str                    # "paper" | "emulator" | "model"


def derive(algorithm: str, system: str, n: int, cycles: int,
           ref_cycles: int | None = None, source: str = "model") -> PerfRow:
    """A ``PerfRow`` with the derived columns of ``cycles`` at the system's clock."""
    clock = CLOCK_MHZ[system]
    return PerfRow(
        algorithm=algorithm,
        system=system,
        n_elements=n,
        cycles=cycles,
        speedup_vs=(cycles / ref_cycles) if ref_cycles else None,
        total_time_us=cycles / clock,
        elements_per_cycle=round(n / cycles, 4),
        cycles_per_element=round(cycles / n, 4),
        source=source,
    )


def format_table(rows: list[PerfRow]) -> str:
    """The rows as a fixed-width text table, paper column order."""
    hdr = (f"{'algorithm':<18}{'system':<10}{'n':>4}{'cycles':>8}{'speedup':>9}"
           f"{'us':>10}{'elem/cyc':>10}{'cyc/elem':>10}  source")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        sp = f"{r.speedup_vs:.2f}" if r.speedup_vs else "-"
        lines.append(
            f"{r.algorithm:<18}{r.system:<10}{r.n_elements:>4}{r.cycles:>8}{sp:>9}"
            f"{r.total_time_us:>10.3f}{r.elements_per_cycle:>10.4f}"
            f"{r.cycles_per_element:>10.3f}  {r.source}")
    return "\n".join(lines)

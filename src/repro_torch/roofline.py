"""Roofline terms of a dry-run cell against NVIDIA H100 datasheet
constants, the port of the JAX package's ``roofline.py``.

    compute    = device_flops / peak_flops
    memory     = device_bytes / hbm_bw
    collective = device_collective_bytes / link_bw

The inputs are per-device counts (``hlo_analysis.analyze`` of a
dispatch trace reads each rank's local ops), so each term divides by one
card's peak -- equivalent to the global totals over (devices x peak).

The card is an NVIDIA H100 80GB HBM3 (SXM, 700 W): 989 TFLOP/s dense
bfloat16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 at 450
GB/s a direction for the link term.  Two caveats:

  * a 16-wide ``model`` axis spans two 8-GPU nodes, whose inter-node
    links (InfiniBand, about 50 GB/s a GPU) are far slower than NVLink,
    so there the collective term is a lower bound;
  * these are datasheet peaks, not measurements: a card set below 700 W
    runs slower under load, and no kernel reaches them.

The reference also parses collectives out of XLA's optimized HLO
(``parse_collectives``); the port has no HLO -- its collectives are
counted from the dispatch trace by ``hlo_analysis`` -- so that function
has no counterpart here.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3 (SXM) datasheet constants (per card)
PEAK_FLOPS = 989e12        # dense bf16, tensor cores
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction

#: the collective kinds, the reference's names
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device
    hbm_bytes: float           # per-device
    collective_bytes: float    # per-device
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


def roofline_terms(cost: dict, collectives: CollectiveStats) -> Roofline:
    """The three terms of ``cost`` (``flops``, ``bytes accessed``) and
    ``collectives``, and the largest one's name."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = float(collectives.total_bytes)
    tc = flops / PEAK_FLOPS
    tm = hbm / HBM_BW
    tx = coll / LINK_BW
    terms = {"compute": tc, "memory": tm, "collective": tx}
    bottleneck = max(terms, key=terms.get)
    return Roofline(flops, hbm, coll, tc, tm, tx, bottleneck)


def model_flops_utilization(model_flops_per_device: float,
                            roof: Roofline) -> dict:
    """MODEL_FLOPS / traced FLOPs and the roofline fraction of the
    dominant term."""
    useful = (model_flops_per_device / roof.flops) if roof.flops else 0.0
    # the time the useful compute would take at peak over the dominant
    # term's time (how close the cell is to its own roofline)
    t_useful = model_flops_per_device / PEAK_FLOPS
    frac = t_useful / roof.t_bound if roof.t_bound else 0.0
    return {"useful_flops_ratio": useful, "roofline_fraction": frac}

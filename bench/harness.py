"""The parts of a benchmark run that every cell shares: the cell's files
found by name, the card's checks, the per-layer metric readers, the guard
against JAX, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``
under this folder) and a traffic mix (``traffic/<name>.json``); its
correctness limits are ``limits/<cell>.json`` and each per-layer metric is
read by ``metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that may not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The run found fewer CUDA devices than its cell asks for."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(spec_: dict, name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration file,
    traffic mix, limits and the metrics it reports."""
    cells = {w["name"]: w for w in spec_["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec_["configs"]}[w["config"]]
    e2e = [m for m in spec_["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec_["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return {"name": name, "chips": w["chips"],
            "config": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic",
                                              w["traffic"] + ".json")),
            "limits": load_json(os.path.join(HERE, "limits", name + ".json")),
            "end_to_end": e2e, "per_layer": layer}


def driver(c: dict):
    """The module ``<kind>_cell`` that runs a cell of its traffic's kind,
    with ``run(c, seed, seconds, trace, device, t_start, control=False)``:
    ``serve_cell``, ``train_cell``, or one that a later kind adds."""
    return importlib.import_module(f"bench.{c['traffic']['kind']}_cell")


def judged(limits: dict, readings: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether all are within
    them: the one rule for the program and for the control in its
    place.  A number that is missing reads inf."""
    checks = {k: {"value": readings.get(k, math.inf), "limit": v["limit"]}
              for k, v in limits.items()}
    return checks, all(v["value"] <= v["limit"] for v in checks.values())


def check_device(chips: int) -> None:
    """Raise ``NoDevice`` unless this process sees ``chips`` CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"asks for {chips}")


def card(count: int) -> dict:
    """The card's name, how many the run uses, and its power limit."""
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        out["power_limit"] = q.stdout.strip().splitlines()[0].split(",")[-1]\
            .strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        out["power_limit"] = "unknown"
    return out


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_name = "bench_metric_" + metric.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def per_layer(metrics: list, ctx: dict) -> dict:
    """Every per-layer metric of the cell that its reader finds; a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _finite(x):
    """``x`` with every float that is not finite written as a string, so
    the line stays strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def emit(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)

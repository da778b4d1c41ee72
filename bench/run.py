"""The benchmark of ``repro_torch`` on the card, one cell a run:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration file, its traffic
mix, its correctness limits and its metrics come from ``BENCHMARK.json`` and
the files this folder holds under their names.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then ``checks``,
each compared number beside its limit, which the last lines of standard
error repeat.  A run that finds fewer CUDA cards than its cell asks for,
or finds JAX or the JAX package loaded once its window has closed, exits
with another code than 0 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench", sub)


def execute(c: dict, seed: int, seconds: float, trace: bool) -> dict:
    """One run of cell ``c`` by the driver of its traffic's kind, then the
    result line's fields."""
    from bench import harness
    r = harness.driver(c).run(c, seed, seconds, trace, "cuda", T_START)
    if trace:
        metrics = harness.per_layer(c["per_layer"], r["ctx"])
    else:
        metrics = {}
        for m in c["end_to_end"]:
            value = r["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = dict(r["device"])
    prof = r["ctx"].get("profile")
    out = {"correct": bool(r["correct"]), "attempted": r["attempted"],
           "failed": r["failed"], "metrics": metrics, "device": device_info}
    if trace and prof is not None:
        device_info["busy_s"] = prof.busy_s
        device_info["window_s"] = prof.window_s
        out["breakdown"] = prof.breakdown
    print("phases: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 r["phases"].items()), file=sys.stderr)
    out["checks"] = r["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from bench import harness
    c = harness.cell(harness.spec(), args.workload)
    try:
        harness.check_device(c["chips"])
    except harness.NoDevice as err:
        print(f"bench: {err}", file=sys.stderr)
        return 2
    out = execute(c, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_loaded()
    if found:
        print(f"bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

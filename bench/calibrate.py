"""Readings that a cell's correctness limits are set from, on the card at
the cell's own size, many seeds in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 12 --first <n> \\
        [--control-seeds 3] [--seconds 2] [--out chiprun_out/cal.jsonl]

For each seed it makes a run as ``bench/run.py`` does with a short window
(at the cell's own load, as many calls as a run compares; no
``warm_seconds``, which changes no number compared) and prints the
program's compared numbers and verdict; on the first ``--control-seeds``
seeds also the control's (the reference in float8 in the program's
place), judged by the same limits and rule as the program
(``control_correct``, which has to read false), and, for a training
cell, the half-batch fault's readings.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from bench import harness
    c = harness.cell(harness.spec(), args.workload)
    harness.check_device(c["chips"])
    c["traffic"]["warm_seconds"] = 0
    driver = harness.driver(c)
    with (open(args.out, "a") if args.out
          else contextlib.nullcontext()) as out:
        for k in range(args.seeds):
            seed = args.first + k
            t0 = time.perf_counter()
            r = driver.run(c, seed, args.seconds, False, "cuda", t0,
                           control=k < args.control_seeds)
            rec = {"workload": args.workload, "seed": seed,
                   "correct": r["correct"], "attempted": r["attempted"],
                   "checks": r["checks"],
                   "control_correct": r.get("control_correct"),
                   "control_checks": r.get("control_checks"),
                   "readings": r["verdict"],
                   "e2e": r["e2e"], "wall_s": time.perf_counter() - t0}
            line = json.dumps(rec, default=str)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

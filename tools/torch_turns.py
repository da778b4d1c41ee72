"""The turn driver the port's chip tools share.

A tool measures in turns, each a process of its own (``TOOL --one TREE
[options]``) whose last line of standard output is one JSON object.  An
A/B tool runs checkouts A and B in the order A, B, B, A, so that a card
or a host that drifts during the call weighs on both alike:

    from torch_turns import ab_main

    def one(tree, args) -> dict: ...          # one turn, in this process
    def summary(turns, args) -> dict: ...     # the four turns' last line

    sys.exit(ab_main(__doc__, __file__, one, summary,
                     options={"--reps": dict(type=int, default=5)}))

``turn`` runs one such process; ``pair`` folds four values in turn
order into the mean of each checkout's two turns.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ORDER = ("A", "B", "B", "A")


def turn(tool: str, args: list[str]) -> dict:
    """Run ``tool --one *args`` in a process of its own, echo its last
    line and return it parsed; its standard error passes through."""
    out = subprocess.run([sys.executable, os.path.abspath(tool), "--one",
                          *args], stdout=subprocess.PIPE, text=True,
                         check=True)
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def pair(values: list, unit: str = "ms") -> dict:
    """Four values in turn order, and the mean of each checkout's two."""
    return {"order": list(ORDER), unit: values,
            f"A_{unit}": (values[0] + values[3]) / 2,
            f"B_{unit}": (values[1] + values[2]) / 2}


def ab_main(doc: str, tool: str, one, summary,
            options: dict | None = None) -> int:
    """The command line of an A/B tool: ``--one TREE`` prints
    ``one(TREE, args)`` as the turn's JSON line; two checkouts run the
    four turns, passing ``options`` on, then print ``summary(turns,
    args)``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", help="run one turn in this checkout")
    for flag, kw in (options or {}).items():
        ap.add_argument(flag, **kw)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(os.path.abspath(args.one), args)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts, A and B")
    passed = [str(x) for flag in (options or {})
              for x in (flag, getattr(args, flag.lstrip("-")
                                      .replace("-", "_")))]
    a, b = (os.path.abspath(t) for t in args.trees)
    turns = [turn(tool, [tree, *passed]) for tree in (a, b, b, a)]
    print(json.dumps(summary(turns, args)), flush=True)
    return 0

"""Autotune CLI: run the pruned search, inspect the model, guard the cache.

    PYTHONPATH=src python -m repro_torch.autotune --smoke
        the JAX package's smoke search (three small chain shapes, their
        two fixed-point twins, the serving grid on two seeded workloads)
        on the GPU, printing the analytic paper-format table, the
        emulator cross-check, and every timed trial.

    PYTHONPATH=src python -m repro_torch.autotune --smoke --check
        additionally verifies the committed winners file: every entry the
        search produces is present; deterministically, by replayed launch
        counts, the committed serving grid schedules no more launches
        than the default grid; and, on the backend the file was tuned on,
        by wall clock with 2x slack, no committed config is grossly
        slower than this run's fresh winner.

    PYTHONPATH=src python -m repro_torch.autotune --smoke --write-default
        persist the winners to the committed default cache
        (src/repro_torch/autotune/default_cache.json).

``--out PATH`` writes winners to an arbitrary path instead.  ``--device
cpu`` runs the search on the CPU (the plain versions: every kernel winner
stays the default, and only the grid is timed).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.autotune import cache as tcache
from repro_torch.autotune import costmodel, search
from repro_torch.core import analysis

#: the backend the committed winners file was tuned on (the card's)
COMMITTED_BACKEND = "cuda"


def _print_model_table() -> None:
    print("== analytic cost model, paper-format (source=model) ==")
    print(analysis.format_table(costmodel.perf_rows()))
    print("\n== cross-check vs the MorphoSys emulator ==")
    from repro_torch.core.morphosys import programs
    import numpy as np
    rng = np.random.default_rng(0)
    ok = True
    for routine, runner in (("translation",
                             lambda n: programs.run_translation(
                                 rng.integers(-99, 99, n),
                                 rng.integers(-99, 99, n))),
                            ("scaling",
                             lambda n: programs.run_scaling(
                                 rng.integers(-99, 99, n), 5))):
        for n in (8, 64):
            model = costmodel.morphosys_cycles(routine, n)
            emu = runner(n).cycles
            ok &= model == emu
            print(f"  {routine:<12} n={n:<3} model={model:<4} emulator={emu:<4}"
                  f" {'OK' if model == emu else 'MISMATCH'}")
    if not ok:
        sys.exit("cost model disagrees with the emulator")


def _print_reports(reports) -> None:
    for rep in reports:
        print(f"\n== {rep.kernel} ({rep.backend}, {rep.dtype}, "
              f"n={rep.n}) ==")
        for t in rep.trials:
            mark = " <- winner" if t.config.key_fields() == \
                rep.winner.key_fields() else ""
            print(f"  {t.config.describe():<52} "
                  f"{t.seconds * 1e6:9.1f} us  "
                  f"(predicted {t.predicted_us:8.1f} us){mark}")


def _check(reports) -> None:
    """The regression gate against the committed default cache."""
    committed = tcache.TuningCache.load(tcache.DEFAULT_CACHE_PATH)
    failures = []
    default = tcache.DEFAULTS["serving_grid"]
    for label, wl in (("smoke", search.smoke_workload()),
                      ("bench64", search.bench_workload())):
        n = search.workload_size_class_n(wl)
        entry = committed.get("serving_grid", COMMITTED_BACKEND, "float32",
                              n)
        if entry is None:
            failures.append(f"missing serving_grid entry for the {label} "
                            "workload")
            continue
        shape = costmodel.workload_shape(wl)
        merged = tcache.merge(default, entry)
        com_cost = costmodel.grid_cost(shape, merged.grid_min_len,
                                       merged.grid_waste_cap)
        def_cost = costmodel.grid_cost(shape, default.grid_min_len,
                                       default.grid_waste_cap)
        print(f"[check] serving_grid[{label}] launches: committed="
              f"{com_cost.launches} default={def_cost.launches}")
        if com_cost.launches > def_cost.launches:
            failures.append(
                f"committed grid {entry.describe()} schedules "
                f"{com_cost.launches} launches vs {def_cost.launches} "
                f"for the default grid on the {label} workload")
    for rep in reports:
        entry = committed.get(rep.kernel, COMMITTED_BACKEND, rep.dtype,
                              rep.n)
        if entry is None:
            failures.append(f"missing cache entry: {rep.kernel}|"
                            f"{COMMITTED_BACKEND}|{rep.dtype}")
            continue
        if rep.backend != COMMITTED_BACKEND:
            continue        # the committed config's time is the card's
        # wall-clock guard: committed config vs this run's fresh winner,
        # measured in the same process (2x slack absorbs noise; the
        # launch-count gate above is the deterministic check)
        fresh = rep.winner_seconds
        timed = {tuple(sorted(t.config.key_fields().items())): t.seconds
                 for t in rep.trials}
        com_t = timed.get(tuple(sorted(entry.key_fields().items())))
        if com_t is not None and com_t > fresh * 2.0:
            failures.append(
                f"{rep.kernel}: committed config {entry.describe()} is "
                f"{com_t * 1e6:.0f}us vs fresh winner {fresh * 1e6:.0f}us")
    if reports and reports[0].backend != COMMITTED_BACKEND:
        print(f"[check] the committed winners are {COMMITTED_BACKEND}'s; "
              f"this run timed {reports[0].backend}, so no wall-clock "
              "comparison")
    if failures:
        sys.exit("autotune check FAILED:\n  " + "\n  ".join(failures))
    print("[check] committed default cache: OK")


def main(argv=None) -> None:
    """Parse the command line; print the model, search, check, write."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.autotune")
    ap.add_argument("--smoke", action="store_true",
                    help="pruned search on the smoke shapes + serving grid")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the search runs (the GPU by default)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timer repetitions per candidate (best-of)")
    ap.add_argument("--out", default=None,
                    help="write winners JSON to this path")
    ap.add_argument("--write-default", action="store_true",
                    help="write winners to the committed default cache")
    ap.add_argument("--check", action="store_true",
                    help="fail if the committed cache regresses")
    args = ap.parse_args(argv)

    _print_model_table()
    if not (args.smoke or args.check):
        print("\n(nothing to tune; pass --smoke to run the pruned search)")
        return

    cache, reports = search.smoke_search(device=args.device,
                                         iters=args.iters)
    _print_reports(reports)

    if args.check:
        _check(reports)
    if args.write_default:
        cache.save(tcache.DEFAULT_CACHE_PATH)
        print(f"\nwrote {len(cache)} winners -> {tcache.DEFAULT_CACHE_PATH}")
    elif args.out:
        cache.save(args.out)
        print(f"\nwrote {len(cache)} winners -> {args.out}")


if __name__ == "__main__":
    main()

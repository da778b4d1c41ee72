"""Driver for the port's batched transform-serving engine.

Generates a seeded synthetic workload (bounded structure pool, random
parameters and point counts -- the serving hot path), serves it through
``GeometryServer`` on the GPU, and prints the per-bucket schedule plus a
comparison against per-request dispatch:

    PYTHONPATH=src python -m repro_torch.launch.serve_transforms --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve_transforms --smoke

``--device cpu`` runs the plain PyTorch path on the CPU instead; without
it the launcher needs a CUDA device and raises when there is none.  The
default pool, ``--templates all``, is every ``TEMPLATES`` structure --
affine and projective, the JAX launcher's mix; ``--templates affine`` keeps
to the affine structures.  ``--trace out.json`` serves the counted flush
under a ``repro_torch.obs`` tracer and writes the span stream as
Chrome-trace JSON -- open it in Perfetto (one track per plan bucket).
``--autotune`` enables the tuning cache (``repro_torch.autotune``): the
size grid and the kernels' launch knobs come from the winners file
(``$REPRO_TORCH_AUTOTUNE_CACHE`` or the committed ``default_cache.json``)
where it holds an entry for the server's backend.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import obs, serving
from repro_torch.serving import workload
from repro_torch.serving.workload import timed as _timed

TEMPLATE_POOLS = {"all": workload.TEMPLATES,
                  "affine": workload.AFFINE_TEMPLATES}


def run_workload(requests: int, *, device: str = "cuda",
                 backend: str | None = None, templates: str = "all",
                 waste_cap: float | None = None, max_points: int,
                 max_points_per_launch: int | None, seed: int,
                 compare: bool = True,
                 trace_path: str | None = None) -> dict:
    """Serve one workload; returns the timing/schedule summary dict.
    ``trace_path`` traces the counted flush and writes Chrome JSON."""
    reqs = workload.random_workload(seed=seed, n_requests=requests,
                                    templates=TEMPLATE_POOLS[templates],
                                    max_points=max_points)
    srv = serving.GeometryServer(device=device, backend=backend,
                                 waste_cap=waste_cap,
                                 max_points_per_launch=max_points_per_launch)
    srv.serve(reqs)                              # warm: build kernels, plans
    srv.reset_stats()
    if trace_path is not None:
        tracer = obs.Tracer()
        with obs.installed(tracer):
            srv.serve(reqs)                      # one counted, traced flush
        obs.dump_chrome_trace(tracer, trace_path)
        print(f"wrote {tracer.n_events} trace events to {trace_path}")
    else:
        srv.serve(reqs)                          # one counted flush
    stats = dict(serving.stats)
    batched_s = min(_timed(lambda: srv.serve(reqs)) for _ in range(3))

    per_request_s = None
    if compare:
        dev_reqs = [(chain, torch.as_tensor(pts, device=srv.device))
                    for chain, pts in reqs]

        def per_request():
            for chain, pts in dev_reqs:
                chain.apply(pts, backend=srv.backend).cpu()
        per_request()                            # warm per-request plans
        per_request_s = min(_timed(per_request) for _ in range(3))

    return {"requests": requests, "batched_s": batched_s,
            "per_request_s": per_request_s, "report": srv.last_report,
            "stats": stats, "device": str(srv.device),
            "backend": srv.backend,
            "grid": (srv.min_len, srv.waste_cap, srv.grid_source)}


def print_summary(res: dict) -> None:
    """Print the bucket schedule and the timings of ``run_workload``."""
    st = res["stats"]
    min_len, cap, src = res["grid"]
    print(f"device: {res['device']} backend: {res['backend']}")
    print(f"size grid: min_len={min_len} waste_cap={cap} ({src})")
    print(f"{'bucket':<12} {'plan':<10} {'lpad':>7} {'reqs':>5} "
          f"{'launches':>8} {'waste':>6}")
    for rep in res["report"]:
        print(f"{rep.structure:<12} {rep.kind:<10} {rep.lpad:>7} "
              f"{rep.requests:>5} {rep.launches:>8} {rep.waste:>6.1%}")
    print(f"\n{st['requests']} requests -> {st['launches']} launches "
          f"({st['buckets']} buckets, {st['shards']} extra shards); "
          f"padding {1 - st['payload_points'] / max(1, st['padded_points']):.1%}")
    line = f"batched: {res['batched_s'] * 1e3:.1f} ms"
    if res["per_request_s"] is not None:
        line += (f"   per-request: {res['per_request_s'] * 1e3:.1f} ms   "
                 f"speedup: {res['per_request_s'] / res['batched_s']:.2f}x")
    print(line)


def main(argv=None) -> None:
    """Parse the command line and serve one workload."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["cuda", "ref"],
                    help="unset: the kernels on cuda, the plain versions "
                         "on cpu; ref on cuda runs the plain versions on "
                         "the card")
    ap.add_argument("--templates", default="all",
                    choices=sorted(TEMPLATE_POOLS),
                    help="template pool: all (affine and projective "
                         "structures) or affine")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--waste-cap", type=float, default=None,
                    help="explicit padding-waste cap; unset defers to the "
                         "tuning cache (with --autotune) or the default "
                         "grid")
    ap.add_argument("--autotune", action="store_true",
                    help="consult the tuning cache for the size grid and "
                         "the kernels' launch knobs")
    ap.add_argument("--max-points", type=int, default=4096)
    ap.add_argument("--max-points-per-launch", type=int, default=None,
                    help="shard buckets whose packed B*L exceeds this")
    ap.add_argument("--no-compare", action="store_true",
                    help="skip the per-request dispatch baseline")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny workload; liveness check")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="trace the counted flush and write it as "
                         "Chrome-trace JSON (open in Perfetto)")
    args = ap.parse_args(argv)

    if args.autotune:
        from repro_torch import autotune
        autotune.set_enabled(True)
    res = run_workload(16 if args.smoke else args.requests,
                       device=args.device, backend=args.backend,
                       templates=args.templates, waste_cap=args.waste_cap,
                       max_points=128 if args.smoke else args.max_points,
                       max_points_per_launch=args.max_points_per_launch,
                       seed=args.seed, compare=not args.no_compare,
                       trace_path=args.trace)
    print_summary(res)


if __name__ == "__main__":
    main()

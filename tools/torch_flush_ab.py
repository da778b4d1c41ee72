#!/usr/bin/env python3
"""Compare a flush between two checkouts of the PyTorch port on one GPU,
in turns (A, B, B, A), so that the card and its host are the same for
both.

    python3 tools/torch_flush_ab.py PATH_A PATH_B [--reps 7]
                                    [--workload mixed|graphics]

Each turn is a process of its own that imports ``repro_torch`` from that
checkout's ``src`` (building its kernels there on first use) and times
``--reps`` flushes of one of ``chip_smoke.py``'s workloads on the card:

  * ``mixed`` (the default): ``random_workload(seed=0, n_requests=1024,
    templates=TEMPLATES, min_points=1024, max_points=262144)`` through
    one ``GeometryServer``: one warm flush, then each round submits all
    1024 requests and flushes once, submit and flush timed apart;
  * ``graphics``: the graphics phase's 64 frames of 65 536 points, one
    orbiting camera's viewing chains (from that checkout's
    ``chip_smoke.py``), served by a fresh ``GeometryServer`` each round
    (submit and one flush, timed together, as that phase times its one
    serve), after one mixed serve as the smoke's earlier phases run.

It prints one JSON line: the checkout, each flush's ms and their median,
the median submit ms, each flush's host phases as the server reports
them (``last_timing``: pack, dispatch, unpack; the device span) and
their medians, and the pinned blocks each flush had the caching host
allocator take from the driver.  The
last line is the four medians in turn order and the mean of each
checkout's two turns (``tools/torch_turns.py`` runs the turns).
"""
from __future__ import annotations

import os
import sys
import time

from torch_turns import ab_main, pair


def one(tree: str, args) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch

    from repro_torch import serving
    from repro_torch.kernels import _build
    from repro_torch.serving import workload

    if not torch.cuda.is_available():
        raise SystemExit("torch_flush_ab: needs a CUDA device")
    _build.build_all()
    reqs = workload.random_workload(seed=0, n_requests=1024,
                                    templates=workload.TEMPLATES,
                                    min_points=1024, max_points=262144)
    srv = serving.GeometryServer(device="cuda")
    srv.serve(reqs)                                  # warm
    flush_s, submit_s, phases, allocs = [], [], [], []

    def host_allocs() -> int:
        """Pinned blocks the caching host allocator has asked the driver
        for so far (0 where torch reports no host statistics)."""
        stats = getattr(torch.cuda, "host_memory_stats", None)
        return int(stats().get("num_host_alloc", 0)) if stats else 0

    if args.workload == "graphics":
        sys.path.insert(0, tree)
        import chip_smoke as smoke
        from repro_torch import graphics
        viewport = graphics.Viewport(0, 0, 1920, 1080, (0, 1))
        rng = np.random.default_rng(smoke.SEED)
        rng.standard_normal((smoke.CLOUD_POINTS, 3))  # the phase's cloud
        frames = [(graphics.viewing_chain(camera=smoke.orbit_camera(k),
                                          viewport=viewport),
                   (rng.standard_normal((smoke.FRAME_POINTS, 3)) * 4)
                   .astype(np.float32)) for k in range(smoke.FRAMES)]
        for _ in range(args.reps):
            srv = serving.GeometryServer(device="cuda")
            n0 = host_allocs()
            t0 = time.perf_counter()
            srv.serve(frames)
            flush_s.append(time.perf_counter() - t0)
            allocs.append(host_allocs() - n0)
            submit_s.append(0.0)
            phases.append(srv.last_timing)
    else:
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for chain, pts in reqs:
                srv.submit(chain, pts)
            n0 = host_allocs()
            t1 = time.perf_counter()
            srv.flush()
            flush_s.append(time.perf_counter() - t1)
            allocs.append(host_allocs() - n0)
            submit_s.append(t1 - t0)
            phases.append(srv.last_timing)
    med = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    return {"tree": tree, "workload": args.workload,
            "flush_ms": [s * 1e3 for s in flush_s],
            "median_ms": float(np.median(flush_s)) * 1e3,
            "submit_ms": float(np.median(submit_s)) * 1e3,
            "host_allocs": allocs,
            "phases_each": phases,
            "phases_ms": {k.removesuffix("_s"): v * 1e3 if k.endswith("_s")
                          else v for k, v in med.items()},
            "device": torch.cuda.get_device_name(0)}


def summary(turns: list, args) -> dict:
    return pair([t["median_ms"] for t in turns])


if __name__ == "__main__":
    sys.exit(ab_main(__doc__, __file__, one, summary,
                     options={"--reps": dict(type=int, default=7),
                              "--workload": dict(
                                  default="mixed",
                                  choices=("mixed", "graphics"))}))

#!/usr/bin/env python3
"""Time the mixed serve's clean flush before and after a faulted one, in
one checkout of the PyTorch port on one GPU.

    python3 tools/torch_flush_after_faults.py [PATH] [--variants V,...]

Each variant is a process of its own (``tools/torch_turns.py``) that
imports ``repro_torch`` from ``PATH/src`` (default: this checkout),
builds its kernels and serves ``chip_smoke.py``'s mixed workload --
``random_workload(seed=0, n_requests=1024, templates=TEMPLATES,
min_points=1024, max_points=262144)`` -- through one ``GeometryServer``
on the card: a warm flush, three timed flushes, then the variant's
event, then three timed flushes on the same server and three on a fresh
one.  A variant is an event, then optionally ``+gc`` (``gc.collect()``)
and ``+empty`` (the caching host allocator's free pinned blocks
released, ``torch._C._host_emptyCache``) after it, and ``+mmap``
(glibc's mmap threshold fixed at 128 KiB, ``MALLOC_MMAP_THRESHOLD_``),
``+trim`` (its trim threshold at 1 GiB, ``MALLOC_TRIM_THRESHOLD_``) or
``+heap`` (both: the mmap threshold at its 32 MiB maximum and the trim
threshold at 1 GiB, so freed results stay on the heap) for the whole
process.  The events:

  * ``none``: nothing (the control);
  * ``faulted``: the workload flushed once on another server under
    ``FaultInjector(seed=11)`` at the chaos soak's rates, backoff 0 (the
    ``chaos (mixed)`` phase of ``chip_smoke.py``);
    ``faulted-nocorrupt`` the same without corruptions;
  * ``soak``: ``run_chaos_soak(seed=11, n_requests=64)``; ``soak-clean``
    the same with no fault and no malformed submission.

Every timed flush reports its ms, the host phases the server reports
(pack, dispatch, unpack; the device span), unpack split into its wait
for each launch's ``done`` event and the host work after it, and
``copy_ms``: the host
time to copy its results into fresh numpy arrays, which touches new
memory as unpack does.  After each block of three, a probe times the
host's read and write of 200 MB of a pinned tensor the caching host
allocator hands out, filled by a device-to-host copy, beside a pageable
one.  Each block of three reports the process's page
faults and user and system CPU seconds over it (``getrusage``), and its
peak resident memory and the caching host allocator's statistics
after it.  Each variant
prints one JSON line; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import os
import resource
import subprocess
import sys
import time

from torch_turns import turn

EVENTS = ("none", "faulted", "faulted-nocorrupt", "soak", "soak-clean")
VARIANTS = ("none", "faulted", "faulted-nocorrupt", "soak", "soak-clean",
            "soak+gc+empty")
#: the chaos soak's injection rates (``run_chaos_soak``'s defaults)
RATES = dict(flaky_rate=0.06, backend_rate=0.05, corrupt_rate=0.05,
             poison_rate=0.03)
def _usage() -> dict:
    """The process's page faults and CPU seconds so far (``getrusage``:
    user time is Python and numpy, system time the kernel's share, page
    faults included) and its peak resident memory."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"minflt": ru.ru_minflt, "majflt": ru.ru_majflt,
            "user_s": ru.ru_utime, "sys_s": ru.ru_stime,
            "maxrss_kb": ru.ru_maxrss}


def one(tree: str, variant: str) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    import gc

    import numpy as np
    import torch

    from repro_torch import serving
    from repro_torch.kernels import _build
    from repro_torch.serving import engine, workload

    if not torch.cuda.is_available():
        raise SystemExit("torch_flush_after_faults: needs a CUDA device")
    _build.build_all()
    # unpack's wait for its launch's copies, apart from its host work
    waits = []
    unpack = engine.GeometryServer._unpack

    def timed_unpack(self, plan, reqs, res, results):
        t0 = time.perf_counter()
        if res.done is not None:
            res.done.synchronize()
        t1 = time.perf_counter()
        unpack(self, plan, reqs, res, results)
        waits.append((t1 - t0, time.perf_counter() - t1))
    engine.GeometryServer._unpack = timed_unpack
    reqs = workload.random_workload(seed=0, n_requests=1024,
                                    templates=workload.TEMPLATES,
                                    min_points=1024, max_points=262144)

    def probe() -> dict:
        """Host ms to read (copy out with numpy) and to write 200 MB of
        a pinned tensor the caching host allocator hands out, after a
        device-to-host copy into it, beside a pageable tensor."""
        n = 50 << 20
        src = torch.ones(n, device="cuda")
        out = {}
        for kind, pin in (("pinned", True), ("pageable", False)):
            host = torch.empty(n, pin_memory=pin)
            host.copy_(src, non_blocking=pin)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = np.array(host.numpy())
            out[f"{kind}_read_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            host.numpy()[:] = got
            out[f"{kind}_write_ms"] = (time.perf_counter() - t0) * 1e3
            del host, got
        return out

    def block(srv) -> dict:
        before = _usage()
        runs = []
        for _ in range(3):
            for chain, pts in reqs:
                srv.submit(chain, pts)
            waits.clear()
            t0 = time.perf_counter()
            out = srv.flush()
            flush_ms = (time.perf_counter() - t0) * 1e3
            wait_ms, work_ms = (sum(w) * 1e3 for w in zip(*waits))
            t0 = time.perf_counter()
            copies = [np.array(r) for r in out]
            copy_ms = (time.perf_counter() - t0) * 1e3
            del copies, out
            runs.append({"flush_ms": flush_ms, "copy_ms": copy_ms,
                         "unpack_wait_ms": wait_ms,
                         "unpack_work_ms": work_ms,
                         **{k.removesuffix("_s") + "_ms" if k.endswith("_s")
                            else k: v * 1e3 if k.endswith("_s") else v
                            for k, v in srv.last_timing.items()}})
        after = _usage()
        stats = getattr(torch.cuda, "host_memory_stats", None)
        return {"runs": runs, "probe": probe(),
                "usage": {k: after[k] - before[k] if k != "maxrss_kb"
                          else after[k] for k in after},
                "host_memory_stats": {k: int(v) for k, v in stats().items()}
                if stats else None}

    def event(name: str) -> dict:
        if name.startswith("soak"):
            clean = dict(flaky_rate=0.0, backend_rate=0.0, corrupt_rate=0.0,
                         poison_rate=0.0, malformed_every=0)
            rep = serving.run_chaos_soak(seed=11, n_requests=64,
                                         **(clean if name == "soak-clean"
                                            else {}))
            return {"launch_failures": rep.launch_failures}
        rates = dict(RATES, corrupt_rate=0.0) \
            if name == "faulted-nocorrupt" else RATES
        srv = serving.GeometryServer(
            fault_config=serving.FaultConfig(backoff_base_s=0.0),
            injector=serving.FaultInjector(seed=11, **rates))
        for chain, pts in reqs:
            srv.submit(chain, pts)
        t0 = time.perf_counter()
        srv.flush()
        return {"faulted_flush_ms": (time.perf_counter() - t0) * 1e3,
                "launch_failures": serving.stats["launch_failures"]}

    srv = serving.GeometryServer()
    srv.serve(reqs)                                  # warm
    out = {"tree": tree, "variant": variant, "before": block(srv)}
    name, *then = variant.split("+")
    out["malloc_env"] = {k: v for k, v in os.environ.items()
                         if k.startswith("MALLOC_")}
    if name != "none":
        serving.reset_stats()
        use = _usage()
        out["event"] = event(name)
        out["event"]["usage"] = {k: v - use[k] for k, v in _usage().items()}
    if "gc" in then:
        gc.collect()
    if "empty" in then:
        torch._C._host_emptyCache()
    out["after"] = block(srv)
    fresh = serving.GeometryServer()
    fresh.serve(reqs)                                # warm
    out["after_fresh_server"] = block(fresh)
    out["device"] = torch.cuda.get_device_name(0)
    out["torch"] = torch.__version__
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--one", help="run one variant in this checkout")
    ap.add_argument("--variant", default="none")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if args.one:
        import json
        print(json.dumps(one(os.path.abspath(args.one), args.variant)),
              flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    for variant in args.variants.split(","):
        name, *then = variant.split("+")
        if name not in EVENTS or not set(then) <= {"gc", "empty", "mmap",
                                                   "trim", "heap"}:
            ap.error(f"a variant is one of {EVENTS}, then any of +gc, "
                     f"+empty, +mmap, +trim, +heap; got {variant!r}")
        env = dict(os.environ)
        if "mmap" in then:
            os.environ["MALLOC_MMAP_THRESHOLD_"] = str(128 << 10)
        if "heap" in then:
            os.environ["MALLOC_MMAP_THRESHOLD_"] = str(32 << 20)
        if "trim" in then or "heap" in then:
            os.environ["MALLOC_TRIM_THRESHOLD_"] = str(1 << 30)
        turn(__file__, [os.path.abspath(args.tree), "--variant", variant])
        os.environ.clear()
        os.environ.update(env)
    return 0


if __name__ == "__main__":
    sys.exit(main())

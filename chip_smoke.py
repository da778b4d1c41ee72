#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``;
  3. serve: the main path.  1024 requests from the affine template pool
     (lognormal sizes from 1024 to 262144 points, median 16384) through
     ``GeometryServer`` on the GPU -- one warm flush, then three rounds
     of submitting all 1024 and one timed flush (submit and flush timed
     apart) -- then every request through per-request
     ``TransformChain.apply``.
     Kernel launch counts are zeroed just before and read just after.
     Every served result must be bitwise equal to the same request served
     with ``backend="ref"`` (the plain PyTorch versions) on the card and to
     per-request ``apply``, and within 4 float32 epsilons of a float64
     evaluation of its fold;
  4. each kernel at the path's shapes (flat 2**24 points for d = 2 and 3,
     the flat kernels also at the median and the largest request of the
     served workload -- the sizes per-request ``apply`` hands them -- and
     the batch kernels at the largest served bucket of each plan kind):
     bitwise equal to its
     plain version on the same inputs, timed with CUDA events (median of
     25 runs, L2 flushed between runs and the device kept busy while the
     host enqueues, so the time is the device's) and its host cost per
     call, beside its plain version, one
     PyTorch library call (``torch.addcmul`` / ``torch.baddbmm``, a
     yardstick only -- the port never calls it) and its memory bound;
  5. the ``kernels`` line, then the device line last.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import serving  # noqa: E402
from repro_torch.kernels import _build, opcount  # noqa: E402
from repro_torch.kernels.affine import affine as diag_k  # noqa: E402
from repro_torch.kernels.affine import ref as diag_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul as matrix_k  # noqa: E402
from repro_torch.kernels.matmul import ref as matrix_ref  # noqa: E402
from repro_torch.serving import workload  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
N_FLAT = 1 << 24
REPS = 25
#: GPU cycles (~1 ms) the device spins before each timed run, so the
#: host's cost of enqueueing the call stays out of the event window
SPIN_CYCLES = 2_000_000
EPS32 = float(np.finfo(np.float32).eps)
SEED = 0

KERNELS = {   # name -> (source, the TPU kernel it replaces, plan kind)
    "chain_diag_1d": ("src/repro_torch/kernels/csrc/chain_diag.cu",
                      "src/repro/kernels/affine/affine.py:82", "diag"),
    "chain_diag_batch_2d": ("src/repro_torch/kernels/csrc/chain_diag.cu",
                            "src/repro/kernels/affine/affine.py:129", "diag"),
    "chain_matrix_1d": ("src/repro_torch/kernels/csrc/chain_matrix.cu",
                        "src/repro/kernels/matmul/matmul.py:99", "matrix"),
    "chain_matrix_batch_2d": ("src/repro_torch/kernels/csrc/chain_matrix.cu",
                              "src/repro/kernels/matmul/matmul.py:158",
                              "matrix"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bitwise_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- the main path -----------------------------------------------------------

def fold_oracle_ok(chain, pts: np.ndarray, out: np.ndarray) -> bool:
    """``out`` within 4 float32 epsilons per term of the float64 value of
    the chain's float32 fold: |out - q| <= 4 eps (sum_m |p_m A_mc| + |t_c|)."""
    p = pts.reshape(-1, chain.dim).astype(np.float64)
    if chain.is_diagonal:
        s, t = (f.astype(np.float64) for f in chain.fold())
        q, mag = p * s + t, np.abs(p * s) + np.abs(t)
    else:
        a, t = (f.astype(np.float64) for f in chain.fold())
        q, mag = p @ a + t, np.abs(p) @ np.abs(a) + np.abs(t)
    got = out.reshape(-1, chain.dim).astype(np.float64)
    return bool(np.isfinite(got).all()
                and (np.abs(got - q) <= 4 * EPS32 * mag).all())


def serve_phase(device: str = "cuda", n_requests: int = 1024,
                min_points: int = 1024,
                max_points: int = 262144) -> tuple[dict, dict, dict, tuple]:
    """Drive the main path; returns (kernel launch counts of the run,
    the serving summary, the largest served bucket shape per plan kind,
    the median and the largest request's point count)."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=n_requests,
        templates=workload.AFFINE_TEMPLATES, min_points=min_points,
        max_points=max_points)
    n_diag = sum(c.is_diagonal for c, _ in reqs)

    serving.reset_stats()
    _build.reset_launch_counts()
    srv = serving.GeometryServer(device=device)
    srv.serve(reqs)                                  # warm flush
    submit_s, flush_s, timings, outs = [], [], [], None
    for _ in range(3):
        t0 = time.perf_counter()
        for chain, pts in reqs:
            srv.submit(chain, pts)
        t1 = time.perf_counter()
        outs = srv.flush()                           # numpy results: synced
        flush_s.append(time.perf_counter() - t1)
        submit_s.append(t1 - t0)
        timings.append(srv.last_timing)
    t0 = time.perf_counter()
    applied = [c.apply(torch.from_numpy(p).to(device)).cpu().numpy()
               for c, p in reqs]
    apply_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = dict(serving.stats)
    flushes = 4

    buckets = len(srv.last_report)
    if stats["launches"] != stats["buckets"] or stats["buckets"] != flushes * buckets:
        raise SystemExit(f"launches {stats['launches']} != buckets "
                         f"{stats['buckets']} ({flushes} x {buckets})")
    batched = counts["chain_diag_batch_2d"] + counts["chain_matrix_batch_2d"]
    if batched != stats["launches"]:
        raise SystemExit(f"batch kernels launched {batched} times, serving "
                         f"counted {stats['launches']} launches")
    if counts["chain_diag_1d"] != n_diag \
            or counts["chain_matrix_1d"] != len(reqs) - n_diag:
        raise SystemExit(f"per-request applies launched {counts}, expected "
                         f"{n_diag} diag and {len(reqs) - n_diag} matrix")

    ref_outs = serving.GeometryServer(device=device, backend="ref").serve(reqs)
    for i, ((chain, pts), out) in enumerate(zip(reqs, outs)):
        if out.shape != pts.shape or not np.isfinite(out).all():
            raise SystemExit(f"request {i}: bad result shape/values")
        if not bitwise_equal(out, ref_outs[i]):
            raise SystemExit(f"request {i}: kernel != plain version on the card")
        if not bitwise_equal(out, applied[i]):
            raise SystemExit(f"request {i}: packed != per-request apply")
        if not fold_oracle_ok(chain, pts, out):
            raise SystemExit(f"request {i}: outside 4 eps of the float64 fold")

    med = {k: float(np.median([t[k] for t in timings])) for k in timings[0]}
    summary = {
        "phase": "serve", "requests": len(reqs), "buckets": buckets,
        "launches_per_flush": stats["launches"] // flushes,
        "payload_points": stats["payload_points"] // flushes,
        "padded_points": stats["padded_points"] // flushes,
        "payload_MB": sum(p.nbytes for _, p in reqs) / 1e6,
        "submit_ms": [s * 1e3 for s in submit_s],
        "flush_ms": [s * 1e3 for s in flush_s],
        "flush_ms_median": float(np.median(flush_s)) * 1e3,
        "points_per_s": stats["payload_points"] // flushes
        / float(np.median(flush_s)),
        "served_points_per_s": stats["payload_points"] // flushes
        / float(np.median(np.add(submit_s, flush_s))),
        "pack_ms": med["pack_s"] * 1e3, "dispatch_ms": med["dispatch_s"] * 1e3,
        "unpack_ms": med["unpack_s"] * 1e3,
        "device_span_ms": med.get("device_ms"),
        "per_request_apply_ms": apply_s * 1e3,
        "bitwise_vs_ref": True, "bitwise_vs_apply": True, "fold_oracle": True,
    }
    largest = {}
    for rep in srv.last_report:
        if rep.padded_points > largest.get(rep.kind, (0, 0, 0, 0))[3]:
            largest[rep.kind] = (rep.requests, rep.lpad,
                                 int(rep.structure[0]), rep.padded_points)
    sizes = sorted(p.shape[0] for _, p in reqs)
    return counts, summary, {k: v[:3] for k, v in largest.items()}, \
        (sizes[len(sizes) // 2], sizes[-1])


# -- per-kernel checks and timings ---------------------------------------------

_L2_FLUSH = None


def time_ms(fn) -> tuple[float, float]:
    """(device ms, host us) of ``fn``: the median CUDA-event time over REPS
    runs, L2 flushed before each run (a 128 MB write) and the device
    spinning while the host enqueues, and the median host time of one
    call (enqueueing only: the device is still spinning); after one warm
    run."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    times, host = [], []
    for _ in range(REPS):
        _L2_FLUSH.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), float(np.median(host)) * 1e6


def kernel_case(name: str, shape: tuple, rng: np.random.Generator,
                size: str) -> dict:
    """Check and time one kernel at one shape: (N, d) flat or (B, L, d);
    ``size`` says which of the path's sizes the shape is."""
    d = shape[-1]
    kind = KERNELS[name][2]
    batched = len(shape) == 3
    lead = shape[:1] if batched else ()
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(-3, 3, lead + (d,)).astype(np.float32)).to(dev)
    if kind == "diag":
        p = torch.from_numpy(rng.uniform(0.2, 2, lead + (d,)).astype(np.float32)).to(dev)
        if batched:
            run = lambda: diag_k.chain_diag_batch_2d(x, p, t)   # noqa: E731
            plain = lambda: diag_ref.chain_diag_batch(x, p, t)  # noqa: E731
            lib = lambda: torch.addcmul(t[:, None], x, p[:, None])  # noqa: E731
        else:
            run = lambda: diag_k.chain_diag_1d(x.reshape(-1), p, t, d=d).reshape(shape)  # noqa: E731
            plain = lambda: diag_ref.chain_diag(x, p, t)  # noqa: E731
            lib = lambda: torch.addcmul(t, x, p)  # noqa: E731
        ops = 2 * x.numel()
    else:
        p = torch.from_numpy(rng.uniform(-1, 1, lead + (d, d)).astype(np.float32)).to(dev)
        if batched:
            run = lambda: matrix_k.chain_matrix_batch_2d(x, p, t)   # noqa: E731
            plain = lambda: matrix_ref.chain_matrix_batch(x, p, t)  # noqa: E731
            lib = lambda: torch.baddbmm(t[:, None], x, p)  # noqa: E731
        else:
            run = lambda: matrix_k.chain_matrix_1d(x.reshape(-1), p, t, d=d).reshape(shape)  # noqa: E731
            plain = lambda: matrix_ref.chain_matrix(x, p, t)  # noqa: E731
            lib = lambda: torch.baddbmm(t.view(1, 1, d), x.view(1, -1, d), p.view(1, d, d)).view(shape)  # noqa: E731
        ops = 2 * d * x.numel()
    got, want = run(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"{name} {shape}: kernel != plain version")
    err = float((got - want).abs().max())
    n_points = x.numel() // d
    nbytes = opcount.packed_chain_bytes(shape[0], shape[1], d, kind=kind) \
        if batched else opcount.fused_chain_bytes(n_points, d, kind=kind)
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(run), time_ms(plain), time_ms(lib)
    row = {"kernel": name, "size": size, "shape": list(shape), "equal": True,
           "max_abs_err": err, "ms": ms, "bytes": nbytes,
           "GB/s": nbytes / ms / 1e6, "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "plain_ms": plain_ms, "library_ms": lib_ms, "host_us": host_us,
           "plain_host_us": plain_us, "library_host_us": lib_us}
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # the baddbmm yardstick
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": _build.sources()})

    counts, summary, largest, (median_n, max_n) = serve_phase()
    emit(summary)

    rng = np.random.default_rng(SEED)
    rows = {}
    for d in (2, 3):
        for name in ("chain_diag_1d", "chain_matrix_1d"):
            rows[name] = kernel_case(name, (N_FLAT, d), rng, "flat 2**24")
    for size, n in (("median request", median_n), ("largest request", max_n)):
        for d in (2, 3):
            for name in ("chain_diag_1d", "chain_matrix_1d"):
                kernel_case(name, (n, d), rng, size)
    for name, kind in (("chain_diag_batch_2d", "diag"),
                       ("chain_matrix_batch_2d", "matrix")):
        rows[name] = kernel_case(name, largest[kind], rng, "largest bucket")

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        if counts[name] == 0:
            raise SystemExit(f"{name} was never launched on the main path")
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "shape": r["shape"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``;
  3. serve (affine): 1024 requests from the affine template pool
     (lognormal sizes from 1024 to 262144 points, median 16384) through
     ``GeometryServer`` on the GPU -- one warm flush, then three rounds
     of submitting all 1024 and one timed flush (submit and flush timed
     apart) -- then every request through per-request
     ``TransformChain.apply``.  Kept as it was, so its series stays
     comparable;
  4. serve (mixed): the main path, the same run over the full
     ``TEMPLATES`` pool -- the JAX launcher's default mix, about 3/11 of
     the requests projective -- with per-request ``project`` for the
     projective requests and ``apply`` for the rest;
  5. graphics: one ``viewing_chain`` (camera, perspective, cull,
     viewport) projects a 2**20-point cloud in one launch, then 64 frames
     of 65536 points with the camera stepped around an orbit serve as one
     ``GeometryServer`` flush, one projective bucket;
  6. serve (q-mixed): the mixed serve's workload with every affine
     request submitted with ``qformat="q8.7"`` -- the odd ones (by index
     k among the affine requests) as int16 words, the even ones as
     float32, and every 16th (k = 0 mod 16) scaled by 512 so that it
     cannot fit and the default ``on_q_overflow="fallback"`` reroutes it
     to the float lane (47 a flush); projective requests go without a
     format.  Every q-lane result must be bitwise equal to the plain
     path on the card, to per-request ``apply(dtype="q8.7")`` and to the
     numpy Q oracle on the quantised points and fold, and a float
     submission's within ``quantize.error_bound`` of the float64 chain;
     int16 in gives int16 out, float in float32; each fallback bitwise
     equal to the float lane's ``apply``; the q buckets' launch bytes
     exactly half of what the same buckets move at 4 bytes a word.
  7. primitives: the paper's own routines -- translation and scaling at
     n = 8 and 64, the 8x8 matmul and Composite II on the port's M1
     emulator (host numpy), values equal to the int16 oracles, cycles
     beside the paper's Table 5 with the match flags the emulator's tests
     expect; then the eager primitives of ``core/transform_engine.py``
     (translate, scale, affine, rotate, vecadd) on a 2**20-point cloud
     (d = 2, and d = 3 for translate and scale), each bitwise equal to
     the same call with ``backend="ref"`` on the card and within its
     float64 bound; then the paper's comparison: kernel_bench.py's
     sequential pipeline translate(t2), scale(s), rotate(0.3),
     translate(t1) -- four launches, ``affine_2d`` x3 and ``matmul_2d``
     x1 -- against the same ``Transform2D`` chain's one
     ``chain_matrix_1d`` launch, with both results within 4 eps32 mag_c
     of the exact transform, mag_c = sum_m (|p_m| + |t2_m|) |s_m| |R_mc|
     + |t1_c| (so within 8 eps32 mag_c of each other), their opcount
     bytes and CUDA-event times of the calls as a user makes them (the
     kernels alone are summed from phase 8's rows at the cloud shape).
     In phases 3-7 kernel launch counts are zeroed just before each path
     and read just after.  Every served or projected float result must be
     bitwise equal to the same request run with ``backend="ref"`` (the
     plain PyTorch versions) on the card and to per-request
     ``apply``/``project``, masks included, and within the float64 bound
     of its fold: 4 eps32 (sum_m |p_m A_mc| + |t_c|) for affine plans,
     4 eps32 [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| +
     |H_dd|)] / |w| for projective ones, whose masks must equal the
     float64 mask wherever every margin exceeds that bound;
  8. each kernel at the path's shapes (flat 2**24 points for d = 2 and 3,
     the flat kernels also at the median and the largest request of the
     served workload -- the sizes per-request ``apply``/``project`` hand
     them -- and the batch kernels at the largest served bucket of each
     plan kind): bitwise equal to its plain version on the same inputs
     (points and mask; the int16 kernels at full-range words and at
     n_frac 0, 7 and 15), timed with CUDA events (median of 25 runs, L2
     flushed between runs and the device kept busy while the host
     enqueues, so the time is the device's) and its host cost per call,
     beside its plain version, one PyTorch library call
     (``torch.addcmul`` / ``torch.baddbmm``; for the projective and the
     int16 kernels, which no single call computes, a composite: for the
     projective ones ``addmm``/``baddbmm``, a divide and two compares,
     for the int16 ones a float64 ``addcmul``/``addmm``/``baddbmm``, then
     an int64 rounding shift) -- a yardstick only, the port never calls
     it -- and its bound; the eager kernels at the shapes of
     kernel_bench.py and of the primitives phase: ``affine_2d`` and
     ``vecadd_2d`` at (1024, 1024) float32 and bfloat16 and at (2**20, 2),
     ``matmul_2d`` at 1024**3 bfloat16 and float32 and at (2**20, 2) @
     (2, 2), against ``torch.addcmul`` / ``torch.add`` / ``torch.matmul``,
     and ``chain_matrix_1d`` at (2**20, 2); then the paper's comparison
     of the kernels alone: three ``affine_2d`` and one ``matmul_2d`` row
     medians at the cloud shape, summed, against ``chain_matrix_1d``'s;
  9. the ``kernels`` line (launches from the mixed serve, for the int16
     kernels from the q-mixed serve, for the eager ones from the
     primitives phase), then the device line last.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import graphics, quantize, serving  # noqa: E402
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core import transform_engine as te  # noqa: E402
from repro_torch.core.morphosys import intel, programs  # noqa: E402
from repro_torch.kernels import _build, opcount  # noqa: E402
from repro_torch.kernels.affine import affine as diag_k  # noqa: E402
from repro_torch.kernels.affine import ref as diag_ref  # noqa: E402
from repro_torch.kernels.fixedpoint import fixedpoint as q_k  # noqa: E402
from repro_torch.kernels.fixedpoint import ref as q_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul as matrix_k  # noqa: E402
from repro_torch.kernels.matmul import ref as matrix_ref  # noqa: E402
from repro_torch.kernels.projective import projective as proj_k  # noqa: E402
from repro_torch.kernels.projective import ref as proj_ref  # noqa: E402
from repro_torch.serving import workload  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: int32 multiply-adds run on half as many lanes as float32 ones (64
#: INT32 against 128 FP32 lanes an SM, Hopper architecture white paper)
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
N_FLAT = 1 << 24
REPS = 25
#: GPU cycles (~1 ms) the device spins before each timed run, so the
#: host's cost of enqueueing the call stays out of the event window
SPIN_CYCLES = 2_000_000
EPS32 = float(np.finfo(np.float32).eps)
SEED = 0
#: the graphics phase: one cloud projected in one launch, then frames
#: of one orbiting camera served as one bucket
CLOUD_POINTS = 1 << 20
FRAMES, FRAME_POINTS = 64, 65536
Q8_7 = quantize.Q8_7
#: the q-mixed serve: every FALLBACK_EVERY-th affine request is scaled
#: by FALLBACK_SCALE, out of q8.7's range
FALLBACK_EVERY, FALLBACK_SCALE = 16, np.float32(512.0)
#: the fraction-bit counts the int16 kernels are checked at
Q_FRACS = (0, 7, 15)
#: H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_OPS_PER_S = 989e12
#: the primitives phase: kernel_bench.py's sequential pipeline
#: translate(T2), scale(SV), rotate(THETA), translate(T1)
T1, T2, SV, THETA = (3.0, 2.0), (-1.0, 5.0), (1.3, 0.8), 0.3
#: Table 5's M1 rows the emulator reproduces exactly; the two matrix
#: routines have no published listing and the reconstruction is faster
EMULATOR_EXACT = {("translation", 8), ("translation", 64),
                  ("scaling", 8), ("scaling", 64)}

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
    "chain_project_1d": ("src/repro_torch/kernels/csrc/chain_project.cu",
                         "src/repro/kernels/projective/projective.py:82",
                         "projective"),
    "chain_project_batch_2d": ("src/repro_torch/kernels/csrc/chain_project.cu",
                               "src/repro/kernels/projective/projective.py:152",
                               "projective"),
    "chain_diag_1d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                        "src/repro/kernels/fixedpoint/fixedpoint.py:52",
                        "diag"),
    "chain_matrix_1d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                          "src/repro/kernels/fixedpoint/fixedpoint.py:97",
                          "matrix"),
    "chain_diag_batch_2d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                              "src/repro/kernels/fixedpoint/fixedpoint.py:140",
                              "diag"),
    "chain_matrix_batch_2d_q": ("src/repro_torch/kernels/csrc/chain_fixedpoint.cu",
                                "src/repro/kernels/fixedpoint/fixedpoint.py:183",
                                "matrix"),
    "affine_2d": ("src/repro_torch/kernels/csrc/affine_2d.cu",
                  "src/repro/kernels/affine/affine.py:52", "eager"),
    "vecadd_2d": ("src/repro_torch/kernels/csrc/affine_2d.cu",
                  "src/repro/kernels/affine/affine.py:165", "eager"),
    "matmul_2d": ("src/repro_torch/kernels/csrc/matmul_2d.cu",
                  "src/repro/kernels/matmul/matmul.py:40", "eager"),
}
FLAT = {"diag": "chain_diag_1d", "matrix": "chain_matrix_1d",
        "projective": "chain_project_1d"}
BATCH = {"diag": "chain_diag_batch_2d", "matrix": "chain_matrix_batch_2d",
         "projective": "chain_project_batch_2d"}
Q_FLAT = {"diag": "chain_diag_1d_q", "matrix": "chain_matrix_1d_q"}
Q_BATCH = {"diag": "chain_diag_batch_2d_q", "matrix": "chain_matrix_batch_2d_q"}
FLOAT_KERNELS = [k for k, v in KERNELS.items()
                 if v[2] != "eager" and not k.endswith("_q")]
EAGER_KERNELS = [k for k, v in KERNELS.items() if v[2] == "eager"]


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


def require_launched(counts: dict, names, phase: str) -> None:
    for name in names:
        if counts[name] == 0:
            raise SystemExit(f"{name} was never launched in the {phase} run")


# -- the float64 oracles ---------------------------------------------------------

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


def project_oracle_ok(folded, pts: np.ndarray, out: np.ndarray,
                      mask: np.ndarray) -> tuple[bool, int]:
    """A projective result against the float64 value of its float32 fold
    (H, lo, hi): every element within

        4 eps [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| + |H_dd|)] / |w|

    (4 eps (sum_m |p_m H_mc| + |H_dc|) where w <= 0) wherever w's margin
    to 0 exceeds its own bound, and the mask equal to the float64 mask
    wherever every margin exceeds the bound.  Returns (ok, points whose
    margins lie within the bound -- not held to the float64 mask)."""
    d = pts.shape[-1]
    p = pts.reshape(-1, d).astype(np.float64)
    h, lo, hi = (f.astype(np.float64) for f in folded)
    qh = p @ h[:d] + h[d]
    mag = np.abs(p) @ np.abs(h[:d]) + np.abs(h[d])
    w = qh[:, d]
    w_ok = w > 0
    safe = np.where(w_ok, w, 1.0)[:, None]
    v = qh[:, :d] / safe
    bound = 4 * EPS32 * np.where(w_ok[:, None],
                                 (mag[:, :d] + np.abs(v) * mag[:, d:]) / safe,
                                 mag[:, :d])
    w_clear = np.abs(w) > 4 * EPS32 * mag[:, d]
    got = out.reshape(-1, d).astype(np.float64)
    values_ok = np.isfinite(got).all() \
        and bool((np.abs(got - v) <= bound)[w_clear].all())
    inside64 = w_ok & np.all((v >= lo) & (v <= hi), axis=-1)
    clear = w_clear & np.all((np.abs(v - lo) > bound)
                             & (np.abs(v - hi) > bound), axis=-1)
    mask_ok = bool((mask.reshape(-1) == inside64)[clear].all())
    return values_ok and mask_ok, int((~clear).sum())


def check_result(i, chain, pts, out, ref, per_request, per_request_mask):
    """Hold one served result to the plain path's, to per-request
    ``apply``/``project`` and to the float64 oracle; returns the points
    left out of the mask comparison."""
    if out.shape != pts.shape or not np.isfinite(out).all():
        raise SystemExit(f"request {i}: bad result shape/values")
    if not bitwise_equal(out, ref):
        raise SystemExit(f"request {i}: kernel != plain version on the card")
    if not bitwise_equal(out, per_request):
        raise SystemExit(f"request {i}: packed != per-request apply/project")
    if not chain.is_projective:
        if not fold_oracle_ok(chain, pts, out):
            raise SystemExit(f"request {i}: outside 4 eps of the float64 fold")
        return 0
    for other in (ref.mask, per_request_mask):
        if not bitwise_equal(out.mask, other):
            raise SystemExit(f"request {i}: mask != plain/per-request mask")
    ok, undecided = project_oracle_ok(chain.fold(), pts, out, out.mask)
    if not ok:
        raise SystemExit(f"request {i}: outside the float64 projective bound")
    return undecided


# -- the serving paths -------------------------------------------------------------

def serve_phase(phase: str, templates, device: str = "cuda",
                n_requests: int = 1024, min_points: int = 1024,
                max_points: int = 262144) -> tuple[dict, dict, dict, dict]:
    """Drive one serving path; returns (kernel launch counts of the run,
    the serving summary, the largest served bucket shape per plan kind,
    the median and the largest request's point count per plan kind)."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=n_requests, templates=templates,
        min_points=min_points, max_points=max_points)
    n_kind = {k: sum(c.plan_kind == k for c, _ in reqs) for k in FLAT}

    serving.reset_stats()
    _build.reset_launch_counts()
    srv = serving.GeometryServer(device=device)
    outs, submit_s, flush_s, timings, _ = timed_serve(
        srv, [(c, p, None) for c, p in reqs])
    t0 = time.perf_counter()
    singles = []
    for c, p in reqs:
        x = torch.from_numpy(p).to(device)
        if c.is_projective:
            q, m = c.project(x)
            singles.append((q.cpu().numpy(), m.cpu().numpy()))
        else:
            singles.append((c.apply(x).cpu().numpy(), None))
    apply_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = dict(serving.stats)
    flushes = 4

    buckets = len(srv.last_report)
    if stats["launches"] != stats["buckets"] or stats["buckets"] != flushes * buckets:
        raise SystemExit(f"launches {stats['launches']} != buckets "
                         f"{stats['buckets']} ({flushes} x {buckets})")
    batched = sum(counts[name] for name in BATCH.values())
    if batched != stats["launches"]:
        raise SystemExit(f"batch kernels launched {batched} times, serving "
                         f"counted {stats['launches']} launches")
    for kind, name in FLAT.items():
        if counts[name] != n_kind[kind]:
            raise SystemExit(f"per-request calls launched {name} "
                             f"{counts[name]} times for {n_kind[kind]} "
                             f"{kind} requests")
    used = [k for k in FLAT if n_kind[k]]
    require_launched(counts, [FLAT[k] for k in used]
                     + [BATCH[k] for k in used], phase)

    ref_outs = serving.GeometryServer(device=device, backend="ref").serve(reqs)
    undecided = 0
    for i, ((chain, pts), out) in enumerate(zip(reqs, outs)):
        undecided += check_result(i, chain, pts, out, ref_outs[i],
                                  *singles[i])

    summary = {
        "phase": phase, "requests": len(reqs), "requests_by_kind": n_kind,
        "buckets": buckets,
        **flush_summary(stats, flushes, submit_s, flush_s, timings),
        "payload_MB": sum(p.nbytes for _, p in reqs) / 1e6,
        "per_request_ms": apply_s * 1e3,
        "bitwise_vs_ref": True, "bitwise_vs_per_request": True,
        "fold_oracle": True, "mask_points_within_bound": undecided,
    }
    largest = largest_buckets(srv.last_report)
    sizes = {}
    for kind in used:
        n = sorted(p.shape[0] for c, p in reqs if c.plan_kind == kind)
        sizes[kind] = (n[len(n) // 2], n[-1])
    sizes["all"] = (sorted(p.shape[0] for _, p in reqs)[len(reqs) // 2],
                    max(p.shape[0] for _, p in reqs))
    return counts, summary, largest, sizes


def timed_serve(srv, subs) -> tuple:
    """One warm flush of the (chain, points, qformat) submissions, then
    three rounds of submitting them all and one flush, submit and flush
    timed apart.  Returns (the last flush's results, submit seconds,
    flush seconds, the server's phase timings, the last flush's opcount
    records)."""
    submit_s, flush_s, timings, outs, records = [], [], [], None, None
    for k in range(4):
        t0 = time.perf_counter()
        for chain, pts, q in subs:
            srv.submit(chain, pts, qformat=q)
        t1 = time.perf_counter()
        with opcount.counting() as records:
            outs = srv.flush()                       # numpy results: synced
        if k:                                        # the first one warms
            flush_s.append(time.perf_counter() - t1)
            submit_s.append(t1 - t0)
            timings.append(srv.last_timing)
    return outs, submit_s, flush_s, timings, records


def flush_summary(stats, flushes, submit_s, flush_s, timings) -> dict:
    """The per-flush counters and the host and device times of a serve."""
    med = {k: float(np.median([t[k] for t in timings])) for k in timings[0]}
    return {
        "launches_per_flush": stats["launches"] // flushes,
        "payload_points": stats["payload_points"] // flushes,
        "padded_points": stats["padded_points"] // flushes,
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
    }


def largest_buckets(reports) -> dict:
    """The (requests, lpad, d) of the largest bucket of each plan kind."""
    largest = {}
    for rep in reports:
        if rep.padded_points > largest.get(rep.kind, (0, 0, 0, 0))[3]:
            largest[rep.kind] = (rep.requests, rep.lpad,
                                 int(rep.structure[0]), rep.padded_points)
    return {k: v[:3] for k, v in largest.items()}


def q_submissions(reqs) -> list:
    """(chain, submitted points, qformat) for the q-mixed serve: affine
    request k (in submission order) goes with q8.7, as int16 words when k
    is odd and as float32 when it is even, scaled out of range when
    k = 0 mod FALLBACK_EVERY; projective requests go without a format."""
    subs, k = [], 0
    for chain, pts in reqs:
        if chain.is_projective:
            subs.append((chain, pts, None))
            continue
        if k % 2:
            pts = Q8_7.quantize(pts)
        elif k % FALLBACK_EVERY == 0:
            pts = pts * FALLBACK_SCALE
        subs.append((chain, pts, Q8_7.name))
        k += 1
    return subs


def q_oracle(chain, pts: np.ndarray) -> np.ndarray:
    """The numpy Q oracle's result for one q-lane request: the points
    quantised (int16 words pass as they are), the fold quantised by
    ``quantize_fold``, dequantised back for a float submission."""
    words = pts if pts.dtype == np.int16 else Q8_7.quantize(pts)
    folded_q = quantize.quantize_fold(chain.fold(), chain.plan_kind, Q8_7)
    oracle = q_ref.np_chain_diag_q if chain.is_diagonal \
        else q_ref.np_chain_matrix_q
    out = oracle(words.reshape(-1, chain.dim), *folded_q, Q8_7.n)
    out = out.reshape(pts.shape)
    return out if pts.dtype == np.int16 else Q8_7.dequantize(out)


def q_bound_ok(chain, pts: np.ndarray, out: np.ndarray) -> bool:
    """A float submission's q result within ``quantize.error_bound`` of
    the float64 value of the chain's float32 fold."""
    folded = chain.fold()
    p = pts.reshape(-1, chain.dim).astype(np.float64)
    f64 = [f.astype(np.float64) for f in folded]
    exact = p * f64[0] + f64[1] if chain.is_diagonal else p @ f64[0] + f64[1]
    bound = quantize.error_bound(folded, chain.plan_kind, Q8_7,
                                 float(np.abs(pts).max()))
    got = out.reshape(-1, chain.dim).astype(np.float64)
    return bool((np.abs(got - exact) <= bound).all())


def q_mixed_phase(device: str = "cuda") -> tuple[dict, dict, dict, tuple]:
    """The q-mixed serve (see the module docstring); returns (kernel launch
    counts of the run, the summary, the largest q bucket shape per plan
    kind, the median and the largest q-lane request's point count)."""
    reqs = workload.random_workload(
        seed=SEED, n_requests=1024, templates=workload.TEMPLATES,
        min_points=1024, max_points=262144)
    subs = q_submissions(reqs)
    affine = [i for i, (_, _, q) in enumerate(subs) if q]
    fallback = set(affine[::FALLBACK_EVERY])
    q_lane = [i for i in affine if i not in fallback]

    serving.reset_stats()
    _build.reset_launch_counts()
    srv = serving.GeometryServer(device=device)
    outs, submit_s, flush_s, timings, records = timed_serve(srv, subs)
    t0 = time.perf_counter()
    singles = []
    for i, (c, p, q) in enumerate(subs):
        x = torch.from_numpy(p).to(device)
        if c.is_projective:
            out, mask = c.project(x)
            singles.append((out.cpu().numpy(), mask.cpu().numpy()))
        else:
            out = c.apply(x, dtype=None if i in fallback else q)
            singles.append((out.cpu().numpy(), None))
    apply_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = dict(serving.stats)
    flushes = 4

    buckets = len(srv.last_report)
    q_reports = [rep for (op, _), rep in zip(records, srv.last_report)
                 if op.endswith("_q")]
    if len(records) != buckets or stats["launches"] != stats["buckets"] \
            or stats["buckets"] != flushes * buckets:
        raise SystemExit(f"q-mixed: launches {stats['launches']} != buckets "
                         f"{stats['buckets']} ({flushes} x {buckets})")
    batched = sum(counts[name] for name in [*BATCH.values(),
                                            *Q_BATCH.values()])
    q_batched = sum(counts[name] for name in Q_BATCH.values())
    if batched != stats["launches"] or q_batched != flushes * len(q_reports):
        raise SystemExit(f"q-mixed: batch kernels launched {batched} times "
                         f"({q_batched} q) for {stats['launches']} launches "
                         f"({flushes} x {len(q_reports)} q buckets)")
    n_fallback = sum(rep.q_fallback_requests for rep in srv.last_report)
    if stats["q_fallbacks"] != flushes * len(fallback) \
            or n_fallback != len(fallback):
        raise SystemExit(f"q-mixed: {stats['q_fallbacks']} q fallbacks over "
                         f"{flushes} flushes, {n_fallback} in the last, "
                         f"expected {len(fallback)} a flush")
    for kind in ("diag", "matrix"):
        n_q = sum(subs[i][0].plan_kind == kind for i in q_lane)
        if counts[Q_FLAT[kind]] != n_q:
            raise SystemExit(f"q-mixed: {Q_FLAT[kind]} launched "
                             f"{counts[Q_FLAT[kind]]} times for {n_q} "
                             f"per-request {kind} q calls")
    require_launched(counts, [*Q_FLAT.values(), *Q_BATCH.values()],
                     "q-mixed serve")
    for (op, nbytes), rep in zip(records, srv.last_report):
        if op.endswith("_q") and 2 * nbytes != opcount.packed_chain_bytes(
                rep.requests, rep.lpad, int(rep.structure[0]), itemsize=4,
                kind=rep.kind):
            raise SystemExit(f"q-mixed: {op} recorded {nbytes} bytes, not "
                             "half the float32 bytes of its bucket")

    ref_srv = serving.GeometryServer(device=device, backend="ref")
    for c, p, q in subs:
        ref_srv.submit(c, p, qformat=q)
    ref_outs = ref_srv.flush()
    undecided, int16_in = 0, 0
    for i, ((chain, pts, q), out) in enumerate(zip(subs, outs)):
        if i not in q_lane:          # projective, or rerouted to float32
            if i in fallback and out.dtype != np.float32:
                raise SystemExit(f"q-mixed request {i}: fallback not float32")
            undecided += check_result(i, chain, pts, out, ref_outs[i],
                                      *singles[i])
            continue
        want_dtype = np.int16 if pts.dtype == np.int16 else np.float32
        int16_in += pts.dtype == np.int16
        if out.dtype != want_dtype or out.shape != pts.shape:
            raise SystemExit(f"q-mixed request {i}: {pts.dtype} in, "
                             f"{out.dtype} {out.shape} out")
        for other, what in ((ref_outs[i], "the plain version on the card"),
                            (singles[i][0], "per-request apply(dtype=)"),
                            (q_oracle(chain, pts), "the numpy Q oracle")):
            if not bitwise_equal(out, other):
                raise SystemExit(f"q-mixed request {i}: != {what}")
        if want_dtype == np.float32 and not q_bound_ok(chain, pts, out):
            raise SystemExit(f"q-mixed request {i}: outside error_bound")

    summary = {
        "phase": "serve (q-mixed)", "requests": len(subs),
        "q_requests": len(affine), "q_lane": len(q_lane),
        "int16_submissions": int16_in,
        "float_submissions": len(q_lane) - int16_in,
        "q_fallbacks_per_flush": stats["q_fallbacks"] // flushes,
        "buckets": buckets, "q_buckets": len(q_reports),
        **flush_summary(stats, flushes, submit_s, flush_s, timings),
        "q_bucket_bytes": sum(b for op, b in records if op.endswith("_q")),
        "per_request_ms": apply_s * 1e3,
        "bitwise_vs_ref": True, "bitwise_vs_per_request": True,
        "bitwise_vs_q_oracle": True, "error_bound": True,
        "q_bytes_half_of_float32": True,
        "mask_points_within_bound": undecided,
    }
    n = sorted(subs[i][1].shape[0] for i in q_lane)
    return counts, summary, largest_buckets(q_reports), \
        (n[len(n) // 2], n[-1])


def orbit_camera(k: int) -> graphics.Camera:
    """Frame k of the orbit: the camera of (3, 2, 6) stepped 2 pi k /
    FRAMES around the y axis, looking at the origin."""
    radius, angle = math.hypot(3.0, 6.0), math.atan2(6.0, 3.0)
    a = angle + 2 * math.pi * k / FRAMES
    return graphics.Camera(eye=(radius * math.cos(a), 2.0,
                                radius * math.sin(a)),
                           target=(0.0, 0.0, 0.0), fov_y=math.pi / 3,
                           aspect=16 / 9, near=0.5, far=50.0)


def graphics_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The graphics front door: one viewing chain projects a 2**20-point
    cloud (one ``chain_project_1d`` launch), then FRAMES frames of one
    orbiting camera serve as one flush (one ``chain_project_batch_2d``
    launch).  Returns (launch counts of the run, the summary)."""
    viewport = graphics.Viewport(0, 0, 1920, 1080, (0, 1))
    chain = graphics.viewing_chain(camera=orbit_camera(0), viewport=viewport)
    rng = np.random.default_rng(SEED)
    cloud = (rng.standard_normal((CLOUD_POINTS, 3)) * 4).astype(np.float32)
    frames = [(graphics.viewing_chain(camera=orbit_camera(k),
                                      viewport=viewport),
               (rng.standard_normal((FRAME_POINTS, 3)) * 4)
               .astype(np.float32)) for k in range(FRAMES)]
    cloud_dev = torch.from_numpy(cloud).to(device)
    torch.cuda.synchronize()

    serving.reset_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out, mask = chain.project(cloud_dev)
    torch.cuda.synchronize()
    project_s = time.perf_counter() - t0
    srv = serving.GeometryServer(device=device)
    t0 = time.perf_counter()
    served = srv.serve(frames)                       # submit + one flush
    flush_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = dict(serving.stats)
    if counts["chain_project_1d"] != 1 or counts["chain_project_batch_2d"] != 1 \
            or stats["launches"] != 1 or stats["buckets"] != 1:
        raise SystemExit(f"graphics: expected one flat and one batch launch, "
                         f"got {counts}, {stats['launches']} launches in "
                         f"{stats['buckets']} buckets")

    out, mask = out.cpu().numpy(), mask.cpu().numpy()
    ref, ref_mask = (t.cpu().numpy() for t in
                     chain.project(cloud_dev, backend="ref"))
    if not (bitwise_equal(out, ref) and bitwise_equal(mask, ref_mask)):
        raise SystemExit("graphics: projected cloud != plain version")
    ok, undecided = project_oracle_ok(chain.fold(), cloud, out, mask)
    if not ok:
        raise SystemExit("graphics: cloud outside the float64 bound")
    ref_frames = serving.GeometryServer(device=device, backend="ref") \
        .serve(frames)
    for i, ((c, pts), got) in enumerate(zip(frames, served)):
        q, m = c.project(torch.from_numpy(pts).to(device))
        undecided += check_result(f"frame {i}", c, pts, got, ref_frames[i],
                                  q.cpu().numpy(), m.cpu().numpy())
    summary = {"phase": "graphics", "structure": srv.last_report[0].structure,
               "cloud_points": CLOUD_POINTS,
               "cloud_inside": int(mask.sum()),
               "project_ms": project_s * 1e3,
               "frames": FRAMES, "frame_points": FRAME_POINTS,
               "frames_inside": int(sum(int(r.mask.sum()) for r in served)),
               "serve_ms": flush_s * 1e3,
               "device_span_ms": srv.last_timing.get("device_ms"),
               "bitwise_vs_ref": True, "bitwise_vs_per_request": True,
               "fold_oracle": True, "mask_points_within_bound": undecided}
    return counts, summary


# -- the paper's primitives ------------------------------------------------------

def emulator_phase() -> dict:
    """The paper's routines on the port's M1 emulator, run as
    ``benchmarks/paper_tables.py::_emulator_cycles`` runs them (the same
    seed and draws): every value equal to its int16 oracle, every M1
    cycle count beside Table 5's, matching exactly where the paper prints
    a listing (``EMULATOR_EXACT``) and not elsewhere."""
    rng = np.random.default_rng(0)
    cycles = {}
    for n in (8, 64):
        u = rng.integers(-1000, 1000, n)
        v = rng.integers(-1000, 1000, n)
        rt = programs.run_translation(u, v)
        rs = programs.run_scaling(u, 5)
        if not (np.array_equal(rt.values, programs.oracle_translation(u, v))
                and np.array_equal(rs.values, programs.oracle_scaling(u, 5))):
            raise SystemExit(f"emulator: n={n} values != int16 oracles")
        cycles["translation", n], cycles["scaling", n] = rt.cycles, rs.cycles
    a = rng.integers(-100, 100, (8, 8))
    b = rng.integers(-1000, 1000, (8, 8))
    rm = programs.run_matmul(a, b)
    pts = rng.integers(-100, 100, (2, 8))
    rr = programs.run_rotation_points((3, 4), pts)
    if not (np.array_equal(rm.values, programs.oracle_matmul(a, b))
            and np.array_equal(rr.values, programs.oracle_matmul(
                np.array([[3, -4], [4, 3]]), pts))):
        raise SystemExit("emulator: matmul / composite II != int16 oracle")
    cycles["rotation_matmul", 64] = rm.cycles
    cycles["composite_ii", 16] = rr.cycles
    rows, perf_rows = [], []
    for row in intel.PAPER_TABLE5:
        if row.system != "m1":
            continue
        key = (row.algorithm, row.n_elements)
        match = cycles[key] == row.cycles
        if match != (key in EMULATOR_EXACT):
            raise SystemExit(f"emulator: {key} {cycles[key]} cycles against "
                             f"the paper's {row.cycles}: match={match}")
        rows.append({"algorithm": row.algorithm, "n": row.n_elements,
                     "cycles": cycles[key], "paper_cycles": row.cycles,
                     "match": match})
        perf_rows.append(analysis.derive(row.algorithm, "m1", row.n_elements,
                                         cycles[key], source="emulator"))
    print(analysis.format_table(perf_rows), flush=True)
    return {"phase": "emulator", "values_equal_oracles": True, "m1": rows}


def exact_pipeline(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the float64 value of the exact pipeline ((p + T2) * SV) @ R(THETA)
    + T1, and 4 eps32 mag_c with mag_c = sum_m (|p_m| + |T2_m|) |SV_m|
    |R_mc| + |T1_c|): each primitive's rounding, the float32 fold and the
    float32 cos/sin add at most eps32 / 2 to eps32 of mag_c each."""
    p = pts.astype(np.float64)
    t1, t2, s = (np.array(v, np.float64) for v in (T1, T2, SV))
    c, sn = math.cos(THETA), math.sin(THETA)
    r = np.array([[c, sn], [-sn, c]])
    mag = ((np.abs(p) + np.abs(t2)) * np.abs(s)) @ np.abs(r) + np.abs(t1)
    return ((p + t2) * s) @ r + t1, 4 * EPS32 * mag


def sequential(x: torch.Tensor, t2, sv, t1,
               backend: str | None = None) -> torch.Tensor:
    """kernel_bench.py's sequential pipeline: four eager primitives."""
    q = te.translate(x, t2, backend=backend)
    q = te.scale(q, sv, backend=backend)
    q = te.rotate(q, THETA, backend=backend)
    return te.translate(q, t1, backend=backend)


def primitives_phase(device: str = "cuda") -> tuple[dict, dict]:
    """The eager primitives on a CLOUD_POINTS cloud, then the sequential
    pipeline against the fused chain (see the module docstring).  Returns
    (launch counts of the two eager runs, summed, the summary)."""
    rng = np.random.default_rng(SEED)
    pts = {d: (rng.standard_normal((CLOUD_POINTS, d)) * 4).astype(np.float32)
           for d in (2, 3)}
    other = rng.standard_normal((CLOUD_POINTS, 2)).astype(np.float32)
    s = {d: rng.uniform(-2, 2, d).astype(np.float32) for d in (2, 3)}
    t = {d: rng.uniform(-3, 3, d).astype(np.float32) for d in (2, 3)}
    x = {d: torch.from_numpy(p).to(device) for d, p in pts.items()}
    z = torch.from_numpy(other).to(device)
    c, sn = math.cos(THETA), math.sin(THETA)
    rot = np.array([[c, sn], [-sn, c]])
    p64 = {d: p.astype(np.float64) for d, p in pts.items()}
    s64 = {d: v.astype(np.float64) for d, v in s.items()}
    t64 = {d: v.astype(np.float64) for d, v in t.items()}
    # name -> (call(backend), float64 value, 4 eps32 x magnitude)
    calls = {}
    for d in (2, 3):
        calls[f"translate d={d}"] = (
            lambda b, d=d: te.translate(x[d], t[d], backend=b),
            p64[d] + t64[d], np.abs(p64[d]) + np.abs(t64[d]))
        calls[f"scale d={d}"] = (
            lambda b, d=d: te.scale(x[d], s[d], backend=b),
            p64[d] * s64[d], np.abs(p64[d] * s64[d]))
    calls["affine d=2"] = (lambda b: te.affine(x[2], s[2], t[2], backend=b),
                           p64[2] * s64[2] + t64[2],
                           np.abs(p64[2] * s64[2]) + np.abs(t64[2]))
    calls["rotate d=2"] = (lambda b: te.rotate(x[2], THETA, backend=b),
                           p64[2] @ rot,
                           np.abs(p64[2]).sum(-1, keepdims=True))
    calls["vecadd d=2"] = (lambda b: te.vecadd(x[2], z, backend=b),
                           p64[2] + other, np.abs(p64[2]) + np.abs(other))
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = {name: call(None) for name, (call, _, _) in calls.items()}
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    want = {"affine_2d": 5, "matmul_2d": 1, "vecadd_2d": 1}
    if {k: v for k, v in counts.items() if v} != want:
        raise SystemExit(f"primitives: launches {counts}, expected {want}")
    for name, (call, exact, mag) in calls.items():
        out = outs[name]
        if not same_bits(out, call("ref")):
            raise SystemExit(f"primitives: {name} != plain version on the card")
        got = out.cpu().numpy().astype(np.float64)
        if not (np.isfinite(got).all()
                and (np.abs(got - exact) <= 4 * EPS32 * mag).all()):
            raise SystemExit(f"primitives: {name} outside its float64 bound")

    # the paper's comparison: four primitive passes against one fused pass
    x2 = x[2]
    # the pipeline's vectors staged on the card once, as a caller keeps
    # them: param_tensor hands a tensor on x's device to the kernel as it is
    params = [torch.tensor(v, dtype=torch.float32, device=device)
              for v in (T2, SV, T1)]
    chain = (te.Transform2D.identity(device=device).then_translate(*T2)
             .then_scale(*SV).then_rotate(THETA).then_translate(*T1))
    _build.reset_launch_counts()
    with opcount.counting() as rec_seq:
        seq = sequential(x2, *params)
    torch.cuda.synchronize()
    seq_counts = _build.launch_counts()
    _build.reset_launch_counts()
    with opcount.counting() as rec_fused:
        fused = chain.apply(x2)
    torch.cuda.synchronize()
    fused_counts = _build.launch_counts()
    if {k: v for k, v in seq_counts.items() if v} != {"affine_2d": 3,
                                                      "matmul_2d": 1}:
        raise SystemExit(f"sequential: launches {seq_counts}")
    if {k: v for k, v in fused_counts.items() if v} != {"chain_matrix_1d": 1}:
        raise SystemExit(f"fused: launches {fused_counts}")
    if not (same_bits(seq, sequential(x2, *params, backend="ref"))
            and same_bits(fused, chain.apply(x2, backend="ref"))):
        raise SystemExit("sequential / fused != plain version on the card")
    exact, bound = exact_pipeline(pts[2])
    got_seq = seq.cpu().numpy().astype(np.float64)
    got_fused = fused.cpu().numpy().astype(np.float64)
    for what, got in (("sequential", got_seq), ("fused", got_fused)):
        if not (np.isfinite(got).all() and (np.abs(got - exact) <= bound).all()):
            raise SystemExit(f"{what}: outside 4 eps32 mag of the exact value")
    if not (np.abs(got_seq - got_fused) <= 2 * bound).all():
        raise SystemExit("sequential and fused differ by more than 8 eps32 mag")
    # the calls as a user makes them: each call stages its remaining
    # parameters (translate's 1, scale's 0, the rotation matrix; the
    # chain's folded A and t) with synchronous host-to-device copies, so
    # the event window holds host time too; main() adds the kernels alone
    # from the kernel rows at this shape
    (seq_ms, seq_us), (fused_ms, fused_us) = \
        time_ms(lambda: sequential(x2, *params)), \
        time_ms(lambda: chain.apply(x2))
    for k, v in seq_counts.items():
        counts[k] += v
    seq_bytes, fused_bytes = (opcount.total_bytes(r)
                              for r in (rec_seq, rec_fused))
    summary = {
        "phase": "primitives", "cloud_points": CLOUD_POINTS,
        "eager_calls": list(calls), "eager_first_calls_ms": eager_s * 1e3,
        "bitwise_vs_ref": True, "float64_bound": True,
        "sequential_launches": {k: v for k, v in seq_counts.items() if v},
        "fused_launches": {k: v for k, v in fused_counts.items() if v},
        "sequential_opcount": [op for op, _ in rec_seq],
        "sequential_bytes": seq_bytes, "fused_bytes": fused_bytes,
        "bytes_ratio": seq_bytes / fused_bytes,
        "sequential_call_ms": seq_ms, "fused_call_ms": fused_ms,
        "call_time_ratio": seq_ms / fused_ms,
        "sequential_host_us": seq_us, "fused_host_us": fused_us,
        "max_abs_diff_seq_fused": float(np.abs(got_seq - got_fused).max()),
        "within_8eps_mag": True,
    }
    return counts, summary


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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality of two tensors on the card (-0.0 != 0.0)."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def projective_case(shape: tuple, rng: np.random.Generator, dev):
    """(run, plain, library, bytes, ops) for a projective kernel at
    ``shape``: a workload-style homography and cull bounds per chain."""
    d = shape[-1]
    batched = len(shape) == 3
    lead = shape[:1] if batched else ()
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    hs = [workload.random_projective(rng, d) for _ in range(lead[0] if lead else 1)]
    h = torch.from_numpy(np.stack(hs) if batched else hs[0]).to(dev)
    lo = torch.from_numpy(rng.uniform(-6, -3, lead + (d,)).astype(np.float32)).to(dev)
    hi = torch.from_numpy(rng.uniform(3, 6, lead + (d,)).astype(np.float32)).to(dev)
    if batched:
        def run():
            return proj_k.chain_project_batch_2d(x, h, lo, hi)

        def plain():
            return proj_ref.chain_project_batch(x, h, lo, hi)

        def lib():
            qh = torch.baddbmm(h[:, d:d + 1], x, h[:, :d])
            w = qh[..., d]
            ok = w > 0
            v = qh[..., :d] / torch.where(ok, w, 1.0)[..., None]
            return v, ok & ((v >= lo[:, None]) & (v <= hi[:, None])).all(-1)
    else:
        def run():
            out, mask = proj_k.chain_project_1d(x.reshape(-1), h, lo, hi, d=d)
            return out.reshape(shape), mask

        def plain():
            return proj_ref.chain_project(x, h, lo, hi)

        def lib():
            qh = torch.addmm(h[d], x, h[:d])
            w = qh[:, d]
            ok = w > 0
            v = qh[:, :d] / torch.where(ok, w, 1.0)[:, None]
            return v, ok & ((v >= lo) & (v <= hi)).all(-1)
    n_points = x.numel() // d
    n_chains = lead[0] if lead else 1
    # the bytes the kernel really moves: points in and out, one mask byte
    # per point, the parameters once
    nbytes = 8 * x.numel() + n_points \
        + 4 * n_chains * opcount.chain_param_words(d, "projective")
    ops = (2 * d * (d + 1) + 3 * d) * n_points
    return run, plain, lib, nbytes, ops


def kernel_case(name: str, shape: tuple, rng: np.random.Generator,
                size: str) -> dict:
    """Check and time one kernel at one shape: (N, d) flat or (B, L, d);
    ``size`` says which of the path's sizes the shape is."""
    d = shape[-1]
    kind = KERNELS[name][2]
    batched = len(shape) == 3
    lead = shape[:1] if batched else ()
    dev = torch.device("cuda")
    library = "composite" if kind == "projective" \
        else "addcmul" if kind == "diag" else "baddbmm"
    if kind == "projective":
        run, plain, lib, nbytes, ops = projective_case(shape, rng, dev)
    else:
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
        n_points = x.numel() // d
        nbytes = opcount.packed_chain_bytes(shape[0], shape[1], d, kind=kind) \
            if batched else opcount.fused_chain_bytes(n_points, d, kind=kind)
    got, want = run(), plain()
    torch.cuda.synchronize()
    if kind == "projective":
        (got, got_mask), (want, want_mask) = got, want
        if not same_bits(got_mask, want_mask):
            raise SystemExit(f"{name} {shape}: kernel mask != plain version")
    if not same_bits(got, want):
        raise SystemExit(f"{name} {shape}: kernel != plain version")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(run), time_ms(plain), time_ms(lib)
    row = {"kernel": name, "size": size, "shape": list(shape), "equal": True,
           "max_abs_err": err, "ms": ms, "bytes": nbytes,
           "GB/s": nbytes / ms / 1e6, "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "plain_ms": plain_ms,
           # no single PyTorch call computes project + divide + cull: the
           # composite's time is kept apart from library_ms
           "library_ms": None if library == "composite" else lib_ms,
           "composite_ms": lib_ms if library == "composite" else None,
           "library": library,
           "host_us": host_us, "plain_host_us": plain_us,
           "library_host_us": lib_us}
    if kind == "projective":
        n_points = math.prod(shape[:-1])
        row["opcount_bytes"] = opcount.packed_chain_bytes(
            shape[0], shape[1], d, kind=kind) if batched \
            else opcount.fused_chain_bytes(n_points, d, kind=kind)
    emit(row)
    return row


def q_case(shape: tuple, kind: str, rng: np.random.Generator, dev):
    """(run, plain, composite, bytes, ops) of an int16 kernel at ``shape``
    on full-range words, each a function of n_frac.  The composite (no
    single PyTorch call requantises a Qm.n chain, and ``torch.matmul`` has
    no integer path on CUDA) is a float64 ``addcmul``/``addmm``/
    ``baddbmm`` -- exact: |acc| < 2**32 -- then an int64 rounding shift
    and the narrowing to int16."""
    d = shape[-1]
    batched = len(shape) == 3
    lead = shape[:1] if batched else ()

    def words(s):
        return torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, s)
                                .astype(np.int16)).to(dev)

    x = words(shape)
    p = words(lead + ((d,) if kind == "diag" else (d, d)))
    t = words(lead + (d,))
    n_points = x.numel() // d

    def requant(acc, n):
        acc = acc.to(torch.int64)
        return ((acc + (1 << (n - 1))) >> n if n else acc).to(torch.int16)

    if kind == "diag":
        wrap = q_k.chain_diag_batch_2d_q if batched else q_k.chain_diag_1d_q
        plain_fn = q_ref.chain_diag_batch_q if batched else q_ref.chain_diag_q
        tb, pb = (t[:, None], p[:, None]) if batched else (t, p)

        def lib(n):
            return requant(torch.addcmul(tb.double() * (1 << n), x.double(),
                                         pb.double()), n)
        ops = 5 * x.numel()           # multiply, shift t, two adds, shift
    else:
        wrap = q_k.chain_matrix_batch_2d_q if batched else q_k.chain_matrix_1d_q
        plain_fn = q_ref.chain_matrix_batch_q if batched \
            else q_ref.chain_matrix_q

        def lib(n):
            if batched:
                acc = torch.baddbmm(t.double()[:, None] * (1 << n), x.double(),
                                    p.double())
            else:
                acc = torch.addmm(t.double() * (1 << n), x.double(), p.double())
            return requant(acc, n)
        ops = (2 * d + 3) * x.numel()  # d multiply-adds, shift t, round, shift

    def run(n):
        if batched:
            return wrap(x, p, t, n_frac=n)
        return wrap(x.reshape(-1), p, t, d=d, n_frac=n).reshape(shape)

    def plain(n):
        return plain_fn(x, p, t, n)

    nbytes = opcount.packed_chain_bytes(shape[0], shape[1], d, itemsize=2,
                                        kind=kind) if batched \
        else opcount.fused_chain_bytes(n_points, d, itemsize=2, kind=kind)
    return run, plain, lib, nbytes, ops


def kernel_case_q(name: str, shape: tuple, rng: np.random.Generator,
                  size: str) -> dict:
    """Check one int16 kernel at one shape against its plain version at
    every n_frac of Q_FRACS, on full-range words; time it at q8.7's."""
    d = shape[-1]
    run, plain, lib, nbytes, ops = q_case(shape, KERNELS[name][2], rng,
                                          torch.device("cuda"))
    composite_equal = True
    for n in Q_FRACS:
        got, want, comp = run(n), plain(n), lib(n)
        torch.cuda.synchronize()
        if got.dtype != torch.int16 or not same_bits(got, want):
            raise SystemExit(f"{name} {shape} n_frac={n}: kernel != plain "
                             "version")
        composite_equal &= same_bits(got, comp)
    err = float((got.int() - want.int()).abs().max()) if got.numel() else 0.0
    n = Q8_7.n
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(lambda: run(n)), time_ms(lambda: plain(n)), \
        time_ms(lambda: lib(n))
    row = {"kernel": name, "size": size, "shape": list(shape), "d": d,
           "n_frac_checked": list(Q_FRACS), "timed_n_frac": n, "equal": True,
           "max_abs_err": err, "ms": ms, "bytes": nbytes,
           "GB/s": nbytes / ms / 1e6, "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "plain_ms": plain_ms, "library_ms": None, "composite_ms": lib_ms,
           "library": "composite", "composite_equal": composite_equal,
           "host_us": host_us, "plain_host_us": plain_us,
           "library_host_us": lib_us}
    emit(row)
    return row


def eager_case(name: str, shape: tuple, dtype: torch.dtype,
               rng: np.random.Generator, size: str) -> dict:
    """Check and time one eager kernel: ``affine_2d``/``vecadd_2d`` at
    (M, N), ``matmul_2d`` at (M, K, N), inputs and output of ``dtype``;
    the yardstick is one PyTorch call (``addcmul`` / ``add`` /
    ``matmul``, TF32 off)."""
    dev = torch.device("cuda")

    def randn(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) \
            .to(dev).to(dtype)

    item = torch.empty((), dtype=dtype).element_size()
    peak = BF16_OPS_PER_S if (dtype == torch.bfloat16
                              and name == "matmul_2d") else FP32_OPS_PER_S
    if name == "affine_2d":
        m, n = shape
        x, s, t = randn(m, n), randn(n), randn(n)
        run = lambda: diag_k.affine_2d(x, s, t)   # noqa: E731
        plain = lambda: diag_ref.affine(x, s, t)  # noqa: E731
        lib, library = (lambda: torch.addcmul(t, x, s)), "addcmul"
        nbytes, ops = (2 * m * n + 2 * n) * item, 2 * m * n
    elif name == "vecadd_2d":
        m, n = shape
        x, z = randn(m, n), randn(m, n)
        run = lambda: diag_k.vecadd_2d(x, z)   # noqa: E731
        plain = lambda: diag_ref.vecadd(x, z)  # noqa: E731
        lib, library = (lambda: torch.add(x, z)), "add"
        nbytes, ops = 3 * m * n * item, m * n
    else:
        m, k, n = shape
        x, y = randn(m, k), randn(k, n)
        run = lambda: matrix_k.matmul_2d(x, y)   # noqa: E731
        plain = lambda: matrix_ref.matmul(x, y)  # noqa: E731
        lib, library = (lambda: torch.matmul(x, y)), "matmul"
        nbytes, ops = (m * k + k * n + m * n) * item, 2 * m * k * n
    got, want = run(), plain()
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise SystemExit(f"{name} {shape} {dtype}: kernel != plain version")
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    lib_err = float((got.float() - lib().float()).abs().max())
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    (ms, host_us), (plain_ms, plain_us), (lib_ms, lib_us) = \
        time_ms(run), time_ms(plain), time_ms(lib)
    row = {"kernel": name, "size": size, "shape": list(shape),
           "dtype": str(dtype).removeprefix("torch."), "equal": True,
           "max_abs_err": err, "ms": ms, "bytes": nbytes, "ops": ops,
           "GB/s": nbytes / ms / 1e6, "TFLOP/s": ops / ms / 1e9,
           "bound_ms": max(byte_ms, op_ms),
           "bound_by": "bytes" if byte_ms >= op_ms else "operations",
           "plain_ms": plain_ms, "library_ms": lib_ms, "composite_ms": None,
           "library": library, "library_max_abs_diff": lib_err,
           "host_us": host_us, "plain_host_us": plain_us,
           "library_host_us": lib_us}
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

    _, summary, largest_affine, sizes_affine = serve_phase(
        "serve", workload.AFFINE_TEMPLATES)
    emit(summary)
    counts, summary, largest, sizes = serve_phase(
        "serve (mixed)", workload.TEMPLATES)
    emit(summary)
    require_launched(counts, FLOAT_KERNELS, "mixed serve")
    graphics_counts, summary = graphics_phase()
    emit(summary)
    q_counts, summary, largest_q, sizes_q = q_mixed_phase()
    emit(summary)
    emit(emulator_phase())
    eager_counts, summary = primitives_phase()
    emit(summary)
    require_launched(eager_counts, EAGER_KERNELS, "primitives")

    rng = np.random.default_rng(SEED)
    rows = {}
    for d in (2, 3):
        for name in ("chain_diag_1d", "chain_matrix_1d", "chain_project_1d"):
            rows[name] = kernel_case(name, (N_FLAT, d), rng, "flat 2**24")
    for i, size in enumerate(("median request", "largest request")):
        for d in (2, 3):
            for name in ("chain_diag_1d", "chain_matrix_1d"):
                kernel_case(name, (sizes_affine["all"][i], d), rng, size)
            kernel_case("chain_project_1d", (sizes["projective"][i], d), rng,
                        f"{size} (projective, mixed serve)")
    for name, kind in (("chain_diag_batch_2d", "diag"),
                       ("chain_matrix_batch_2d", "matrix")):
        rows[name] = kernel_case(name, largest_affine[kind], rng,
                                 "largest bucket")
    rows["chain_project_batch_2d"] = kernel_case(
        "chain_project_batch_2d", largest["projective"], rng,
        "largest bucket (mixed serve)")
    for d in (2, 3):
        for name in Q_FLAT.values():
            rows[name] = kernel_case_q(name, (N_FLAT, d), rng, "flat 2**24")
    for i, size in enumerate(("median q request", "largest q request")):
        for d in (2, 3):
            for name in Q_FLAT.values():
                kernel_case_q(name, (sizes_q[i], d), rng, size)
    for kind, name in Q_BATCH.items():
        rows[name] = kernel_case_q(name, largest_q[kind], rng,
                                   "largest q bucket")

    bf16, f32 = torch.bfloat16, torch.float32
    bench, cloud = "kernel_bench", "cloud"
    # the last row of each kernel is the kernels line's
    for name, shape, dtype, size in (
            ("affine_2d", (1024, 1024), bf16, bench),
            ("affine_2d", (CLOUD_POINTS, 2), f32, cloud),
            ("affine_2d", (1024, 1024), f32, bench),
            ("vecadd_2d", (1024, 1024), bf16, bench),
            ("vecadd_2d", (CLOUD_POINTS, 2), f32, cloud),
            ("vecadd_2d", (1024, 1024), f32, bench),
            ("matmul_2d", (1024, 1024, 1024), f32, bench),
            ("matmul_2d", (CLOUD_POINTS, 2, 2), f32, "rotate"),
            ("matmul_2d", (1024, 1024, 1024), bf16, bench)):
        rows[name] = eager_case(name, shape, dtype, rng, size)
        rows[name, size] = rows[name]
    # the primitives phase's comparison with the kernels alone: the
    # sequential pipeline's four launches against the fused chain's one
    fused = kernel_case("chain_matrix_1d", (CLOUD_POINTS, 2), rng, cloud)
    seq_ms = (3 * rows["affine_2d", cloud]["ms"]
              + rows["matmul_2d", "rotate"]["ms"])
    emit({"phase": "primitives (kernels alone)", "points": CLOUD_POINTS,
          "sequential_kernels_ms": seq_ms, "fused_kernel_ms": fused["ms"],
          "kernel_time_ratio": seq_ms / fused["ms"]})

    kernels = []
    for name, (source, replaces, kind) in KERNELS.items():
        r = rows[name]
        # each kernel's launches come from the path that runs it: the
        # mixed serve for the float chain kernels, the q-mixed serve for
        # the int16 ones, the primitives phase for the eager ones
        launches = eager_counts[name] if kind == "eager" \
            else q_counts[name] if name.endswith("_q") else counts[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "launches_mixed": counts[name],
                        "launches_q_mixed": q_counts[name],
                        "launches_graphics": graphics_counts[name],
                        "launches_primitives": eager_counts[name],
                        "shape": r["shape"], "dtype": r.get("dtype", "float32"),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "composite_ms": r["composite_ms"],
                        "library": r["library"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

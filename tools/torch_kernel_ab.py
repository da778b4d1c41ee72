#!/usr/bin/env python3
"""Time ``ssd_intra``, ``chain_project_1d``, ``rope_3d``,
``chain_matrix_batch_2d_q``, ``chain_matrix_batch_2d``,
``chain_diag_batch_2d_q`` and ``chain_project_batch_2d`` in two
checkouts of the PyTorch port on one GPU, in turns (A, B, B, A), so that
the card and its host are the same for both.

    python3 tools/torch_kernel_ab.py PATH_A PATH_B

Each turn is a process of its own that imports ``repro_torch`` from that
checkout's ``src`` (building its kernels there on first use) and times,
on inputs made from seed 0: ``ssd_intra`` in bfloat16 at hymba-1.5b's
prefill shape (32 chunks of 256, 50 heads of 64, state 16) and at
mamba2-130m's (24 heads of 64, state 128), ``chain_project_1d`` at
2**24 points for d = 2 and 3, ``rope_3d`` in bfloat16 at hymba-1.5b's
prefill q and k shapes ((100 | 20, 2048, 64), tables from position 0)
and its decode q shape ((100, 1, 64) at position 2063),
``chain_matrix_batch_2d_q`` and ``chain_diag_batch_2d_q`` at the
largest q buckets of ``chip_smoke.py``'s q-mixed serve, (15, 65536, 2)
and (36, 32768, 2), on full-range int16 words at n_frac 7 (q8.7), and
``chain_matrix_batch_2d`` at the largest d = 2 and d = 3 matrix buckets
of its affine serve, (47, 32768, 2) and (20, 32768, 3), and
``chain_project_batch_2d`` at the smallest, median and largest
projective buckets of its mixed serve, (1, 4096, 3), (8, 32768, 3) and
(20, 65536, 2), and at its graphics bucket, (64, 65536, 3), each beside
a device copy of as many bytes as the call moves (``copy_ms``).  Times
are ``chip_smoke.py``'s: the median of 25 CUDA-event runs after one warm
run, the L2 flushed before each run and the device kept busy while the
host enqueues.  Each turn also reports the registers and spills
``ptxas`` gave the batch kernels of ``chain_matrix.cu``,
``chain_fixedpoint.cu`` and ``chain_project.cu`` in that checkout.  Each
turn prints one JSON line; the last line holds each row's four times in
turn order, the mean of each checkout's two turns, and the card's name
and power limit from ``nvidia-smi``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPS = 25
SPIN_CYCLES = 2_000_000
SSD_SHAPES = {"ssd_intra hymba-1.5b": (32, 256, 50, 64, 16),
              "ssd_intra mamba2-130m": (32, 256, 24, 64, 128)}
N_FLAT = 1 << 24
#: (BH, S, D) and the first position: prefill q and k, the last decode step
ROPE_SHAPES = {"rope_3d q": ((100, 2048, 64), 0),
               "rope_3d k": ((20, 2048, 64), 0),
               "rope_3d decode q": ((100, 1, 64), 2063)}
#: chip_smoke.py's largest q buckets (seed 0), by plan kind
Q_BUCKETS = {"chain_matrix_batch_2d_q": (15, 65536, 2),
             "chain_diag_batch_2d_q": (36, 32768, 2)}
#: chip_smoke.py's largest matrix buckets of the affine serve (seed 0)
MATRIX_BUCKETS = {"chain_matrix_batch_2d": (47, 32768, 2),
                  "chain_matrix_batch_2d d=3": (20, 32768, 3)}
#: chip_smoke.py's projective buckets (seed 0): the mixed serve's
#: smallest, median and largest, and the graphics phase's 64 frames
PROJECT_BUCKETS = {"chain_project_batch_2d smallest": (1, 4096, 3),
                   "chain_project_batch_2d median": (8, 32768, 3),
                   "chain_project_batch_2d": (20, 65536, 2),
                   "chain_project_batch_2d graphics": (64, 65536, 3)}


def one(tree: str) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.fixedpoint import fixedpoint as q_k
    from repro_torch.kernels.matmul import matmul as matrix_k
    from repro_torch.kernels.projective import projective as proj_k
    from repro_torch.kernels.rope import ref as rope_ref
    from repro_torch.kernels.rope import rope as rope_k
    from repro_torch.kernels.ssd import ssd as ssd_k

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA device")
    _build.build_all()
    dev = torch.device("cuda")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def time_ms(fn) -> float:
        fn()
        times = []
        for _ in range(REPS):
            flush.zero_()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def copy_ms(nbytes: int) -> float:
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        return time_ms(lambda: dst.copy_(src))

    rng = np.random.default_rng(0)
    rows = {}
    for name, (bc, lc, h, p, n) in SSD_SHAPES.items():
        def randn(*s):
            return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                    ).to(dev).bfloat16()
        xdt, bb, cc = randn(bc, lc, h, p), randn(bc, lc, n), randn(bc, lc, n)
        a = rng.uniform(0.001, 0.1, (bc, lc, h)).astype(np.float32)
        cum = torch.cumsum(-torch.from_numpy(a).to(dev), dim=1)
        nbytes = 2 * (bc * lc * h * p + 2 * bc * lc * n) + 4 * bc * lc * h \
            + 4 * bc * lc * h * p + 4 * bc * h * p * n
        rows[name] = {
            "ms": time_ms(lambda: ssd_k.ssd_intra(xdt, bb, cc, cum)),
            "copy_ms": copy_ms(nbytes)}
    for d in (2, 3):
        x = torch.from_numpy(rng.standard_normal(N_FLAT * d, dtype=np.float32)
                             ).to(dev)
        hm = torch.eye(d + 1, device=dev)
        hm[d, :d] = 0.5
        hm[:d, d] = 0.1
        lo = torch.full((d,), -3.0, device=dev)
        hi = torch.full((d,), 3.0, device=dev)
        nbytes = 8 * N_FLAT * d + N_FLAT + 4 * ((d + 1) ** 2 + 2 * d)
        rows[f"chain_project_1d d={d}"] = {
            "ms": time_ms(lambda: proj_k.chain_project_1d(x, hm, lo, hi, d=d)),
            "copy_ms": copy_ms(nbytes)}
    for name, ((bh, s, d), pos0) in ROPE_SHAPES.items():
        x = torch.from_numpy(rng.standard_normal((bh, s, d), dtype=np.float32)
                             ).to(dev).bfloat16()
        pos = torch.arange(pos0, pos0 + s, device=dev)
        cos, sin = (t.bfloat16().contiguous() for t in
                    rope_ref.rope_tables(pos, d))
        nbytes = 2 * (2 * bh * s * d + s * d)
        rows[name] = {"ms": time_ms(lambda: rope_k.rope_3d(x, cos, sin)),
                      "copy_ms": copy_ms(nbytes)}

    def words(*s):
        return torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, s)
                                .astype(np.int16)).to(dev)
    for name, (bsz, length, d) in Q_BUCKETS.items():
        diag = name == "chain_diag_batch_2d_q"
        x, t = words(bsz, length, d), words(bsz, d)
        p = words(bsz, d) if diag else words(bsz, d, d)
        op = q_k.chain_diag_batch_2d_q if diag else q_k.chain_matrix_batch_2d_q
        nbytes = 2 * (2 * bsz * length * d + bsz * (p[0].numel() + d))
        rows[name] = {"ms": time_ms(lambda: op(x, p, t, n_frac=7)),
                      "copy_ms": copy_ms(nbytes)}
    for name, (bsz, length, d) in MATRIX_BUCKETS.items():
        x = torch.from_numpy(rng.standard_normal((bsz, length, d),
                                                 dtype=np.float32)).to(dev)
        a = torch.from_numpy(rng.uniform(-1, 1, (bsz, d, d)).astype(
            np.float32)).to(dev)
        t = torch.from_numpy(rng.uniform(-3, 3, (bsz, d)).astype(
            np.float32)).to(dev)
        nbytes = 4 * (2 * bsz * length * d + bsz * (d * d + d))
        rows[name] = {
            "ms": time_ms(lambda: matrix_k.chain_matrix_batch_2d(x, a, t)),
            "copy_ms": copy_ms(nbytes)}
    for name, (bsz, length, d) in PROJECT_BUCKETS.items():
        x = torch.from_numpy(3 * rng.standard_normal((bsz, length, d),
                                                     dtype=np.float32)).to(dev)
        hm = torch.eye(d + 1, device=dev).repeat(bsz, 1, 1)
        hm[:, :d, :d] += torch.from_numpy(rng.uniform(
            -0.4, 0.4, (bsz, d, d)).astype(np.float32)).to(dev)
        hm[:, :d, d] = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (bsz, d)).astype(np.float32)).to(dev)
        lo = torch.full((bsz, d), -2.5, device=dev)
        hi = torch.full((bsz, d), 2.5, device=dev)
        nbytes = 8 * bsz * length * d + bsz * length \
            + 4 * bsz * ((d + 1) ** 2 + 2 * d)
        rows[name] = {
            "ms": time_ms(lambda: proj_k.chain_project_batch_2d(x, hm, lo,
                                                                hi)),
            "copy_ms": copy_ms(nbytes)}
    ptxas = {src: [u for u in _build.resource_usage(src)
                   if "batch" in u["function"]]
             for src in ("chain_matrix", "chain_fixedpoint", "chain_project")}
    return {"tree": tree, "rows": rows, "ptxas": ptxas,
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", help="run one turn in this checkout")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(os.path.abspath(args.one))), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts, A and B")
    a, b = (os.path.abspath(t) for t in args.trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    turns = []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree],
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line)["rows"])
    summary = {}
    for name in turns[0]:
        ms = [t[name]["ms"] for t in turns]
        summary[name] = {"order": ["A", "B", "B", "A"], "ms": ms,
                         "copy_ms": [t[name]["copy_ms"] for t in turns],
                         "A_ms": (ms[0] + ms[3]) / 2,
                         "B_ms": (ms[1] + ms[2]) / 2}
    print(json.dumps({"card": card, "rows": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare hymba-1.5b's prefill between two checkouts of the PyTorch port
on one GPU, in turns (A, B, B, A), so that the card and its host are the
same for both.

    python3 tools/torch_prefill_ab.py PATH_A PATH_B [--reps 5]

Each turn is a process of its own that imports ``repro_torch`` from that
checkout's ``src`` (building its kernels there on first use), serves
hymba-1.5b at full width from random weights (seed 0) -- batch 4,
2048-token prompts, 16 generated tokens, as ``chip_smoke.py`` does --
once to warm up, then ``--reps`` times, and prints one JSON line: the
checkout, each serve's prefill ms (CUDA events, ``serve_batch``'s
trace) and their median, the median decode step's ms over the 16 steps
of every serve, and the flash kernel's launches in the last prefill.
The last line is the four prefill medians in turn order and the mean of
each checkout's two turns, and the same of the decode medians.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BATCH, PROMPT, GEN = 4, 2048, 16


def one(tree: str, reps: int) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_prefill_ab: needs a CUDA device")
    _build.build_all()
    cfg = configs.get("hymba-1.5b")
    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    serve_batch(cfg, params, prompts, gen_tokens=GEN, model=model)
    times, steps = [], []
    for _ in range(reps):
        _build.reset_launch_counts()
        trace = {}
        serve_batch(cfg, params, prompts, gen_tokens=GEN, model=model,
                    trace=trace)
        times.append(trace["prefill_ms"])
        steps.extend(trace["decode_ms"])
    return {"tree": tree, "prefill_ms": times,
            "median_ms": float(np.median(times)),
            "decode_ms_per_token": float(np.median(steps)),
            "flash_launches": trace["launches_prefill"]["flash_attention_3d"],
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", help="run one turn in this checkout")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(os.path.abspath(args.one), args.reps)),
              flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts, A and B")
    a, b = (os.path.abspath(t) for t in args.trees)
    medians, decode = [], []
    for tree in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree, "--reps", str(args.reps)],
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        medians.append(json.loads(line)["median_ms"])
        decode.append(json.loads(line)["decode_ms_per_token"])
    print(json.dumps({"order": ["A", "B", "B", "A"], "medians_ms": medians,
                      "A_ms": (medians[0] + medians[3]) / 2,
                      "B_ms": (medians[1] + medians[2]) / 2,
                      "decode_medians_ms": decode,
                      "A_decode_ms": (decode[0] + decode[3]) / 2,
                      "B_decode_ms": (decode[1] + decode[2]) / 2}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

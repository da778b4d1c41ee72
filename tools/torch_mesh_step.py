#!/usr/bin/env python3
"""The compiled mesh step across ranks, against the eager mesh step: run
under ``torchrun``, one process a card (``nccl``; ``--device cpu`` gives
a gloo world, whose route is eager on both sides).

    python -m torch.distributed.run --nproc-per-node 2 \\
        tools/torch_mesh_step.py --out mesh_step.jsonl

Two parts, each on a ("data", "model") mesh of the whole world:

  * train: ``train_loop`` of ``--train-arch`` (hymba-1.5b, bf16, remat
    "dots", 4 x 2048 tokens) for ``--steps`` steps on ``--train-mesh``
    (by default every rank on "data": ZeRO-3), once with ``eager=True``
    and once on the default route (``launch.mesh.compiled_route``: on
    NCCL step 1 eager, one CUDA graph captured, the rest replays, no
    synchronising call in a replay's enqueue): every step's loss,
    gradient norm and the digests of this rank's shards of every
    parameter and optimizer leaf, bit for bit on every rank, and every
    loss finite;
  * serve: ``serve_batch`` of ``--serve-arch`` (granite-moe-3b-a800m,
    its parameters placed by ``params_specs`` on ``--serve-mesh``, by
    default every rank on "model": the heads, the hidden dim and the
    vocabulary split) under ``mesh_context``, 4 prompts of 2048 tokens
    and 16 tokens, ``eager=True`` and then twice on the default route
    (a capturing serve, a replayed one): tokens and every step's logits
    (this rank's shards) bit for bit.

Rank 0 prints one JSON line a part (the route taken, ms a step or
token, capture ms, host µs a replay, peak memory, the card's name and
power limit) and appends them to ``--out``; every rank exits non-zero
if any comparison fails on it.  Weights are random, from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.serve import release_graphs, serve_batch  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()


def local(t) -> torch.Tensor:
    return (t.to_local() if sharding.is_dtensor(t) else t).detach().clone()


def shape_of(text: str) -> tuple:
    return tuple(int(n) for n in text.split("x"))


def train_part(args, dev: str) -> tuple[dict, list]:
    cfg = configs.get(args.train_arch)
    cfg = cfg.reduced() if args.reduced else cfg
    cfg = dataclasses.replace(cfg, remat="dots")
    mesh = mesh_mod.make_mesh(shape_of(args.train_mesh), ("data", "model"))
    runs = {}
    for eager in (True, False):
        rows, trace = [], {}

        def on_step(i, m):
            if dev == "cuda":
                torch.cuda.synchronize()
            rows.append({"ms": m["ms"], "loss": m["loss"],
                         "grad_norm": float(local(m["grad_norm"])),
                         "params": cs.leaf_digests(m["params"]),
                         "opt_state": cs.leaf_digests(
                             m["opt_state"])})
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
                   seq_len=args.seq_len,
                   micro_per_shard=args.micro_per_shard,
                   opt_cfg=AdamWConfig(total_steps=args.steps,
                                       warmup_steps=1),
                   seed=0, device=dev, on_step=on_step, mesh=mesh,
                   log_every=1, eager=eager, trace=trace,
                   sync_debug=None if eager or dev != "cuda" else "error")
        peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" \
            else None
        runs[eager] = {"rows": rows, "trace": trace, "peak": peak}
    eager, compiled = runs[True], runs[False]
    failures = [f"train step {i + 1}: compiled differs from eager"
                for i, (a, b) in enumerate(zip(eager["rows"],
                                               compiled["rows"]))
                if {k: v for k, v in a.items() if k != "ms"}
                != {k: v for k, v in b.items() if k != "ms"}]
    failures += [f"train step {i + 1}: loss {r['loss']}"
                 for i, r in enumerate(compiled["rows"])
                 if not np.isfinite(r["loss"])]
    ms_c = [r["ms"] for r in compiled["rows"]]
    ms_e = [r["ms"] for r in eager["rows"]]
    return {"part": "train", "arch": cfg.name, "mesh": args.train_mesh,
            "ranks": dist.get_world_size(),
            "backend": dist.get_backend(), "step": compiled["trace"]["step"],
            "eager_step": eager["trace"]["step"],
            "bitwise_vs_eager": not failures,
            "losses": [r["loss"] for r in compiled["rows"]],
            "steps_ms": ms_c, "steps_ms_eager": ms_e,
            "step_ms": float(np.median(ms_c[1:])),
            "step_ms_eager": float(np.median(ms_e[1:])),
            "capture_ms": compiled["trace"]["capture_ms"],
            "replay_host_us": compiled["trace"]["replay_us"],
            "peak_memory_GB": compiled["peak"],
            "peak_memory_GB_eager": eager["peak"]}, failures


def serve_part(args, dev: str) -> tuple[dict, list]:
    cfg = configs.get(args.serve_arch)
    cfg = cfg.reduced() if args.reduced else cfg
    mesh = mesh_mod.make_mesh(shape_of(args.serve_mesh), ("data", "model"))
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    params = elastic.place(params, mesh, sharding.params_specs(params, mesh))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt)).astype(np.int32)
    runs = []
    with mesh_mod.mesh_context(mesh):
        for eager in (True, False, False):
            trace = {}
            tokens = serve_batch(cfg, params, prompts, gen_tokens=args.gen,
                                 model=model, trace=trace, eager=eager,
                                 sync_debug=None if eager or dev != "cuda"
                                 else "error")
            trace["logits"] = [local(x) for x in trace["logits"]]
            runs.append((tokens, trace))
    release_graphs(model)
    (te, eager), (t1, first), (t2, second) = runs
    failures = [f"serve {what}: tokens or logits differ from eager"
                for what, toks, tr in (("capturing", t1, first),
                                       ("replayed", t2, second))
                if not np.array_equal(toks, te) or not all(
                    torch.equal(a, b)
                    for a, b in zip(tr["logits"], eager["logits"]))]
    return {"part": "serve", "arch": cfg.name, "mesh": args.serve_mesh,
            "ranks": dist.get_world_size(), "backend": dist.get_backend(),
            "attention_layout": sharding.attn_layout(
                cfg, sharding.model_width(mesh)),
            "step": second["step"], "eager_step": eager["step"],
            "bitwise_vs_eager": not failures,
            "prefill_ms": second["prefill_ms"],
            "prefill_ms_eager": eager["prefill_ms"],
            "decode_ms_per_token": float(np.median(second["decode_ms"])),
            "decode_ms_per_token_eager": float(np.median(eager["decode_ms"])),
            "capture_ms": first.get("capture_ms"),
            "replay_host_us": float(np.median(second["replay_us"]))
            if second.get("replay_us") else None}, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--train-arch", default="hymba-1.5b")
    ap.add_argument("--train-mesh", default=None,
                    help="DxM, by default the world on data")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--micro-per-shard", type=int, default=1)
    ap.add_argument("--serve-arch", default="granite-moe-3b-a800m")
    ap.add_argument("--serve-mesh", default=None,
                    help="DxM, by default the world on model")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mesh_mod.ensure_process_group("nccl" if args.device == "cuda"
                                  else "gloo")
    world = dist.get_world_size()
    args.train_mesh = args.train_mesh or f"{world}x1"
    args.serve_mesh = args.serve_mesh or f"1x{world}"
    failures = []
    lines = []
    try:
        for part in (train_part, serve_part):
            t0 = time.perf_counter()
            line, bad = part(args, args.device)
            line.update(wall_s=time.perf_counter() - t0, card=card())
            failures += bad
            lines.append(line)
            if dist.get_rank() == 0:
                print(json.dumps(line), flush=True)
        if args.out and dist.get_rank() == 0:
            with open(args.out, "a") as f:
                for line in lines:
                    f.write(json.dumps(line) + "\n")
    finally:
        dist.destroy_process_group()
    for f in failures:
        print(f"rank {dist.get_rank() if dist.is_initialized() else '?'}: "
              f"{f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The serve step split by its layer spans, for the benchmark's cells, on
one GPU:

    python3 tools/torch_serve_spans.py --seed 2147483711 \\
        hymba-1.5b.decode-b32 granite-moe-3b-a800m.short-b8 [--rounds 2]

Each cell's configuration, traffic and weights come from ``bench/`` as
a run of ``bench/run.py`` makes them.  For each length bucket: one call
without a tracer and one with an ``obs.Tracer`` installed (the first
serve of each captures its graphs: plain ones, and ones whose
event-record nodes time the layer spans), then ``--rounds`` pairs of
calls, plain and spanned in turn, each with a ``trace`` dict.  One JSON
line a bucket gives the seconds of both first calls and of each timed
call, the mean CUDA-event ms of a decode step and the prefill ms of both
kinds of graph, and ``obs.steps.summary`` of the last spanned call: by
track, each span's ms a step, the mean ms from a replay's first event to
its last and the least share of that under the top-level spans; and the
MoE layers' routed and dropped entries by phase.  The card's name and
power limit open the output; the lines also go to
``chiprun_out/torch_serve_spans.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench import harness, traffic, weights  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.launch.serve import release_graphs, serve_batch  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.obs import steps  # noqa: E402


def bucket(cfg, params, model, gen, k: int, rounds: int) -> dict:
    """One length bucket's plain and spanned calls (see the module)."""
    s, g = gen.buckets[k]
    out = {"prompt": s, "out": g}
    for side, trc in (("plain", None), ("spans", obs.Tracer())):
        t = time.perf_counter()
        with obs.installed(trc):
            serve_batch(cfg, params, gen.extra(k, 0, stream=1),
                        gen_tokens=g, model=model)
        torch.cuda.synchronize()
        out[side + "_first_s"] = time.perf_counter() - t
    for r in range(rounds):
        for side in ("plain", "spans")[::1 if r % 2 == 0 else -1]:
            trc, tr = obs.Tracer() if side == "spans" else None, {}
            t = time.perf_counter()
            with obs.installed(trc):
                serve_batch(cfg, params, gen.extra(k, r + 1, stream=6),
                            gen_tokens=g, model=model, trace=tr)
            torch.cuda.synchronize()
            out.setdefault(side + "_s", []).append(time.perf_counter() - t)
            out.setdefault(side + "_decode_ms", []).append(
                statistics.fmean(tr["decode_ms"]))
            out.setdefault(side + "_prefill_ms", []).append(tr["prefill_ms"])
            if trc is not None:
                summ = steps.summary(trc)
                out["counts"] = summ.pop("counts")
                out["spans"] = {f"{t}.{'replay' if graph else 'eager'}": v
                                for (t, _, graph), v in summ.items()}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 63)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_spans: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "chiprun_out", "torch_serve_spans.jsonl"),
              "a") as f:
        for name in args.cells:
            c = harness.cell(harness.spec(), name)
            m = c["config"]["model"]
            cfg = ModelConfig(**m)
            params = weights.make(m, args.seed, dev)
            model = build(cfg)
            gen = traffic.ServeTraffic(c["traffic"], args.seed,
                                       m["vocab_size"])
            for k in range(len(gen.buckets)):
                line = json.dumps({"cell": name, "seed": args.seed,
                                   "card": card, **bucket(
                                       cfg, params, model, gen, k,
                                       args.rounds)})
                print(line, flush=True)
                f.write(line + "\n")
            release_graphs(model)
            del model, params
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

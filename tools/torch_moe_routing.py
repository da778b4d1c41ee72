#!/usr/bin/env python3
"""Where an MoE serve's kernel path and plain path part: the routing of
granite-moe-3b-a800m's prefill on the card, through the kernels and
through their plain versions (``dispatch.use_backend("ref")``), from the
same random weights (seed 0) and prompts (batch 4 x 2048 tokens, as
``chip_smoke.py`` serves them).

    python3 tools/torch_moe_routing.py

Prints one JSON line: by layer, the tokens whose top-k expert set
differs between the two paths; the share of layer 0's tokens whose
k-th and (k+1)-th router probabilities lie within 1e-3 and 1e-4 on the
plain path; the last position's logits on both paths (relative RMS,
greedy tokens, the plain path's top-two margins); the transient device
memory of one ``moe_ffn`` call at the prefill shape; and the card's name
and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402

ARCH, BATCH, PROMPT, SEED = "granite-moe-3b-a800m", 4, 2048, 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_moe_routing: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = configs.get(ARCH)
    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT))
    batch = {"tokens": torch.from_numpy(prompts).long().cuda()}
    routed = []
    route = moe.route

    def capture(router, x, c):
        r = route(router, x, c)
        routed.append((r.expert_ids.sort(-1).values, r.probs))
        return r
    moe.route = capture
    paths = {}
    try:
        for name, backend in (("kernel", "cuda"), ("plain", "ref")):
            routed.clear()
            cache = model.init_cache(BATCH, PROMPT, device="cuda")
            with dispatch.use_backend(backend):
                logits, _ = model.prefill(params, batch, cache)
            paths[name] = (logits, list(routed))
            del cache
    finally:
        moe.route = route
    (lk, rk), (lp, rp) = paths["kernel"], paths["plain"]
    flips = [int((a[0] != b[0]).any(-1).sum()) for a, b in zip(rk, rp)]
    k = cfg.experts_per_token
    top = rp[0][1].sort(-1, descending=True).values
    margin = top[..., k - 1] - top[..., k]
    d = (lk - lp).double()
    top2 = lp.double().topk(2, -1).values
    del paths, rk, rp, routed

    x = torch.randn(BATCH, PROMPT, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda")
                    .manual_seed(SEED)).to(cfg.activation_dtype)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    moe.moe_ffn(params["layers"][0]["moe"], x, cfg)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({
        "arch": ARCH, "batch": BATCH, "prompt": PROMPT,
        "tokens_rerouted_by_layer": flips, "tokens": BATCH * PROMPT,
        "layer0_margin_below_1e-3": float((margin < 1e-3).float().mean()),
        "layer0_margin_below_1e-4": float((margin < 1e-4).float().mean()),
        "logits_rel_rms": float(d.pow(2).mean().sqrt()
                                / lp.double().pow(2).mean().sqrt()),
        "logits_rms_diff": float(d.pow(2).mean().sqrt()),
        "greedy_kernel": lk.argmax(-1).tolist(),
        "greedy_plain": lp.argmax(-1).tolist(),
        "plain_top2_margin": (top2[:, 0] - top2[:, 1]).tolist(),
        "moe_ffn_transient_GB": transient / 1e9, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

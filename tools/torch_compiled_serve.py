#!/usr/bin/env python3
"""The compiled serve step (CUDA graphs of ``Model.prefill`` and
``Model.decode``) against the eager one, on one GPU, for the five model
phases of ``chip_smoke.py``:

    python3 tools/torch_compiled_serve.py [--arch hymba-1.5b ...]
        [--no-profile]

Each phase is ``chip_smoke.model_phase`` (its gates included: the
compiled serve bit for bit the ``eager=True`` one, launches as derived,
no synchronising call in the replayed loop, the plain path's envelope):
hymba-1.5b, granite-moe-3b-a800m, granite with an int8 KV cache,
whisper-medium and internvl2-76b at 4 layers, at chip_smoke's sizes
(batch 4, 2048-token prompts or 1500 frames, 16 tokens).  One JSON line
a phase gives the eager, first compiled (prefill and decode step 0
eager, then replays) and second compiled (replays only) serves' prefill
ms and decode ms a token (CUDA events), the capture ms, host µs a replay
and peak memory of each.  Unless ``--no-profile``, the same weights
then serve twice more through the compiled step, the second under
``torch.profiler``: the kernels' device ms in that serve (CUPTI) beside
the serve's CUDA-event span, and the kernels a decode step runs.  The
card's name and power limit open and close the output; the summaries
also go to ``chiprun_out/torch_compiled_serve.jsonl``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import build  # noqa: E402

KEYS = ("eager_prefill_ms", "prefill_ms", "repeat_prefill_ms",
        "eager_decode_ms_per_token", "decode_ms_per_token",
        "repeat_decode_ms_per_token", "capture_ms", "replay_host_us",
        "eager_peak_memory_GB", "peak_memory_GB", "repeat_peak_memory_GB",
        "eager_wall_s", "wall_s", "repeat_wall_s", "logits_rel_rms_max",
        "logits_rtol", "step", "compiled_bitwise_vs_eager", "repeat_bitwise")


def phases() -> dict:
    """The five phases' configs and prompt lengths, by name."""
    granite = configs.get(cs.GRANITE_ARCH)
    return {
        "hymba-1.5b": (configs.get(cs.HYMBA_ARCH), cs.MODEL_PROMPT),
        "granite-moe-3b-a800m": (granite, cs.MODEL_PROMPT),
        "granite-moe-3b-a800m-int8": (dataclasses.replace(
            granite, kv_cache_dtype="int8"), cs.MODEL_PROMPT),
        "whisper-medium": (configs.get(cs.WHISPER_ARCH), cs.WHISPER_FRAMES),
        "internvl2-76b": (dataclasses.replace(
            configs.get(cs.VLM_ARCH), n_layers=cs.VLM_LAYERS),
                          cs.MODEL_PROMPT)}


def profiled(cfg, params: dict, prompt: int) -> dict:
    """A compiled serve of a captured key under ``torch.profiler``: the
    kernels' device ms (self CUDA time of every event) beside the serve's
    prefill and decode CUDA-event ms."""
    model = build(cfg)
    prompts = np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (cs.MODEL_BATCH, prompt)).astype(np.int32)
    serve_batch(cfg, params, prompts, gen_tokens=cs.MODEL_GEN, model=model)
    torch.cuda.synchronize()
    trace = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        serve_batch(cfg, params, prompts, gen_tokens=cs.MODEL_GEN,
                    model=model, trace=trace)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span_ms = trace["prefill_ms"] + sum(trace["decode_ms"])
    return {"step": trace["step"], "kernels": len(kernels),
            "kernels_device_ms": device_ms, "events_span_ms": span_ms,
            "busy_share": device_ms / span_ms if span_ms else None,
            "prefill_ms": trace["prefill_ms"],
            "decode_ms_per_token": float(np.median(trace["decode_ms"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(phases()))
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args(argv)
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = open(os.path.join(ROOT, "chiprun_out",
                            "torch_compiled_serve.jsonl"), "w")
    for name in args.arch:
        cfg, prompt = phases()[name]
        weights = cs.init_params(cfg)
        t0 = time.perf_counter()
        _, _, summary = cs.model_phase(cfg, prompt=prompt, weights=weights)
        line = {"phase": summary["phase"],
                "phase_s": time.perf_counter() - t0,
                **{k: summary[k] for k in KEYS}, "card": card}
        if not args.no_profile:
            line["profiled"] = profiled(cfg, weights[0], prompt)
        del weights
        torch.cuda.empty_cache()
        out.write(json.dumps(dict(summary, **line)) + "\n")
        out.flush()
        print(json.dumps(line), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a training step's time goes: hymba-1.5b at full width and depth
(bfloat16, random weights from seed 0) on one micro-batch of
``chip_smoke.py``'s train phase (2 rows of 2048 tokens of
``SyntheticLMData(seed 0)``'s step 0), on the card.

    python3 tools/torch_train_profile.py

Prints JSON lines, each beside the card's name and power limit:

  * ``passes``: the forward alone in four modes -- no grad (the serving
    forward), then with grad under remat "dots", "full" and "none" (the
    last may not fit: it keeps every activation) -- and the backward of
    each recorded one: device ms (CUDA events) and host ms (the host
    clock around the call, before the closing sync), so a host-bound
    pass shows host ms near its device ms; the second of two runs;
  * ``profile``: one forward and backward under remat "dots" through
    ``torch.profiler``: the device's busy ms (the union of its kernels'
    intervals) against the span's ms (the idle share), the launches, and
    the device ms by kind -- the hand-written kernels by name, cuBLAS
    products, and the rest (the plain vjps' and the recomputation's
    elementwise and reduction kernels) -- with the top 15 device ops and
    the top 15 host ops by self time; then the same split of one
    replayed train step (``launch.train.CompiledTrain``: the train
    phase's 4 x 2048 tokens in 2 micro-batches, forward, backward and
    the in-place AdamW as one CUDA graph, after its eager first step,
    its capture and one replay), with the capture's host ms and the host
    µs of the replay call.

Needs one CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch.train import CompiledTrain  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import leaves, tree_map  # noqa: E402

ARCH, SEQ, MICRO, SEED = "hymba-1.5b", 2048, 2, 0
#: the hand-written kernels' device functions, by the prefix of their
#: names (``csrc/*.cu``), and the kernel each belongs to
KERNELS = (("flash_kernel", "flash_attention_3d"),
           ("ssd", "ssd_intra"), ("rmsnorm", "rmsnorm_2d"),
           ("rope", "rope_3d"), ("vecadd", "vecadd_2d"))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def timed(fn) -> tuple[float, float, object]:
    """(device ms, host ms, result) of ``fn()``."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    torch.cuda.synchronize()
    a.record()
    t0 = time.perf_counter()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    return a.elapsed_time(b), host, out


def kind(name: str) -> str:
    """The hand-written kernel a device function belongs to, else
    ``cuBLAS products`` for a GEMM, else ``other``."""
    for prefix, kernel in KERNELS:
        if name.startswith(prefix) or f" {prefix}" in name \
                or f"::{prefix}" in name:
            return kernel
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
        return "cuBLAS products"
    return "other"


def busy_ms(intervals: list) -> float:
    """The union of [start, end) intervals, in ms (us in)."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def split(prof, span_ms: float, line: str, what: str) -> dict:
    """The profile line of a traced span: busy against span ms, launches,
    device ms by kind, the top device and host ops."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind, intervals = {}, []
    for e in events:
        dur = e.time_range.end - e.time_range.start
        intervals.append((e.time_range.start, e.time_range.end))
        k = kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + dur / 1e3
    ka = prof.key_averages()
    top_dev = sorted(ka, key=lambda e: e.self_device_time_total,
                     reverse=True)[:15]
    top_host = sorted(ka, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:15]
    busy = busy_ms(intervals)
    return {
        "profile": what, "span_ms": span_ms, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / span_ms,
        "device_launches": len(events),
        "device_ms_by_kind": by_kind,
        "top_device_ops": [{"name": e.key[:90], "calls": e.count,
                            "self_device_ms": e.self_device_time_total / 1e3}
                           for e in top_dev],
        "top_host_ops": [{"name": e.key[:90], "calls": e.count,
                          "self_host_ms": e.self_cpu_time_total / 1e3}
                         for e in top_host],
        "card": line}


def replayed_step(base, params, line: str) -> dict:
    """``split`` of one replayed train step, the capture's host ms and the
    replay call's host µs beside it (updates ``params`` in place)."""
    raw = SyntheticLMData(DataConfig(vocab_size=base.vocab_size,
                                     seq_len=SEQ, global_batch=2 * MICRO,
                                     seed=SEED)).global_batch(0)
    batch = {k: torch.from_numpy(v.reshape((2, MICRO) + v.shape[1:]))
             for k, v in raw.items()}
    ct = CompiledTrain(build(dataclasses.replace(base, remat="dots")),
                       AdamWConfig(total_steps=4, warmup_steps=1), 2,
                       params, adamw_init(params))
    ct.load(batch)
    ct.run()
    capture_ms = ct.capture()
    host_us = []
    ct.load(batch)
    ct.replay(host_us)   # the first replay uploads the graph
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ct.load(batch)
        ct.replay(host_us)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    return {**split(prof, span_ms, line, "replayed train step, remat dots, "
                    "2 micro-batches, AdamW in place"),
            "capture_ms": capture_ms, "replay_host_us": host_us[-1],
            "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA device", file=sys.stderr)
        return 2
    line = card()
    base = configs.get(ARCH)
    raw = SyntheticLMData(DataConfig(vocab_size=base.vocab_size,
                                     seq_len=SEQ, global_batch=MICRO,
                                     seed=SEED)).global_batch(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    params = build(base).init(torch.Generator("cuda").manual_seed(SEED))
    passes = {}
    for mode in ("no grad", "dots", "full", "none"):
        cfg = base if mode == "no grad" else dataclasses.replace(
            base, remat=mode)
        model = build(cfg)
        ps = tree_map(lambda p: p.detach().requires_grad_(mode != "no grad"),
                      params)
        try:
            for rep in range(2):   # the first warms cuBLAS, the allocator
                with torch.set_grad_enabled(mode != "no grad"):
                    fwd_ms, fwd_host, (loss, _) = timed(
                        lambda: model.loss(ps, batch))
                row = {"forward_ms": fwd_ms, "forward_host_ms": fwd_host}
                if mode != "no grad":
                    bwd_ms, bwd_host, _ = timed(
                        lambda: torch.autograd.grad(loss, leaves(ps)))
                    row.update(backward_ms=bwd_ms, backward_host_ms=bwd_host)
                del loss
        except torch.cuda.OutOfMemoryError:
            row, loss = {"out_of_memory": True}, None
        passes[mode] = row
        torch.cuda.empty_cache()
    print(json.dumps({"passes": passes, "tokens": MICRO * SEQ,
                      "card": line}), flush=True)

    model = build(dataclasses.replace(base, remat="dots"))
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss, _ = model.loss(ps, batch)
        torch.autograd.grad(loss, leaves(ps))
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps(split(prof, span_ms, line, "forward + backward, "
                           "remat dots, one micro-batch")), flush=True)
    del ps, model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(json.dumps(replayed_step(base, params, line)), flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A serving cell: one closed-loop client drives the port's compiled serve
step (``repro_torch.launch.serve.serve_batch``) for the window, and the
plain reference judges a sample of what it served.

Set-up makes the weights from the seed and serves each length bucket of
the mix once (its first serve runs eagerly and captures the CUDA graphs
of its shape), so the window only replays; a traffic file's
``warm_seconds`` keeps serving rounds of warm-up calls until that long
has passed, for calls whose first seconds on the card run slower
(PERF.md).  The window begins at its first call and ends with the first
whole pass of the mix's deck (``traffic.ServeTraffic``) that ends after
``seconds``.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np

#: warm-up calls of every bucket, at the least
WARM_ROUNDS = 1
#: traced stretch after the window: whole rounds of one call a bucket,
#: at least this long
TRACE_SECONDS = 2.0


class Served:
    """What the window's calls left: prompts are regenerated from the
    traffic, outputs and host seconds kept, and with ``trace`` each
    call's prefill and decode CUDA-event ms."""

    def __init__(self):
        self.outputs: list = []
        self.seconds: list = []
        self.prefill_ms: list = []
        self.decode_ms: list = []


def timed_path(cfg, params, model, gen, i: int, keep: Served, trace: bool):
    """Call ``i`` of the window through ``serve_batch``."""
    from repro_torch.launch.serve import serve_batch
    tr = {} if trace else None
    prompts = gen.prompts(i)
    c0 = time.perf_counter()
    out = serve_batch(cfg, params, prompts, gen_tokens=gen.shape(i)[1],
                      model=model, trace=tr)
    keep.seconds.append(time.perf_counter() - c0)
    keep.outputs.append(out)
    if trace:
        keep.prefill_ms.append(tr["prefill_ms"])
        keep.decode_ms.extend(tr["decode_ms"])


def token_gaps(ref, served):
    """Each served token's gap below the reference's best logit, (B, G);
    None for a token outside the vocabulary or a missing one."""
    import torch
    if not isinstance(served, torch.Tensor):
        served = torch.as_tensor(np.asarray(served))
    served = served.to(device=ref.device, dtype=torch.int64)
    if served.shape != ref.shape[:2] or served.min() < 0 \
            or served.max() >= ref.shape[-1]:
        return None
    best = ref.max(dim=-1).values
    return best - ref.gather(-1, served[..., None])[..., 0]


def widest_gap(ref, served) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best (inf where ``token_gaps`` finds no token)."""
    gap = token_gaps(ref, served)
    return math.inf if gap is None else float(gap.max())


def judge(m: dict, params: dict, gen, keep: Served, sample: list,
          control: bool = False) -> dict:
    """The reference over every sampled call's prompts and served tokens:
    the widest and the mean gap of the served tokens below the
    reference's best, and with ``control`` the same of the tokens the
    float8 reference puts first."""
    import torch
    from bench import reference
    reference.strict()
    dev = params["embed"].device
    out = {"served_logit_gap": 0.0, "tokens": 0}
    if control:
        out["control_logit_gap"] = 0.0
    for i in sample:
        prompts = torch.as_tensor(gen.prompts(i), device=dev)
        served = keep.outputs[i]
        try:
            served_t = torch.as_tensor(np.asarray(served), dtype=torch.int64,
                                       device=dev)
            ref = reference.served_logits(m, params, prompts, served_t)
        except (RuntimeError, IndexError, ValueError):
            out["served_logit_gap"] = math.inf
            continue
        out["served_logit_gap"] = max(out["served_logit_gap"],
                                      widest_gap(ref, served))
        out["tokens"] += int(np.asarray(served).size)
        _tally(out, "served", token_gaps(ref, served))
        if control:
            low = reference.served_logits(m, params, prompts, served_t,
                                          reference.FP8)
            pick = low.argmax(dim=-1)
            out["control_logit_gap"] = max(out["control_logit_gap"],
                                           widest_gap(ref, pick))
            _tally(out, "control", token_gaps(ref, pick))
            del low
        del ref
    for side in ("served", "control"):
        if side + "_gap_sum" in out:
            out[side + "_mean_gap"] = out[side + "_gap_sum"] / max(
                out["tokens"], 1)
    if not math.isfinite(out["served_logit_gap"]):
        out["served_mean_gap"] = math.inf
    return out


def _tally(out: dict, side: str, gap) -> None:
    """Running sum of the gaps and count of tokens off the reference's
    best (readings beside the widest gap, for the calibration)."""
    if gap is None:
        return
    out[side + "_gap_sum"] = out.get(side + "_gap_sum", 0.0) \
        + float(gap.sum())
    out[side + "_off_best"] = out.get(side + "_off_best", 0) \
        + int((gap > 0).sum())


def run(c: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    """One run of serving cell ``c`` (``harness.cell``); returns the
    result without ``correct``'s verdict on the forbidden modules.  With
    ``control`` the float8 reference's readings also go through the
    cell's limits in the program's place (``control_checks``,
    ``control_correct``)."""
    import torch
    from repro_torch.launch.serve import release_graphs, serve_batch
    from repro_torch.models import build
    from repro_torch.models.config import ModelConfig

    from bench import counts, harness, traffic, weights
    from bench import trace as tracing
    m, tr = c["config"]["model"], c["traffic"]
    cfg = ModelConfig(**m)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    params = weights.make(m, seed, dev)
    model = build(cfg)
    gen = traffic.ServeTraffic(tr, seed, m["vocab_size"])
    t_warm, j = time.perf_counter(), 0
    while j < WARM_ROUNDS or time.perf_counter() - t_warm < tr.get(
            "warm_seconds", 0):
        for k, (_, g) in enumerate(gen.buckets):
            serve_batch(cfg, params, gen.extra(k, j), gen_tokens=g,
                        model=model)
        j += 1
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    keep = Served()
    t0 = time.perf_counter()
    i = 0
    while True:
        timed_path(cfg, params, model, gen, i, keep, trace)
        i += 1
        if time.perf_counter() - t0 >= seconds and gen.ends_pass(i - 1):
            break
    window_s = time.perf_counter() - t0
    phases = {"setup_s": setup_s, "window_s": window_s}

    ctx = {"kind": "serve", "model": m, "traffic": tr,
           "device": harness.card(c["chips"]) if cuda else
           {"platform": "cpu", "kind": "cpu", "count": 0},
           "prefill_ms": keep.prefill_ms, "decode_ms": keep.decode_ms,
           "profile": None}
    t1 = time.perf_counter()
    if trace and cuda:
        per_round = window_s / i * len(gen.buckets)
        rounds = max(1, min(20, math.ceil(TRACE_SECONDS / per_round)))

        def traced():
            for r in range(rounds):
                for k, (_, g) in enumerate(gen.buckets):
                    serve_batch(cfg, params, gen.extra(k, r, stream=4),
                                gen_tokens=g, model=model)
        ctx["profile"] = tracing.profiled(traced)
        ctx["launch_shapes"] = [(gen.batch, s) for s, _ in gen.buckets]
        ctx["profiled_flops"] = rounds * math.fsum(
            counts.serve_flops(m, gen.batch, s, g) for s, g in gen.buckets)
    phases["trace_s"] = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    release_graphs(model)
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    verdict = judge(m, params, gen, keep,
                    gen.sample(len(keep.outputs), tr["check_per_bucket"]),
                    control)
    phases["reference_s"] = time.perf_counter() - t1
    checks, correct = harness.judged(c["limits"], verdict)
    lat = sorted(s * 1e3 for s in keep.seconds)
    tokens = gen.batch * sum(gen.shape(k)[1] for k in range(len(keep.outputs)))
    e2e = {"output_tokens_per_s": tokens / window_s,
           "request_p95_ms": _p95(lat) if len(lat) >= 20 else None,
           "setup_s": setup_s}
    device_info = dict(ctx["device"], memory_peak_bytes=int(peak))
    result = {"correct": correct,
              "attempted": len(keep.outputs), "failed": 0,
              "e2e": e2e, "ctx": ctx, "device": device_info,
              "checks": checks, "verdict": verdict, "phases": phases}
    if control:
        result["control_checks"], result["control_correct"] = \
            harness.judged(c["limits"], {
                k.replace("control_", "served_"): v
                for k, v in verdict.items() if k.startswith("control_")})
    return result


def _p95(sorted_ms: list) -> float:
    return statistics.quantiles(sorted_ms, n=20, method="inclusive")[-1]

"""A training cell: the port's ``train_loop`` on its compiled route (step 1
eager on the graph's stream, then one CUDA graph replayed a step) from the
seed, for the window, and the plain reference following its first steps.

Set-up is the loop's first ``warm_steps`` steps: the eager step, the
capture, and replays until the window begins.  Those steps are the ones
the reference follows: each one's loss, the first gradient as the
optimizer takes it (``m / (1 - b1)`` after step 1) and each leaf's change
of its float32 master over them, read before the next step overwrites
the state.  The window ends with the first step that ends ``seconds``
after it began; ``on_step`` stops the loop there.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

#: steps traced after the window begins, with ``--trace 1``
TRACE_STEPS = 2
#: AdamW's first-moment decay (the port's ``AdamWConfig`` default)
B1 = 0.9


class _WindowClosed(Exception):
    """Raised from ``on_step`` to end the loop when the window closes."""


def _named(tree, path=()):
    """(path, tensor) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, path + (i,))
    else:
        yield path, tree


class Watch:
    """``train_loop``'s ``on_step``: reads the warm steps, opens and
    closes the window, and starts and stops the profiler."""

    def __init__(self, m: dict, tr: dict, seed: int, seconds: float,
                 recorder=None, cuda: bool = True):
        self.m, self.seed, self.seconds = m, seed, seconds
        self.cuda = cuda
        self.warm = tr["warm_steps"]
        self.recorder = recorder
        self.losses: list = []
        self.grad: dict = {}
        self.change: dict = {}
        self.t_open = self.t_close = None
        self.window_steps = 0

    def __call__(self, step: int, metrics: dict) -> None:
        import torch
        now = time.perf_counter()
        if step < self.warm:
            self.losses.append(metrics["loss"])
        if step == 0:   # m after step 1 is (1 - b1) times the clipped grad
            self.grad = {p: torch.linalg.vector_norm(t.float()) / (1 - B1)
                         for p, t in _named(metrics["opt_state"]["m"])}
        if step == self.warm - 1:
            self._change(metrics["opt_state"]["master"])
            if self.cuda:
                torch.cuda.synchronize()
            self.t_open = time.perf_counter()
            if self.recorder is not None:
                self.recorder.start()
            return
        if step < self.warm:
            return
        self.window_steps += 1
        if self.recorder is not None and self.window_steps == TRACE_STEPS:
            self.recorder.stop()
        if now - self.t_open >= self.seconds and (
                self.recorder is None or self.window_steps >= TRACE_STEPS):
            self.t_close = now
            raise _WindowClosed

    def _change(self, master) -> None:
        """Each leaf's distance from the seed's parameters, the initial
        values drawn again one leaf at a time."""
        import torch
        from bench import train_inputs
        live = dict(_named(master))
        for path, t0 in train_inputs.init_params(
                self.m, self.seed, next(iter(live.values())).device):
            self.change[path] = torch.linalg.vector_norm(
                live[path].float() - t0)


def run(c: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    """One run of training cell ``c`` (``harness.cell``).  With
    ``control`` the float8 reference's readings also go through the
    cell's limits in the program's place (``control_checks``,
    ``control_correct``)."""
    import torch
    from repro_torch.launch.train import train_loop
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig

    from bench import counts, harness
    from bench import trace as tracing
    m, tr = c["config"]["model"], c["traffic"]
    cfg = ModelConfig(**m)
    cuda = torch.device(device).type == "cuda"
    recorder = tracing.Recorder() if trace and cuda else None
    watch = Watch(m, tr, seed, seconds, recorder, cuda)
    opt = AdamWConfig(peak_lr=tr["peak_lr"], warmup_steps=tr["warmup_steps"],
                      total_steps=tr["total_steps"])
    try:
        train_loop(cfg, steps=tr["total_steps"],
                   global_batch=tr["global_batch"], seq_len=tr["seq_len"],
                   micro_per_shard=tr["micro_per_shard"], seed=seed,
                   device=device, on_step=watch, opt_cfg=opt,
                   log_every=tr["total_steps"] + 1)
    except _WindowClosed:
        pass
    if watch.t_close is None:
        raise RuntimeError("the loop ended before the window closed")
    setup_s = watch.t_open - t_start
    window_s = watch.t_close - watch.t_open
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    got = {"loss": watch.losses,
           "grad": {p: float(v) for p, v in watch.grad.items()},
           "change": {p: float(v) for p, v in watch.change.items()}}
    del watch.grad, watch.change
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ctx = {"kind": "train", "model": m, "traffic": tr,
           "device": harness.card(c["chips"]) if cuda else
           {"platform": "cpu", "kind": "cpu", "count": 0}, "profile": None}
    if recorder is not None:
        ctx["profile"] = recorder.profile
        ctx["launch_shapes"] = [(tr["micro_per_shard"], tr["seq_len"])]
        ctx["profiled_flops"] = TRACE_STEPS * counts.train_flops(
            m, tr["global_batch"], tr["seq_len"])
    t1 = time.perf_counter()
    readings = judge(m, tr, seed, device, got, control)
    phases = {"setup_s": setup_s, "window_s": window_s,
              "reference_s": time.perf_counter() - t1}
    checks, correct = harness.judged(c["limits"], readings)
    tokens = watch.window_steps * tr["global_batch"] * tr["seq_len"]
    result = {"correct": correct, "attempted": watch.window_steps,
              "failed": 0,
              "e2e": {"train_tokens_per_s": tokens / window_s,
                      "setup_s": setup_s},
              "ctx": ctx, "device": dict(ctx["device"],
                                         memory_peak_bytes=int(peak)),
              "checks": checks, "verdict": readings, "phases": phases}
    if control:
        result["control_checks"], result["control_correct"] = \
            harness.judged(c["limits"], readings["control"])
    return result


def gaps(got: dict, ref: dict) -> dict:
    """The compared numbers: the widest relative gap of the warm steps'
    losses; by the worst leaf, the gap between the program's and the
    reference's first-gradient norms, and between their changes over the
    warm steps, each against the larger of the reference leaf's norm and
    the median leaf's.  Leaves whose reference gradient is under a
    thousandth of the median leaf's (moved by round-off alone) are left
    out of the change."""
    out = {"loss_gap": max(abs(a - b) / abs(b) if math.isfinite(a)
                           else math.inf
                           for a, b in zip(got["loss"], ref["loss"]))}
    if len(got["loss"]) != len(ref["loss"]):
        out["loss_gap"] = math.inf
    gmed = statistics.median(ref["grad"].values())
    out["grad_norm_gap"] = _worst(got["grad"], ref["grad"], gmed, None)
    live = {p for p, v in ref["grad"].items() if v >= 1e-3 * gmed}
    cmed = statistics.median(ref["change"][p] for p in live)
    out["change_norm_gap"] = _worst(got["change"], ref["change"], cmed, live)
    return out


def _worst(got: dict, ref: dict, med: float, keep) -> float:
    worst = 0.0
    for p, r in ref.items():
        if keep is not None and p not in keep:
            continue
        g = got.get(p, math.nan)
        gap = abs(g - r) / max(r, med) if math.isfinite(g) else math.inf
        worst = max(worst, gap)
    return worst


def judge(m: dict, tr: dict, seed: int, device: str, got: dict,
          control: bool) -> dict:
    """The reference's readings against the program's; with ``control``
    also the float8 reference's and a half-batch fault's readings
    against the float32 reference's."""
    from bench import reference
    reference.strict()
    warm = tr["warm_steps"]
    ref = reference.train_steps(m, tr, seed, device, steps=warm)
    out = gaps(got, ref)
    out["losses"] = {"program": got["loss"], "reference": ref["loss"]}
    if control:
        low = reference.train_steps(m, tr, seed, device, reference.FP8,
                                    steps=warm)
        out["control"] = gaps(low, ref)
        half = reference.train_steps(m, tr, seed, device, steps=warm,
                                     rows=list(range(tr["global_batch"] // 2)))
        out["half_batch"] = gaps(half, ref)
    return out

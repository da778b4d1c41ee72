"""Serving launcher: batched prefill and greedy decode against a KV/state
cache, the port of the JAX package's ``launch/serve.py``.

Prompts are padded into one prefill batch, then the batch decodes in
lock-step, one ``Model.decode`` per token, with greedy sampling:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --device cpu

Every model family serves: dense, MoE (the MoE FFN of ``models/moe.py``
on granite-moe-3b-a800m and dbrx-132b), SSM, hybrid, VLM (internvl2-76b,
zero patch embeddings in place of the vision frontend) and enc-dec
(whisper-medium, zero frame embeddings in place of the audio frontend;
``serve_inputs`` builds both stubs).  dbrx-132b's 264 GB and
internvl2-76b's 141 GB of bfloat16 weights need more than one card, so
this one-card launcher serves them only ``--reduced``; on a mesh their
parameters and cache are placed by ``distributed.sharding``'s rules
(``launch.dryrun`` records what one card of the 16x16 mesh holds).
``serve_batch`` given parameters placed on a mesh (DTensors, under
``mesh_context``) places the prompts and the cache by the same rules
and decodes greedily over the vocabulary split over ``model``
(``layers.greedy``); its tokens come back whole on every rank.  The default
``--arch`` is mamba2-130m, as in the JAX launcher.  Without
``--device cpu`` it runs on the GPU and raises when there is none.
Weights are random, drawn from a ``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.distributed import elastic, sharding
from repro_torch.kernels import _build, dispatch
from repro_torch.models import build
from repro_torch.models.layers import greedy


class _Clock:
    """Elapsed ms of a span: CUDA events on the card (the device's time,
    read after one synchronise at the end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: list = []

    def start(self):
        """Open a span."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, begin) -> None:
        """Close the span opened by ``start``."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans.append((begin, ev))
        else:
            self.spans.append((time.perf_counter() - begin) * 1e3)

    def ms(self) -> list[float]:
        """Every span's ms, in order."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.spans]
        return list(self.spans)


def serve_inputs(cfg, prompts: torch.Tensor) -> tuple[dict, int, int]:
    """The JAX launcher's input stubs for prompts (B, S) integers on the
    serving device: (the prefill batch, the first decode position, the
    encoder length ``enc_len`` for ``init_cache``).  A vision frontend
    gets zero ``patches`` (B, n_frontend_tokens, d); an audio one zero
    ``frames`` (B, S, d) and the decoder only the prompts' first token,
    so an enc-dec model decodes from position 1 against S encoder
    positions; any other model from position S, with no encoder."""
    b, s = prompts.shape
    batch = {"tokens": prompts}
    zeros = dict(dtype=torch.float32, device=prompts.device)
    if cfg.frontend == "vision":
        batch["patches"] = torch.zeros((b, cfg.n_frontend_tokens,
                                        cfg.d_model), **zeros)
    elif cfg.frontend == "audio":
        batch["frames"] = torch.zeros((b, s, cfg.d_model), **zeros)
        batch["tokens"] = prompts[:, :1]
    return batch, (1 if cfg.is_encdec else s), (s if cfg.is_encdec else 0)


def serve_batch(cfg, params: dict, prompts, *, gen_tokens: int = 16,
                model=None, trace: dict | None = None) -> np.ndarray:
    """prompts (B, S_prompt) integers -> generated tokens (B, gen_tokens)
    as a numpy int32 array; runs where the parameters lie.

    With a ``trace`` dict, it also records ``prefill_ms`` and
    ``decode_ms`` (a list, one a step; CUDA events on the card, the host
    clock on the CPU, named in ``clock``), ``logits`` (the prefill's and
    every decode step's, float32 (B, V) each) and ``launches_prefill``
    (the kernel launch counts just after the prefill was enqueued)."""
    model = model or build(cfg)
    dev = params["embed"].device
    b, s = prompts.shape
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                             device=dev)
    batch, pos, enc_len = serve_inputs(cfg, tokens)
    cache = model.init_cache(b, s + gen_tokens, enc_len, device=dev)
    mesh = sharding.ambient_mesh()
    if mesh is not None and sharding.is_dtensor(params["embed"]):
        batch = elastic.place(batch, mesh, sharding.batch_specs(
            batch, mesh, accum_dim=False))
        cache = elastic.place(cache, mesh, sharding.cache_specs(
            cache, cfg, mesh))
    clock = _Clock(dev)
    logits_seen = []

    t0 = clock.start()
    logits, cache = model.prefill(params, batch, cache)
    clock.stop(t0)
    if trace is not None:
        trace["launches_prefill"] = _build.launch_counts()
    logits_seen.append(logits)
    out = []
    tok = greedy(logits)
    for i in range(gen_tokens):
        out.append(tok)
        t0 = clock.start()
        logits, cache = model.decode(params, tok, pos + i, cache)
        clock.stop(t0)
        logits_seen.append(logits)
        tok = greedy(logits)
    gen = torch.stack(out, dim=1)
    if sharding.is_dtensor(gen):
        gen = gen.full_tensor()
    gen = gen.to(torch.int32).cpu().numpy()
    if trace is not None:
        ms = clock.ms()
        trace.update(prefill_ms=ms[0], decode_ms=ms[1:], logits=logits_seen,
                     clock="cuda events" if clock.cuda else "host")
    return gen


def main(argv=None) -> None:
    """The command line: serve one seeded batch and print the tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m",
                    choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = dispatch.resolve_device(args.device)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    gen = serve_batch(cfg, params, prompts, gen_tokens=args.gen_tokens,
                      model=model)
    dt = time.time() - t0
    print(f"[serve] {cfg.name} on {dev}: generated {gen.shape} in {dt:.2f}s "
          f"({args.batch * args.gen_tokens / dt:.1f} tok/s)")
    print(gen[:2])


if __name__ == "__main__":
    main()

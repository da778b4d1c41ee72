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

The serve step is compiled, the port of the JAX launcher's
``jax.jit(model.prefill)`` / ``jax.jit(model.decode)`` (on a mesh, with
``in_shardings``): ``serve_batch`` runs the prefill and every decode
step as replays of two CUDA graphs (``torch.cuda.CUDAGraph``) captured
from ``Model.prefill`` and ``Model.decode``, every hand-written kernel
inside them.  The decode step takes its position as a 0-d tensor, as
the reference's traced ``pos``, so one graph serves every position.  A
``CompiledServe`` is kept on the model for each shape key (batch,
prompt length, ``max_len``, ``enc_len``, the frontend stubs' shapes,
the default backend, whether autotuning is on, and the ambient mesh's
shape and dimension names) with its static inputs, its cache (reset in
place each serve), both graphs and the parameter tensors it captured;
the first serve of a key runs the prefill and decode step 0 eagerly on
the graphs' stream -- real results, and the warm-up the capture needs
(on a mesh also the NCCL communicators') -- then captures both and
replays the decode for the rest; later serves of the same parameter
tensors replay both, and read their current values (``launch.train``'s
compiled step updates them in place).  A serve of the key with other
parameter tensors releases the entry (its graphs, pool, cache and
parameters) and captures anew, so a model holds at most one compiled
serve a shape key.  Every compiled step of a device runs on one side
stream (``graph_stream``).  A capture or a replay that fails raises:
nothing runs the eager step behind the caller's back.

The route is ``launch.mesh.compiled_route``: parameters on the card and
no mesh, or a mesh whose groups are NCCL -- there DTensor parameters get
a static batch, cache and ``tok`` placed as the eager serve places its
batch and cache, and the graphs record the kernels DTensor's dispatch
enqueues and NCCL's collectives.  The step runs eagerly (op by op from
Python) on the CPU, on a gloo mesh (gloo's collectives run on the host,
where no graph sees them) and when the caller passes ``eager=True`` --
the reference the compiled step is held to bit for bit (``--eager`` on
the command line); ``trace["step"]`` says which ran.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.autotune import cache as tuning
from repro_torch.distributed import elastic, sharding
from repro_torch.kernels import _build, dispatch
from repro_torch.launch.mesh import compiled_route
from repro_torch.models import build
from repro_torch.models.layers import greedy
from repro_torch.obs import steps
from repro_torch.obs import trace as obs_trace


class Clock:
    """Elapsed ms of a span: CUDA events on the card (the device's time,
    read after one synchronise at the end), the host clock on the CPU;
    nothing when ``on`` is false (a serve without a ``trace``)."""

    def __init__(self, device: torch.device, on: bool = True):
        self.cuda = device.type == "cuda"
        self.on = on
        self.spans: list = []

    def start(self):
        """Open a span."""
        if not self.on:
            return None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, begin) -> None:
        """Close the span opened by ``start``."""
        if not self.on:
            return
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


def _named(tree, name: str = ""):
    """(leaf name, tensor) of every tensor in a tree of dicts and lists
    (a cache, the parameters)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _named(v, name)
    else:
        yield name, tree


def _reset(cache: list) -> None:
    """Set a cache to ``init_cache``'s state in place: ``kpos`` -1 (every
    slot empty), every other tensor 0 (a DTensor's local shard)."""
    for name, t in _named(cache):
        t = t.to_local() if sharding.is_dtensor(t) else t
        if name == "kpos":
            t.fill_(-1)
        else:
            t.zero_()


#: the graphs' stream of each device (``graph_stream``)
_STREAMS: dict = {}


def graph_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every compiled step on ``device`` warms up and
    captures on, one a device: what the warm-up makes for a stream and
    keeps for the stream's life (cuBLAS's workspace, 32 MiB on an H100)
    is then made once, not once a capture."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _placed(cfg, params: dict, mesh, batch: dict, cache: list, *rows):
    """A serve's batch, cache and any further batch-like tensors
    ``rows`` placed on ``mesh`` for DTensor parameters (``batch_specs``,
    ``cache_specs``: each rank its shards, no data moved); as they are
    for plain parameters or without a mesh."""
    if mesh is None or not sharding.is_dtensor(params["embed"]):
        return (batch, cache, *rows)
    return (elastic.place(batch, mesh, sharding.batch_specs(
                batch, mesh, accum_dim=False)),
            elastic.place(cache, mesh, sharding.cache_specs(cache, cfg, mesh)),
            *(elastic.place(t, mesh, sharding.batch_specs(t, mesh,
                                                          accum_dim=False))
              for t in rows))


def record_stream(t: torch.Tensor, stream: torch.cuda.Stream) -> None:
    """``t.record_stream(stream)``; a DTensor's on its local tensor, which
    holds its memory (DTensor has no rule for the op)."""
    (t.to_local() if sharding.is_dtensor(t) else t).record_stream(stream)


class CompiledServe:
    """The compiled serve step of one key: the static inputs (the prompts,
    the frontend stubs, the current token ``tok`` (B,) and ``pos``, a 0-d
    int64), the cache, and once captured the prefill and decode CUDA
    graphs, one memory pool for both, with the kernel launches of each
    replay (``_build.Recording``) and the logits each writes.  With
    DTensor parameters on ``mesh`` the batch, the cache and ``tok`` are
    DTensors placed as ``_serve_eager`` places them (``batch_specs``,
    ``cache_specs``; ``tok`` as a batch); ``pos`` stays a plain 0-d
    tensor, the same on every rank, which the model uses inside its
    local bodies or DTensor replicates as a scalar.

    ``prefill`` resets the cache, runs ``Model.prefill`` on the static
    batch, writes the greedy token into ``tok`` and sets ``pos`` to the
    first decode position; ``decode`` runs ``Model.decode`` at ``tok`` and
    ``pos``, writes the next greedy token into ``tok`` and advances
    ``pos``.  Both read and write only these tensors, so a graph captured
    from either replays them at any position.  The model is passed in,
    not kept: the model keeps this object (``Model.serve_graphs``)."""

    def __init__(self, model, params: dict, b: int, s: int, max_len: int,
                 device: torch.device, mesh=None, spans: bool = False):
        self.params = params     # the tensors the graphs read
        self.prompts = torch.zeros((b, s), dtype=torch.int64, device=device)
        self.batch, self.pos0, enc_len = serve_inputs(model.cfg, self.prompts)
        self.cache = model.init_cache(b, max_len, enc_len, device=device)
        self.tok = torch.zeros((b,), dtype=torch.int64, device=device)
        self.batch, self.cache, self.tok = _placed(
            model.cfg, params, mesh, self.batch, self.cache, self.tok)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.stream = graph_stream(device) if device.type == "cuda" \
            else None    # the graphs' stream (the steps run anywhere)
        self.graphs: tuple | None = None
        self.records: tuple | None = None
        self.logits: tuple | None = None
        #: with ``spans``, the prefill's and the decode step's layer spans
        #: (``obs.steps``): recorded by each eager run and by the capture,
        #: whose graphs then hold their events
        self.spans = (steps.StepSpans(device), steps.StepSpans(device)) \
            if spans else None

    def load(self, prompts) -> None:
        """Copy a serve's prompts (B, S) into ``prompts``, which the
        batch's tokens view; a placed batch's tokens take this rank's
        rows of them into their local shard."""
        self.prompts.copy_(torch.as_tensor(prompts, dtype=torch.int64))
        tokens = self.batch["tokens"]
        if sharding.is_dtensor(tokens):
            tokens.to_local().copy_(sharding.local_part(
                self.prompts[:, :tokens.shape[1]], tokens))

    def prefill(self, model) -> torch.Tensor:
        """The prefill step (see the class); returns its logits."""
        with steps.region("reset"):
            _reset(self.cache)
        logits, _ = model.prefill(self.params, self.batch, self.cache)
        with steps.region("greedy"):
            self.tok.copy_(greedy(logits))
            self.pos.fill_(self.pos0)
        return logits

    def decode(self, model) -> torch.Tensor:
        """The decode step (see the class); returns its logits."""
        logits, _ = model.decode(self.params, self.tok, self.pos, self.cache)
        with steps.region("greedy"):
            self.tok.copy_(greedy(logits))
            self.pos.add_(1)
        return logits

    def eager(self, step, model) -> torch.Tensor:
        """Run ``step`` eagerly on the graphs' stream, after the current
        stream's work and before its next: the first serve's real
        prefill and step 0, and the warm-up of everything the capture
        records (cuBLAS's handle and workspace on that stream, each
        kernel's first-launch set-up)."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            logits = step(model)
        cur.wait_stream(self.stream)
        record_stream(logits, cur)
        return logits

    def capture(self, model) -> None:
        """Capture the prefill and the decode step, in that order, into
        two graphs sharing one pool.  A capture runs nothing: the cache,
        ``tok`` and ``pos`` keep their values, and the kernels it records
        count only when a graph replays."""
        pool = torch.cuda.graph_pool_handle()
        graphs, records, logits = [], [], []
        for i, step in enumerate((self.prefill, self.decode)):
            g = torch.cuda.CUDAGraph()
            with _build.record(counted=False) as rec, \
                    torch.cuda.graph(g, pool=pool, stream=self.stream), \
                    _armed(self.spans, i):
                logits.append(step(model))
            graphs.append(g)
            records.append(rec)
        self.graphs, self.records = tuple(graphs), tuple(records)
        self.logits = tuple(logits)

    def holds(self, params: dict) -> bool:
        """Whether ``params`` are the parameter tensors this step reads
        (the same objects, leaf by leaf)."""
        mine = [t for _, t in _named(self.params)]
        theirs = [t for _, t in _named(params)]
        return len(mine) == len(theirs) and all(
            a is b for a, b in zip(mine, theirs))

    def replay(self, i: int, host_us: list | None = None) -> torch.Tensor:
        """Replay graph ``i`` (0 the prefill, 1 the decode step) on the
        current stream, count its launches, and return the logits it
        wrote (overwritten by its next replay); the host µs of the
        replay call go on ``host_us`` when given."""
        t0 = time.perf_counter()
        self.graphs[i].replay()
        if host_us is not None:
            host_us.append((time.perf_counter() - t0) * 1e6)
        self.records[i].replay()
        return self.logits[i]


def _armed(spans: tuple | None, i: int):
    """Step ``i``'s layer spans (of ``spans``, the prefill's and the
    decode step's ``obs.steps.StepSpans``) armed for the run or capture
    inside; nothing without spans."""
    return contextlib.nullcontext() if spans is None \
        else steps.recording(spans[i])


def compiled_key(cfg, b: int, s: int, max_len: int, mesh=None,
                 spans: bool = False) -> tuple:
    """The shape key of a ``CompiledServe``: batch, prompt length,
    ``max_len``, ``enc_len``, the frontend stubs' shapes, the default
    backend (``dispatch.use_backend``), whether autotuning is on (the
    launch knobs are looked up at capture), whether the graphs hold
    layer spans, so an untraced serve never replays their event nodes
    and a traced one never replays graphs without them, and the mesh's
    shape and dimension names (None without one), so a serve without a
    mesh and one on a mesh never share graphs."""
    batch, _, enc_len = serve_inputs(
        cfg, torch.empty((b, s), dtype=torch.int64, device="meta"))
    stubs = tuple((k, tuple(v.shape)) for k, v in batch.items()
                  if k != "tokens")
    where = None if mesh is None else (tuple(mesh.shape),
                                       tuple(mesh.mesh_dim_names))
    return (b, s, max_len, enc_len, stubs, dispatch.default_backend(),
            tuning.enabled(), spans, where)


def compiled_serve(model, params: dict, b: int, s: int, max_len: int,
                   device: torch.device, mesh=None,
                   spans: bool = False) -> CompiledServe:
    """The model's ``CompiledServe`` of this shape key for ``params``: the
    kept one when it reads these parameter tensors; otherwise the kept
    one, if any, is released first (graphs, pool, cache, its parameters)
    and a new one, not yet captured, takes its place."""
    key = compiled_key(model.cfg, b, s, max_len, mesh, spans)
    cs = model.serve_graphs.get(key)
    if cs is not None and not cs.holds(params):
        del model.serve_graphs[key]
        cs = None
    if cs is None:
        cs = model.serve_graphs[key] = CompiledServe(
            model, params, b, s, max_len, device, mesh, spans)
    return cs


def release_graphs(model) -> None:
    """Free every compiled serve step kept on ``model``: graphs, static
    buffers and caches."""
    model.serve_graphs.clear()


@contextlib.contextmanager
def sync_debug_mode(mode: str | None):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside (unchanged for
    None), the previous mode restored after."""
    if mode is None:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _sizes(rec) -> dict:
    return {k: frozenset(v) for k, v in rec.sizes.items()}


def serve_batch(cfg, params: dict, prompts, *, gen_tokens: int = 16,
                model=None, trace: dict | None = None, eager: bool = False,
                sync_debug: str | None = None) -> np.ndarray:
    """prompts (B, S_prompt) integers -> generated tokens (B, gen_tokens)
    as a numpy int32 array; runs where the parameters lie: on the card,
    without a mesh or on an NCCL one (``compiled_route``; the mesh is the
    ambient one, else the DTensor parameters'), as replays of the
    compiled step (the module's docstring; kept on ``model``, so pass the
    same model to serve a key again without a capture), eagerly on the
    CPU, on a gloo mesh or with ``eager=True``.  The compiled step of
    DTensor parameters places its buffers on the ambient mesh: with no
    ``mesh_context`` it raises ``ValueError`` rather than capture over
    unplaced buffers.

    With a ``trace`` dict, it also records ``step`` ("cuda graph" or
    "eager"), ``prefill_ms`` and ``decode_ms`` (a list, one a step; CUDA
    events on the card, the host clock on the CPU, named in ``clock``),
    ``logits`` (the prefill's and every decode step's, float32 (B, V)
    each), ``launches_prefill`` (the kernel launch counts just after the
    prefill was enqueued), ``decode_sizes`` (each decode step's launch
    sizes by kernel), and for the compiled step ``capture_ms`` (the
    host ms of both captures; None when the key was captured before)
    and ``replay_us`` (the host µs of each replay call).
    ``sync_debug`` is ``torch.cuda.set_sync_debug_mode``'s mode from the
    compiled step's first replay to the end of its decode loop ("error"
    raises at any call there that synchronises with the host).

    Tracing.  The serve's phases -- ``serve.batch`` around ``serve.load``,
    ``serve.eager`` (a key's first prefill and step 0), ``serve.capture``,
    ``serve.prefill``, one ``serve.decode_step`` a step and
    ``serve.to_host`` -- are ``obs.steps.phase`` ranges: in
    ``torch.profiler``'s trace while it records, spans of the installed
    ``obs.Tracer`` while one is.  With a tracer installed and no mesh,
    the steps also record their layer spans (``obs.steps``: on the card
    CUDA events, event-record nodes of the graphs, which are then of
    their own key) and the MoE layers' counts; after each step ran the
    serve waits for the card and puts its spans into the tracer on
    track "prefill" or "decode" (attributes ``step``, ``batch``,
    ``prompt``, ``layer``), and at its end the counts into
    ``tracer.metrics`` (``moe_routed_entries``, ``moe_dropped_entries``,
    by ``phase``).  The mesh paths (``attention._split_decode``,
    ``moe._moe_mesh``, ``sharding.tp_block``) record none."""
    if gen_tokens < 1:
        raise ValueError(f"gen_tokens must be at least 1, got {gen_tokens}")
    with steps.phase("serve.batch"):
        model = model or build(cfg)
        dev = params["embed"].device
        prompts = np.asarray(prompts)
        mesh = sharding.ambient_mesh()
        unplaced = mesh is None and sharding.is_dtensor(params["embed"])
        on = params["embed"].device_mesh if unplaced else mesh
        spans = obs_trace.active().enabled and on is None
        if not compiled_route(params, on, eager):
            return _serve_eager(cfg, model, params, prompts, gen_tokens,
                                trace, dev, mesh, spans)
        if unplaced:
            raise ValueError("serve_batch: the compiled step of DTensor "
                             "parameters places its buffers on the ambient "
                             "mesh; serve them under mesh_context(mesh)")
        return _serve_compiled(cfg, model, params, prompts, gen_tokens,
                               trace, dev, sync_debug, mesh, spans)


class _LayerSpans:
    """One serve's layer spans into the installed tracer: ``recs``, the
    prefill's and the decode step's ``obs.steps.StepSpans`` (None: the
    serve records none), put on the tracer's clock by one anchor."""

    def __init__(self, recs, dev: torch.device, b: int, s: int):
        self.recs = recs
        if recs is not None:
            self.tracer = obs_trace.active()
            self.anchor = steps.Anchor(self.tracer, dev)
            self.attrs = {"batch": b, "prompt": s}

    def emit(self, i: int, step: int, graph: bool = False) -> None:
        """Step ``i``'s spans of its last run (a replay of its graph or an
        eager run), as step ``step`` of the serve."""
        if self.recs is not None:
            self.recs[i].emit(self.tracer, self.anchor, steps.TRACKS[i],
                              step=step, graph=graph, **self.attrs)

    def close(self) -> None:
        """The device counts of the serve into the tracer."""
        if self.recs is not None:
            for rec, track in zip(self.recs, steps.TRACKS):
                rec.take_counts(self.tracer, track)


def _tokens(out: list) -> np.ndarray:
    """The served tokens (B, G) as a numpy int32 array on the host."""
    gen = torch.stack(out, dim=1)
    if sharding.is_dtensor(gen):
        gen = gen.full_tensor()
    return gen.to(torch.int32).cpu().numpy()


def _serve_eager(cfg, model, params, prompts, gen_tokens, trace, dev, mesh,
                 spans):
    """The serve step op by op from Python."""
    b, s = prompts.shape
    with steps.phase("serve.load"):
        tokens = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        batch, pos, enc_len = serve_inputs(cfg, tokens)
        cache = model.init_cache(b, s + gen_tokens, enc_len, device=dev)
        batch, cache = _placed(cfg, params, mesh, batch, cache)
        layer_spans = _LayerSpans((steps.StepSpans(dev), steps.StepSpans(dev))
                                  if spans else None, dev, b, s)
    clock = Clock(dev, on=trace is not None)
    logits_seen, sizes = [], []

    with steps.phase("serve.prefill"):
        with _armed(layer_spans.recs, 0):
            t0 = clock.start()
            logits, cache = model.prefill(params, batch, cache)
            clock.stop(t0)
            if trace is not None:
                trace["launches_prefill"] = _build.launch_counts()
            logits_seen.append(logits)
            with steps.region("greedy"):
                tok = greedy(logits)
        layer_spans.emit(0, 0)
    out = []
    for i in range(gen_tokens):
        with steps.phase("serve.decode_step", step=i):
            out.append(tok)
            with _armed(layer_spans.recs, 1):
                t0 = clock.start()
                with _build.record() as rec:
                    logits, cache = model.decode(params, tok, pos + i, cache)
                clock.stop(t0)
                if trace is not None:
                    sizes.append(_sizes(rec))
                logits_seen.append(logits)
                with steps.region("greedy"):
                    tok = greedy(logits)
            layer_spans.emit(1, i)
    with steps.phase("serve.to_host"):
        gen = _tokens(out)
        layer_spans.close()
    if trace is not None:
        ms = clock.ms()
        trace.update(step="eager", prefill_ms=ms[0], decode_ms=ms[1:],
                     logits=logits_seen, decode_sizes=sizes,
                     clock="cuda events" if clock.cuda else "host")
    return gen


def _serve_compiled(cfg, model, params, prompts, gen_tokens, trace, dev,
                    sync_debug, mesh, spans):
    """The serve step as replays of the key's CUDA graphs (captured at
    the key's first serve, after its eager prefill and step 0)."""
    b, s = prompts.shape
    with steps.phase("serve.load"):
        cs = compiled_serve(model, params, b, s, s + gen_tokens, dev, mesh,
                            spans)
        cs.load(prompts)
        layer_spans = _LayerSpans(cs.spans, dev, b, s)
    keep = trace is not None
    clock = Clock(dev, on=keep)
    logits_seen, sizes, out, host_us = [], [], [], []
    capture_ms, first = None, cs.graphs is None

    def note_prefill(logits):
        if keep:
            trace["launches_prefill"] = _build.launch_counts()
            logits_seen.append(logits if first else logits.clone())

    if first:
        with steps.phase("serve.eager"):
            t0 = clock.start()
            with _armed(cs.spans, 0):
                note_prefill(cs.eager(cs.prefill, model))
            clock.stop(t0)
            layer_spans.emit(0, 0)
            out.append(cs.tok.clone())
            t0 = clock.start()
            with _build.record() as rec, _armed(cs.spans, 1):
                logits = cs.eager(cs.decode, model)
            clock.stop(t0)
            layer_spans.emit(1, 0)
            if keep:
                sizes.append(_sizes(rec))
                logits_seen.append(logits)
        with steps.phase("serve.capture"):
            c0 = time.perf_counter()
            cs.capture(model)
            capture_ms = (time.perf_counter() - c0) * 1e3
    with sync_debug_mode(sync_debug):
        if not first:
            with steps.phase("serve.prefill"):
                t0 = clock.start()
                logits = cs.replay(0)
                clock.stop(t0)
                note_prefill(logits)
                layer_spans.emit(0, 0, graph=True)
        for i in range(1 if first else 0, gen_tokens):
            with steps.phase("serve.decode_step", step=i):
                out.append(cs.tok.clone())
                t0 = clock.start()
                logits = cs.replay(1, host_us if keep else None)
                clock.stop(t0)
                if keep:
                    sizes.append(_sizes(cs.records[1]))
                    logits_seen.append(logits.clone())
                layer_spans.emit(1, i, graph=True)
    with steps.phase("serve.to_host"):
        gen = _tokens(out)
        layer_spans.close()
    if keep:
        ms = clock.ms()
        trace.update(step="cuda graph", prefill_ms=ms[0], decode_ms=ms[1:],
                     logits=logits_seen, decode_sizes=sizes,
                     capture_ms=capture_ms, replay_us=host_us,
                     clock="cuda events")
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
    ap.add_argument("--eager", action="store_true",
                    help="run the serve step op by op, not as CUDA graphs")
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
    trace = {}
    t0 = time.time()
    gen = serve_batch(cfg, params, prompts, gen_tokens=args.gen_tokens,
                      model=model, trace=trace, eager=args.eager)
    dt = time.time() - t0
    print(f"[serve] {cfg.name} on {dev} ({trace['step']}): generated "
          f"{gen.shape} in {dt:.2f}s "
          f"({args.batch * args.gen_tokens / dt:.1f} tok/s)")
    print(gen[:2])


if __name__ == "__main__":
    main()

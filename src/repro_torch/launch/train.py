"""Training driver: data -> train step -> checkpoint/restart loop, the
port of the JAX package's ``launch/train.py`` on one device.

Fault-tolerance contract (``tests/test_torch_checkpoint.py``):
  * checkpoints are atomic (tmp directory and rename) and carry the step;
  * ``--resume auto`` restarts from the latest complete checkpoint;
  * the data pipeline is stateless-seekable, so the resumed run sees the
    exact batches the lost run would have seen;
  * gradient accumulation is re-planned from the global batch
    (``distributed.elastic.replan_accum``), so the global batch is
    invariant.

Run:

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --steps 3 --global-batch 4 --seq-len 2048 --micro-per-shard 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --reduced --device cpu

Without ``--device cpu`` it runs on the GPU and raises when there is
none.  Weights are random, drawn from a ``torch.Generator`` seeded with
``--seed``; the batches are ``data.SyntheticLMData``'s.

The train step is compiled, the port of the JAX launcher's
``jax.jit(step_fn, in_shardings=..., donate_argnums=(0, 1))``:
``CompiledTrain`` holds the parameters and the optimizer state, updated
in place (the reference donates them), the batch buffers and the step's
learning rate and bias corrections as 0-d tensors.  The first step runs
eagerly on the graph's stream over those buffers -- a real step, and the
warm-up the capture needs (on a mesh also the NCCL communicators') --
then the whole step (every micro-batch's forward and backward, the plain
vjps of ``kernels.grad``, the float32 accumulation, the global norm and
clip, the AdamW update) is captured as one CUDA graph, and every later
step copies its batch in, refills the three scalars from the host and
replays it.  A capture or a replay that fails raises: nothing runs the
eager step behind the caller's back.  The route is
``launch.mesh.compiled_route``: parameters on the card and no mesh, or a
mesh whose groups are NCCL -- there the parameters, the optimizer state
and the batch buffers are DTensors placed by ``params_specs``,
``opt_specs`` and ``batch_specs``, each step's batch copied into every
rank's local rows, and the graph records the kernels DTensor's dispatch
enqueues and NCCL's collectives.  The CPU, a gloo mesh (gloo's
collectives run on the host, where no graph sees them) and
``eager=True`` (``--eager``) run the functional step op by op from
Python, the reference the compiled step is held to bit for bit;
``trace["step"]`` says which ran.

Sharded training (``--mesh``), SPMD, one process a device:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch mamba2-130m --reduced --mesh local

``--mesh local`` builds a ("data", "model") mesh over the ``torchrun``
world (``launch.mesh.make_local_mesh``); ``production`` and
``multipod`` are the reference's 16x16 and 2x16x16 meshes and need 256
and 512 ranks.  On a mesh every rank draws the same parameters from
the seed, takes its shards of them (``params_specs``), of the optimizer
state (``opt_specs``) and of each micro-batch (``batch_specs``), and
accumulates ``global_batch / (micro_per_shard * data width)``
micro-batches (``elastic.replan_accum``).  A checkpoint holds full
tensors, written by rank 0, so a run resumes on any mesh: the full
arrays are re-placed under the new mesh (``elastic.place``).
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint)
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed import elastic, sharding
from repro_torch.distributed.steps import make_train_step, make_train_step_
from repro_torch.kernels import _build, dispatch, grad
from repro_torch.launch.mesh import compiled_route
from repro_torch.launch.serve import (Clock, graph_stream, record_stream,
                                     sync_debug_mode)
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw_init, schedule


class CompiledTrain:
    """The compiled train step (the module's docstring): the parameters
    and optimizer state it updates in place, the static inputs --
    ``batch`` (leaves (accum, micro, ...); on ``mesh`` DTensors placed by
    ``batch_specs``) and ``scalars``, the step's (lr, 1 - b1**t, 1 -
    b2**t) as 0-d float32 tensors -- and once
    captured the step's CUDA graph, with the kernel launches and plain
    backwards of each replay (``_build.Recording``,
    ``grad.Recording``) and the loss and gradient norm it writes.

    ``run`` is the step op by op over these buffers (on the card on the
    graph's stream, after the current stream's work); ``capture``
    records the same ops into the graph, ``replay`` runs them.  The step
    reads and writes only these tensors, so one graph replays every
    step.  On the CPU there is no graph: ``run`` alone is the step."""

    def __init__(self, model, opt_cfg: AdamWConfig, accum: int, params,
                 opt_state: dict, mesh=None):
        dev = params["embed"].device
        self.params, self.opt_state, self.opt_cfg = params, opt_state, opt_cfg
        self.mesh = mesh
        self.batch: dict | None = None    # made at the first ``load``
        self.scalars = tuple(torch.zeros((), dtype=torch.float32, device=dev)
                             for _ in range(3))
        self.step_fn = make_train_step_(model, opt_cfg, accum)
        self.stream = graph_stream(dev) if dev.type == "cuda" else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.records: tuple | None = None
        self.out: dict | None = None

    def load(self, batch: dict) -> float:
        """Copy a step's batch (host tensors; on the card through pinned
        memory, with no host sync) into the static buffers -- on a mesh
        each rank's rows into its local shards -- and fill the scalars
        for the next step, ``opt_state["step"] + 1``; returns its
        learning rate."""
        if self.batch is None:
            self.batch = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device=self.scalars[0].device)
                          for k, v in batch.items()}
            if self.mesh is not None:
                self.batch = elastic.place(self.batch, self.mesh,
                                           sharding.batch_specs(
                                               self.batch, self.mesh,
                                               accum_dim=True))
        for k, v in batch.items():
            dst = self.batch[k]
            if sharding.is_dtensor(dst):
                v, dst = sharding.local_part(v, dst).contiguous(), \
                    dst.to_local()
            if self.stream is not None and not v.is_pinned():
                v = v.pin_memory()
            dst.copy_(v, non_blocking=True)
        vals = schedule(self.opt_state["step"] + 1, self.opt_cfg)
        for t, x in zip(self.scalars, vals):
            t.fill_(x)
        return vals[0]

    def run(self, timing: dict | None = None) -> dict:
        """The step op by op over the static buffers -- on the card the
        first step, and the warm-up of what the capture records (cuBLAS's
        handle and workspace on the graph's stream, the autograd
        thread's, each kernel's first launch) -- then the state's step
        advanced.  Returns {"loss", "grad_norm"}."""
        if self.stream is None:
            out = self.step_fn(self.params, self.opt_state, self.batch,
                               self.scalars, timing)
        else:
            cur = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = self.step_fn(self.params, self.opt_state, self.batch,
                                   self.scalars, timing)
            cur.wait_stream(self.stream)
            for t in out.values():
                record_stream(t, cur)
        self.opt_state["step"] += 1
        return out

    def capture(self) -> float:
        """Capture the step into one CUDA graph of its own memory pool,
        after the eager step's cached blocks are given back
        (``torch.cuda.graph`` synchronises and empties the cache); a
        capture runs nothing.  Returns the capture's host ms."""
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        with _build.record(counted=False) as launches, \
                grad.record() as backwards, \
                torch.cuda.graph(g, stream=self.stream):
            out = self.step_fn(self.params, self.opt_state, self.batch,
                               self.scalars)
        self.graph, self.records, self.out = g, (launches, backwards), out
        return (time.perf_counter() - t0) * 1e3

    def replay(self, host_us: list) -> dict:
        """Replay the graph on the current stream, count its launches and
        plain backwards, advance the state's step; returns fresh copies of
        the loss and gradient norm it wrote.  The host µs of the replay
        call go on ``host_us``."""
        t0 = time.perf_counter()
        self.graph.replay()
        host_us.append((time.perf_counter() - t0) * 1e6)
        for rec in self.records:
            rec.replay()
        self.opt_state["step"] += 1
        return {k: v.clone() for k, v in self.out.items()}


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               micro_per_shard: int = 1, ckpt_dir: str | None = None,
               ckpt_interval: int = 50, resume: bool = False,
               opt_cfg: AdamWConfig | None = None, log_every: int = 10,
               seed: int = 0, device: str | torch.device = "cuda",
               on_step=None, timing: dict | None = None, mesh=None,
               eager: bool = False, trace: dict | None = None,
               sync_debug: str | None = None):
    """Train ``cfg`` from step 0 (or the latest checkpoint with
    ``resume``) to ``steps``; shared by the CLI, the smoke run and the
    tests.  ``on_step(step, metrics)``, if given, is called after every
    step (metrics: ``loss``, ``lr``, ``grad_norm``, ``ms``, and the
    step's ``params`` and ``opt_state``).  On the card, without a mesh
    or on an NCCL one (``compiled_route``), the step is compiled (the
    module's docstring) and the parameters and state are donated:
    ``on_step`` sees the live tensors, which the next step overwrites,
    so it copies what it keeps (a checkpoint's snapshot is taken before
    the next step).  ``eager=True``, the CPU and a gloo mesh run the
    functional step.  ``timing``, a dict, collects the steps'
    CUDA-event spans (``make_train_step``: each micro-batch's forward
    and backward, the optimizer) of the steps run op by op -- on the
    compiled path only the first.  ``trace``, a dict, gets ``step``
    ("cuda graph" or "eager"), ``capture_ms`` (host; None without a
    capture) and ``replay_us`` (the host µs of each replay call).
    ``sync_debug`` is ``torch.cuda.set_sync_debug_mode``'s mode over
    each replayed step's enqueue (its batch's copy, the scalars, the
    replay); the loop's own read of each step's loss, as the
    reference's, stays outside.  With ``mesh`` (a ``DeviceMesh``) the
    step runs sharded over it under ``mesh_context``; None is the
    one-device path.  Returns (params, history of losses)."""
    dev = dispatch.resolve_device(device)
    model = build(cfg)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps,
                                     warmup_steps=max(1, steps // 20))
    accum = elastic.replan_accum(global_batch, micro_per_shard, mesh)
    micro = global_batch // accum

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, frontend=cfg.frontend,
        n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model))

    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt_state = adamw_init(params)
    start_step = 0
    manager = CheckpointManager(ckpt_dir, interval=ckpt_interval) \
        if ckpt_dir else None
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        (params, opt_state), start_step = load_checkpoint(
            ckpt_dir, (params, opt_state))
        print(f"[train] resumed from step {start_step}")
    if mesh is not None:
        pspecs = sharding.params_specs(params, mesh)
        params = elastic.place(params, mesh, pspecs)
        opt_state = elastic.place(opt_state, mesh,
                                  sharding.opt_specs(opt_state, pspecs))

    compiled = None
    if compiled_route(params, mesh, eager):
        compiled = CompiledTrain(model, opt_cfg, accum, params, opt_state,
                                 mesh)
    step_fn = make_train_step(model, opt_cfg, accum)
    history, host_us, capture_ms = [], [], None
    scope = (sharding.mesh_context(mesh) if mesh is not None
             else contextlib.nullcontext())
    with scope:
        for step in range(start_step, steps):
            batch = _host_batch(data, step, accum, micro)
            clock = Clock(dev)
            began = clock.start()
            if compiled is None:
                batch = {k: v.to(dev) for k, v in batch.items()}
                if mesh is not None:
                    batch = elastic.place(batch, mesh, sharding.batch_specs(
                        batch, mesh, accum_dim=True))
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch, timing)
            elif compiled.graph is None:
                lr = compiled.load(batch)
                metrics = {**compiled.run(timing), "lr": lr}
            else:
                with sync_debug_mode(sync_debug):
                    lr = compiled.load(batch)
                    metrics = {**compiled.replay(host_us), "lr": lr}
            clock.stop(began)
            _finish(step, steps, metrics, clock.ms()[0], params, opt_state,
                    manager, on_step, log_every, history)
            if compiled is not None and compiled.graph is None \
                    and step + 1 < steps:
                capture_ms = compiled.capture()
    if manager:
        manager.wait()
    if trace is not None:
        trace.update(step="eager" if compiled is None else "cuda graph",
                     capture_ms=capture_ms, replay_us=host_us)
    return params, history


def _host_batch(data, step: int, accum: int, micro: int) -> dict:
    """Step ``step``'s global batch as host tensors, each leaf (accum,
    micro, ...)."""
    return {k: torch.from_numpy(np.reshape(v, (accum, micro) + v.shape[1:]))
            for k, v in data.global_batch(step).items()}


def _value(t) -> float:
    """A (possibly DTensor) scalar as a Python float."""
    return float(t.full_tensor() if sharding.is_dtensor(t) else t)


def _finish(step, steps, metrics, ms, params, opt_state, manager, on_step,
            log_every, history) -> None:
    """A step's loss into the history, its checkpoint, ``on_step`` and
    its log line."""
    loss = _value(metrics["loss"])
    history.append(loss)
    if manager:
        manager.maybe_save(step + 1, (params, opt_state))
    if on_step is not None:
        on_step(step, {**metrics, "loss": loss, "ms": ms, "params": params,
                       "opt_state": opt_state})
    if step % log_every == 0 or step == steps - 1:
        print(f"[train] step {step:5d} loss {loss:.4f} "
              f"lr {float(metrics['lr']):.2e} "
              f"gnorm {_value(metrics['grad_norm']):.2f} "
              f"({ms:.0f} ms/step)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Under torchrun, --mesh trains sharded over the world.")
    ap.add_argument("--arch", default="mamba2-130m",
                    choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--micro-per-shard", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "never"], default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the GPU unless cpu is asked for")
    ap.add_argument("--eager", action="store_true",
                    help="run the train step op by op, not as a CUDA graph")
    ap.add_argument("--mesh", choices=["local", "production", "multipod"],
                    default=None, help="train sharded: a (data, model) "
                    "mesh over the torchrun world, or the reference's "
                    "16x16 / 2x16x16 (256 / 512 ranks)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        from repro_torch.launch import mesh as mesh_mod
        mesh_mod.ensure_process_group(
            "gloo" if args.device == "cpu" else "nccl")
        mesh = (mesh_mod.make_local_mesh() if args.mesh == "local"
                else mesh_mod.make_production_mesh(
                    multi_pod=args.mesh == "multipod"))

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
               seq_len=args.seq_len, micro_per_shard=args.micro_per_shard,
               ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
               resume=args.resume == "auto", seed=args.seed,
               device=args.device, mesh=mesh, eager=args.eager)


if __name__ == "__main__":
    main()

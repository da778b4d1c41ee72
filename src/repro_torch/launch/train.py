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
from repro_torch.distributed.steps import make_train_step
from repro_torch.kernels import dispatch
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw_init


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               micro_per_shard: int = 1, ckpt_dir: str | None = None,
               ckpt_interval: int = 50, resume: bool = False,
               opt_cfg: AdamWConfig | None = None, log_every: int = 10,
               seed: int = 0, device: str | torch.device = "cuda",
               on_step=None, timing: dict | None = None, mesh=None):
    """Train ``cfg`` from step 0 (or the latest checkpoint with
    ``resume``) to ``steps``; shared by the CLI, the smoke run and the
    tests.  ``on_step(step, metrics)``, if given, is called after every
    step (metrics: ``loss``, ``lr``, ``grad_norm``, ``ms``, and the
    step's new ``params`` and ``opt_state``); ``timing``, a dict,
    collects the steps' CUDA-event spans (``make_train_step``).  With
    ``mesh`` (a ``DeviceMesh``) the step runs sharded over it under
    ``mesh_context``; None is the one-device path.  Returns (params,
    history of losses)."""
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

    step_fn = make_train_step(model, opt_cfg, accum)
    history = []
    scope = (sharding.mesh_context(mesh) if mesh is not None
             else contextlib.nullcontext())
    with scope:
        for step in range(start_step, steps):
            params, opt_state = _step(
                step, steps, step_fn, data, params, opt_state, accum, micro,
                dev, mesh, manager, on_step, timing, log_every, history)
    if manager:
        manager.wait()
    return params, history


def _value(t) -> float:
    """A (possibly DTensor) scalar as a Python float."""
    return float(t.full_tensor() if sharding.is_dtensor(t) else t)


def _step(step, steps, step_fn, data, params, opt_state, accum, micro, dev,
          mesh, manager, on_step, timing, log_every, history):
    """One step of ``train_loop``: the batch, the step, its metrics."""
    raw = data.global_batch(step)
    batch = {k: torch.from_numpy(np.reshape(v, (accum, micro)
                                            + v.shape[1:])).to(dev)
             for k, v in raw.items()}
    if mesh is not None:
        batch = elastic.place(batch, mesh, sharding.batch_specs(
            batch, mesh, accum_dim=True))
    if dev.type == "cuda":
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        t0.record()
    else:
        w0 = time.perf_counter()
    params, opt_state, metrics = step_fn(params, opt_state, batch,
                                         timing)
    if dev.type == "cuda":
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1)
    else:
        ms = (time.perf_counter() - w0) * 1e3
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
    return params, opt_state


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
               device=args.device, mesh=mesh)


if __name__ == "__main__":
    main()

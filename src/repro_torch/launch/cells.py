"""Cell assembly: (arch x input shape x mesh) -> a traceable step, the
port of the JAX package's ``launch/cells.py``.

A "cell" is one entry of the 40-cell grid.  ``build_cell`` returns the
cell's step over ``FakeTensorMode`` stand-ins placed on the mesh (no
storage: a fake tensor carries shape, dtype and device only), plus the
metadata the roofline report needs.  The mesh is a ``DeviceMesh`` over
the current world -- on the host, a fake process group of 256 or 512
ranks (``launch/dryrun.py`` starts it); the step runs under
``dispatch.use_backend("ref")``, the plain versions of the kernels, the
reference's dry-run lowering path.  ``dryrun.run_cell`` traces the step
with ``hlo_analysis.DispatchTrace``.

Importable without any process group; nothing here starts one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import configs
from repro_torch.configs.shapes import (MICROBATCH_PER_SHARD, SHAPES,
                                        ShapeSpec, applicability)
from repro_torch.distributed import elastic, sharding
from repro_torch.distributed import steps
from repro_torch.models import attention_flops, build, flops_per_token
from repro_torch.models.config import ModelConfig, ssd_flops
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import leaves, tree_map


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    spec: ShapeSpec
    #: ``step(trace)``: run the cell's step once on its placed
    #: stand-ins, a train cell's accumulation loop under
    #: ``trace.repeat(accum)``
    step: Callable
    #: the placed inputs: their local shards are the arguments' bytes
    inputs: Any
    #: the FakeTensorMode the stand-ins belong to (enter it to run)
    fake_mode: Any
    meta: dict


def _data_width(mesh) -> int:
    fsdp, _ = sharding.axis_names(mesh)
    return sharding.axis_size(mesh, fsdp)


def _stand_in(shape, dtype) -> torch.Tensor:
    """A zero tensor (fake under the cell's ``FakeTensorMode``)."""
    return torch.zeros(shape, dtype=dtype)


def _train_batch(cfg: ModelConfig, spec: ShapeSpec, accum: int,
                 micro: int) -> dict:
    s = spec.seq_len
    b = {"tokens": _stand_in((accum, micro, s), torch.int32),
         "labels": _stand_in((accum, micro, s), torch.int32)}
    if cfg.frontend == "vision":
        b["patches"] = _stand_in((accum, micro, cfg.n_frontend_tokens,
                               cfg.d_model), torch.float32)
    elif cfg.frontend == "audio":
        b["frames"] = _stand_in((accum, micro, s, cfg.d_model), torch.float32)
    return b


def _serve_batch(cfg: ModelConfig, batch: int, seq: int) -> dict:
    dec_len = 1 if cfg.is_encdec else seq
    b = {"tokens": _stand_in((batch, dec_len), torch.int32)}
    if cfg.frontend == "vision":
        b["patches"] = _stand_in((batch, cfg.n_frontend_tokens, cfg.d_model),
                              torch.float32)
    elif cfg.frontend == "audio":
        b["frames"] = _stand_in((batch, seq, cfg.d_model), torch.float32)
    return b


def input_specs(arch: str, shape: str, mesh, cfg=None) -> dict:
    """Stand-ins for every input of the cell's step (whole, unplaced);
    call under a ``FakeTensorMode`` for storage-free ones."""
    cfg = cfg or configs.get(arch)
    spec = SHAPES[shape]
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    out: dict = {"params": params}
    if spec.kind == "train":
        micro = MICROBATCH_PER_SHARD[arch] * _data_width(mesh)
        accum = max(1, spec.global_batch // micro)
        micro = spec.global_batch // accum
        out["opt_state"] = adamw_init(params)
        out["batch"] = _train_batch(cfg, spec, accum, micro)
        out["accum"] = accum
    else:
        b = spec.global_batch
        enc_len = spec.seq_len if cfg.is_encdec else 0
        out["batch"] = _serve_batch(cfg, b, spec.seq_len)
        out["cache"] = model.init_cache(b, spec.seq_len, enc_len,
                                        device="cpu")
        out["tokens"] = _stand_in((b,), torch.int32)
        out["pos"] = spec.seq_len - 1
    return out


def build_cell(arch: str, shape: str, mesh, *,
               opt_cfg: AdamWConfig | None = None,
               kv_int8: bool = False) -> Cell:
    """The cell's step over placed fake stand-ins on ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    spec = SHAPES[shape]
    ok, why = applicability(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({arch}, {shape}) skipped: {why}")
    model = build(cfg)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    meta: dict = {"arch": arch, "shape": shape, "kind": spec.kind,
                  "n_params": cfg.param_count(),
                  "n_active_params": cfg.active_param_count()}
    with fake_mode:
        ins = input_specs(arch, shape, mesh, cfg)
        pspecs = sharding.params_specs(ins["params"], mesh)
        params = elastic.place(ins["params"], mesh, pspecs)
        if spec.kind == "train":
            accum = ins["accum"]
            opt = elastic.place(ins["opt_state"], mesh,
                                sharding.opt_specs(ins["opt_state"], pspecs))
            batch = elastic.place(ins["batch"], mesh, sharding.batch_specs(
                ins["batch"], mesh, accum_dim=True))
            placed = {"params": params, "opt_state": opt, "batch": batch}
            opt_cfg = opt_cfg or AdamWConfig()

            def step(trace):
                # value_and_grad's loop, its body traced once
                gacc = steps.grad_accumulator(params)
                with trace.repeat(accum):
                    loss = steps.accumulate(
                        model, params, {k: v[0] for k, v in batch.items()},
                        gacc)
                sum([loss]) / accum      # the mean loss, as the loop's
                gacc = tree_map(lambda g: g.div_(accum), gacc)
                return adamw_update(gacc, opt, params, opt_cfg)
            meta["accum_steps"] = accum
            meta["tokens_per_step"] = spec.global_batch * spec.seq_len
        else:
            batch = elastic.place(ins["batch"], mesh, sharding.batch_specs(
                ins["batch"], mesh, accum_dim=False))
            cache = elastic.place(ins["cache"], mesh, sharding.cache_specs(
                ins["cache"], cfg, mesh))
            fsdp, _ = sharding.axis_names(mesh)
            tokens = elastic.place({"t": ins["tokens"]}, mesh,
                                   {"t": (fsdp,)})["t"]
            # the step's arguments, as the reference lowers them
            placed = {"params": params, "cache": cache}
            placed.update({"batch": batch} if spec.kind == "prefill"
                          else {"tokens": tokens})
            if spec.kind == "prefill":
                def step(trace):
                    with torch.no_grad():
                        return model.prefill(params, batch, cache)
                meta["tokens_per_step"] = spec.global_batch * spec.seq_len
            else:
                pos = ins["pos"]

                def step(trace):
                    with torch.no_grad():
                        return model.decode(params, tokens, pos, cache)
                meta["tokens_per_step"] = spec.global_batch
    return Cell(arch, shape, cfg, spec, step, placed, fake_mode, meta)


def local_bytes(tree) -> int:
    """The bytes of the local shards of a tree's tensor leaves."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if sharding.is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def model_flops_for_cell(cell: Cell, n_devices: int) -> float:
    """Analytic MODEL_FLOPS per device per step (6*N_active*D + attention)."""
    cfg, spec = cell.cfg, cell.spec
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        f = flops_per_token(cfg) * tokens
        f += attention_flops(cfg, spec.global_batch, spec.seq_len)
        f += ssd_flops(cfg, spec.global_batch, spec.seq_len)
    elif spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        f = flops_per_token(cfg) / 3 * tokens          # fwd only = 2N
        f += attention_flops(cfg, spec.global_batch, spec.seq_len) / 3
        f += ssd_flops(cfg, spec.global_batch, spec.seq_len) / 3
    else:
        f = flops_per_token(cfg) / 3 * spec.global_batch
        f += attention_flops(cfg, spec.global_batch, 1,
                             kv_len=spec.seq_len, causal=False) / 3
        # decode SSD: recurrent step only (no chunked quadratic term)
        if cfg.family in ("ssm", "hybrid"):
            f += (4.0 * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state *
                  spec.global_batch * cfg.n_layers) / 3
    return f / n_devices

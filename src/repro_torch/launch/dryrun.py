"""Multi-pod dry-run: trace every (arch x shape) cell on the production
meshes and record per-device memory, FLOPs, collectives and an H100
roofline, the port of the JAX package's ``launch/dryrun.py``.

Nothing is lowered or compiled and no GPU is needed.  ``run_cell``
starts a *fake* process group of 256 (16x16) or 512 (2x16x16) ranks in
this one process (``torch.testing``'s ``FakeStore``; its collectives
move nothing), builds the cell's step over ``FakeTensorMode`` stand-ins
placed by the sharding rules (``launch/cells.py``), and runs it once
under ``hlo_analysis.DispatchTrace``, which counts one rank's local ops.
Rank 0 stands for every rank where each runs the same local shapes.
Under attention's sequence layout (``sharding.attn_layout``: ``model``
does not divide the query heads) a rank past the first attends with the
``window`` - 1 keys before its positions, so the last rank of the
``model`` axis is traced too and the record is the busier rank's, by
FLOPs (``flops_by_rank`` holds both).  A train cell traces one
micro-batch and multiplies it by the accumulation steps.  The roofline
divides by H100 datasheet constants (``roofline.py``): host analysis,
not card measurements.

The process group is started inside ``run_cell``/``main``, never at
import.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out r.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch import configs, hlo_analysis, roofline
from repro_torch.configs.shapes import SHAPES, applicability
from repro_torch.launch import cells


def fake_world(n: int, rank: int = 0) -> None:
    """Make the default process group a fake one of ``n`` ranks (this
    process ``rank``), replacing any fake group of another size or rank."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n \
                and dist.get_rank() == rank:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running; the "
                               "dry-run needs its own fake one")
        dist.destroy_process_group()
        _forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def _forget_meshes() -> None:
    """Empty DTensor's caches of sharding propagation and redistribution
    plans: they key a mesh by its shape and dim names, not its process
    groups, so after a new world they would hand back the old world's
    meshes, whose groups are gone."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for cached in (prop.propagate_op_sharding,
                   getattr(prop, "_propagate_tensor_meta_cached", None)):
        if hasattr(cached, "cache_clear"):
            cached.cache_clear()
    for clear in (getattr(_redistribute, "clear_redistribute_planner_cache",
                          None),     # and the C++ dispatch's cache
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None)):
        if clear is not None:
            clear()


def fake_mesh(shape, axes, rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` over a fake world of its size, seen
    from ``rank``."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    fake_world(n, rank)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def traced_ranks(cfg, mesh) -> tuple:
    """The ranks whose local ops stand for the mesh: rank 0, and under
    attention's sequence layout also the last rank of the ``model`` axis
    (every rank past the first runs the same shapes, its queries offset
    by ``window`` - 1 earlier keys)."""
    from repro_torch.distributed import sharding
    j = sharding.model_dim(mesh)
    width = sharding.model_width(mesh)
    if not cfg.n_heads or sharding.attn_layout(cfg, width) != "sequence":
        return (0,)
    at = [0] * mesh.ndim
    at[j] = width - 1
    return (0, int(mesh.mesh[tuple(at)]))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def trace_cell(cell: cells.Cell) -> tuple[dict, dict]:
    """Run the cell's step once under a ``DispatchTrace``: (the
    ``analyze`` dict, the ``bytes_per_device`` record)."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import dispatch
    trace = hlo_analysis.DispatchTrace()
    args = cells.local_bytes(cell.inputs)
    with cell.fake_mode, dispatch.use_backend("ref"), \
            sharding.mesh_context(_mesh_of(cell.inputs)), trace:
        out = cell.step(trace)
    ana = hlo_analysis.analyze(trace)
    outputs = cells.local_bytes(out)
    # the new parameters and optimizer state (train) or the new cache
    # (serve) take the places of the donated ones, as the reference's
    # donated arguments alias its outputs
    if cell.spec.kind == "train":
        donated = (cell.inputs["params"], cell.inputs["opt_state"])
        new = out[:2]
    else:
        donated, new = cell.inputs["cache"], out[1]
    aliased = min(cells.local_bytes(new), cells.local_bytes(donated))
    temps = max(trace.peak_bytes - outputs, 0)
    mem = dict(arguments=args, outputs=outputs, temps=temps,
               aliased=aliased,
               total_live=args + outputs + temps - aliased)
    return ana, mem


def _mesh_of(tree):
    from repro_torch.distributed import sharding
    from repro_torch.optim.adamw import leaves
    for t in leaves(tree):
        if sharding.is_dtensor(t):
            return t.device_mesh
    raise ValueError("the cell has no DTensor input")


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             verbose: bool = True, kv_int8: bool = False,
             mesh=None) -> dict:
    """Trace one cell on the production mesh (or ``mesh``, a mesh over a
    fake world) and return its record."""
    if mesh is None:
        mesh = fake_mesh((2, 16, 16) if multi_pod else (16, 16),
                         ("pod", "data", "model") if multi_pod
                         else ("data", "model"))
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh)}
    cfg = configs.get(arch)
    ok, why = applicability(cfg, shape)
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec
    t_build = t_trace = 0.0
    traced = {}
    ranks = traced_ranks(cfg, mesh)
    for r in ranks:
        m = mesh if r == 0 else fake_mesh(mesh.shape, mesh.mesh_dim_names,
                                          rank=r)
        t0 = time.time()
        cell = cells.build_cell(arch, shape, m, kv_int8=kv_int8)
        t1 = time.time()
        traced[r] = (cell, *trace_cell(cell))
        t_build, t_trace = t_build + t1 - t0, t_trace + time.time() - t1
    if len(ranks) > 1:    # the caller's world again
        fake_world(mesh.size(), 0)
    busiest = max(traced, key=lambda r: traced[r][1]["flops"])
    cell, ana, mem = traced[busiest]
    roof = roofline.roofline_terms(
        {"flops": ana["flops"], "bytes accessed": ana["hbm_bytes"]},
        roofline.CollectiveStats(ana["collective_bytes"],
                                 ana["collective_counts"]))
    mf = cells.model_flops_for_cell(cell, mesh.size())
    util = roofline.model_flops_utilization(mf, roof)
    rec.update(
        status="OK",
        kind=cell.spec.kind,
        n_params=cell.meta["n_params"],
        accum_steps=cell.meta.get("accum_steps"),
        rank=busiest,
        flops_by_rank={r: traced[r][1]["flops"] for r in ranks},
        build_s=t_build,
        trace_s=t_trace,
        bytes_per_device=mem,
        hlo_flops_per_device=roof.flops,
        hlo_bytes_per_device=roof.hbm_bytes,
        collective_bytes_per_device=roof.collective_bytes,
        collective_breakdown=ana["collective_bytes"],
        collective_counts=ana["collective_counts"],
        model_flops_per_device=mf,
        roofline=dict(t_compute=roof.t_compute, t_memory=roof.t_memory,
                      t_collective=roof.t_collective,
                      bottleneck=roof.bottleneck, **util),
    )
    if verbose:
        print(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=configs.list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache for decode cells")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a in configs.list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    failures = 0
    for arch, shape in todo:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               verbose=not args.out, kv_int8=args.kv_int8)
            except Exception as e:  # a failing cell is a bug; record it
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                failures += 1
                print(f"FAIL {arch} x {shape} ({rec['mesh']}): {e}")
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec, default=float) + "\n")
                print(f"{rec['status']:5s} {arch} x {shape} ({rec['mesh']})",
                      flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()

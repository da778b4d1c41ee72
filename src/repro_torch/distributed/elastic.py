"""Elastic re-meshing: resume a checkpoint on another device count, the
port of the JAX package's ``distributed/elastic.py``.

The checkpoint stores full (unsharded) host arrays, so resuming onto a
smaller or larger mesh is re-placement under the new mesh's sharding
rules (``place``).  The data pipeline is stateless-seekable, so the
resumed job replays from the exact step with the new data-parallel
width -- the global batch is preserved (``replan_accum``: the
accumulation steps scale inversely with the data width).
"""
from __future__ import annotations

from repro_torch.distributed import sharding


def place(tree, mesh, spec_tree):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` under its
    (sanitized) spec, by ``distribute_tensor``; each rank takes its own
    shard of the full leaf it holds (every rank holds the same), so no
    data moves.  Non-tensor leaves (the optimizer's step) pass."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def put(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh,
                                 sharding.placements(spec, mesh),
                                 src_data_rank=None)

    specs = sharding.sanitize_specs(tree, spec_tree, mesh)
    return sharding._map_specs(put, specs, tree)


def _width(mesh) -> int:
    """The product of the mesh's fsdp axes (1 without a mesh)."""
    if mesh is None:
        return 1
    fsdp, _ = sharding.axis_names(mesh)
    return sharding.axis_size(mesh, fsdp)


def replan_accum(global_batch: int, micro_per_shard: int, mesh=None, *,
                 data_width: int | None = None) -> int:
    """Gradient-accumulation steps for the current mesh (None: one
    device, or ``data_width`` data shards) so the global batch is
    invariant under elastic resizes; raises ``ValueError`` when they do
    not divide it."""
    width = data_width if data_width is not None else _width(mesh)
    micro = micro_per_shard * width
    if global_batch % micro:
        raise ValueError(
            f"global batch {global_batch} not divisible by microbatch {micro}")
    return global_batch // micro

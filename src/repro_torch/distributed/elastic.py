"""Elastic re-planning of gradient accumulation, the port of the JAX
package's ``distributed/elastic.py`` on one device.

The data pipeline is stateless-seekable, so a job resumed with another
data-parallel width replays from the exact step with the same global
batch: the accumulation steps scale inversely with the width.  The port
runs on one card, a data width of 1; re-placing a checkpoint on a mesh
(``elastic.place``) comes with the multi-card slice.
"""
from __future__ import annotations


def replan_accum(global_batch: int, micro_per_shard: int,
                 data_width: int = 1) -> int:
    """The gradient-accumulation steps that keep ``global_batch``
    invariant at ``micro_per_shard`` rows a shard over ``data_width``
    data shards; raises ``ValueError`` when they do not divide it."""
    micro = micro_per_shard * data_width
    if global_batch % micro:
        raise ValueError(
            f"global batch {global_batch} not divisible by microbatch {micro}")
    return global_batch // micro

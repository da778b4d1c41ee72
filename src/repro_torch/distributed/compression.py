"""Gradient compression for cross-pod synchronisation, the port of the
JAX package's ``distributed/compression.py``.

Two mechanisms, both with error feedback so compression noise does not
accumulate:

  * implicit bf16: backward reduces gradients in the parameters' bf16
    dtype (half the collective bytes of fp32) while the accumulation
    across micro-batches and the optimizer run in fp32 -- what DTensor's
    reduce-scatter of a bfloat16 gradient does;
  * explicit int8: per-tensor-scaled int8 quantisation around the
    pod-axis all-reduce (4x fewer bytes on the slow inter-pod hop),
    ``pod_sync_int8``.

``quantize_int8``/``dequantize_int8`` are plain torch ops in the
reference's order; ``torch.round`` rounds half to even, as ``jnp.round``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.optim.adamw import leaves, tree_map


def quantize_int8(g: torch.Tensor, err: torch.Tensor):
    """(g + err) -> (int8 q, float32 scale, new_err)."""
    target = g.to(torch.float32) + err
    # the divisor a tensor on the device, not a Python number: CUDA turns
    # a division by a host scalar into a multiply by its reciprocal,
    # which is not the reference's correctly rounded quotient
    scale = torch.clamp_min(torch.max(torch.abs(target)), 1e-12) \
        / torch.full((), 127.0, device=target.device)
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, target - deq


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params):
    """Zero float32 error feedback of every parameter's shape (and
    placement: a DTensor leaf gets a DTensor of zeros)."""
    return tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                    params)


def _sync_block(g: torch.Tensor, err: torch.Tensor, group, pods: int):
    q, scale, new_err = quantize_int8(g, err)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    g_out = (total.to(torch.float32) * scale_max / pods).to(g.dtype)
    return g_out, new_err


def pod_sync_int8(grads, err_state, mesh, pspecs=None):
    """All-reduce ``grads`` over the ``pod`` axis in int8 with error
    feedback: each rank's block quantized, the int32 sum of the words and
    the float32 max of the scales all-reduced over the pod sub-mesh, then
    divided by the pod width.  Call it with gradients already reduced
    over the in-pod axes; only the slow inter-pod hop is compressed.
    Without a ``pod`` axis the inputs come back unchanged.  A DTensor
    leaf syncs its local shard (its pod placement is whole, as the
    reference's inner spec drops ``pod``) and stays a DTensor."""
    if "pod" not in mesh.mesh_dim_names:
        return grads, err_state
    group = mesh.get_group("pod")
    pods = sharding.axis_size(mesh, "pod")

    def leaf(g, err):
        if not sharding.is_dtensor(g):
            return _sync_block(g, err, group, pods)
        from torch.distributed.tensor import DTensor
        out, new_err = _sync_block(g.to_local(), err.to_local(), group, pods)
        return (DTensor.from_local(out, g.device_mesh, g.placements,
                                   run_check=False),
                DTensor.from_local(new_err, err.device_mesh, err.placements,
                                   run_check=False))

    out = iter([leaf(g, e) for g, e in zip(leaves(grads),
                                           leaves(err_state))])
    pairs = tree_map(lambda _: next(out), grads)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))

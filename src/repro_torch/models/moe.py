"""Top-k mixture-of-experts FFN, the port of the JAX package's
``models/moe.py`` on one device: ``init``, ``capacity`` and ``moe_ffn``
run the reference's ``_moe_local`` with no mesh, in its order of
operations.

  * routing in float32: router logits, softmax, top-k, the gates
    renormalised by their sum (clamped at 1e-9), and the Switch ``aux``
    load-balance term;
  * group-local sort-based dispatch: a stable sort of the expert ids,
    capacity ``capacity(cfg, s)`` slots an expert a group (one group a
    sequence; a decode step's B tokens are ONE group, or each token
    would pad to 8 slots an expert), slots past it dropped to a
    sentinel row;
  * SwiGLU experts with the gate and up products summed and kept in
    float32 (``preferred_element_type=float32``) before ``silu(g) * u``,
    then cast to the activation dtype for the down product;
  * the gated combine, deterministic: each token's k contributions are
    taken back in token order (the inverse of the sort) and added one
    after another into zeros, in ascending sorted position -- ascending
    expert id, since a token's k experts are distinct.  That is the
    order the reference's scatter-add visits them on the CPU (its
    updates in sorted order), and no add is left to atomics, so two
    runs on the card give the same bits.

The buffers are laid out expert-major, (e, b * c, d), so the three
expert products are ``torch.bmm`` calls without a transpose.  The
products and gathers run outside any kernel of the port, as they run
outside any Pallas kernel in the JAX package.  Routing reads nothing
back to the host: every size comes from shapes.

Under an ambient mesh (``sharding.mesh_context``) ``moe_ffn`` takes the
reference's explicit distribution: ``_moe_local`` runs on every rank's
shards in ``local_map`` -- the router whole, ``w_gate``/``w_up`` split
on ff over ``model`` and ``w_down`` on its ff dim when ``model``
divides ``d_ff``, x split on its batch over the fsdp axes when their
width divides it -- then ONE all-reduce (sum) of y over ``model``, in
x's dtype, and ``aux`` averaged over the fsdp and model axes.  Plain
tensors (serving) enter as whole DTensors and leave whole; DTensors
(training) keep their placements, and each input's gradient comes back
partial where its shard's use was.  ``mesh_calls`` counts the path.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.obs import steps


def init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The router (d, e) in float32 and the experts' SwiGLU weights
    w_gate, w_up (e, d, d_ff) and w_down (e, d_ff, d), normal with the
    JAX package's scales."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    return {
        "router": normal(generator, (d, e), s_in, torch.float32),
        "w_gate": normal(generator, (e, d, ff), s_in, dtype),
        "w_up": normal(generator, (e, d, ff), s_in, dtype),
        "w_down": normal(generator, (e, ff, d), s_out, dtype),
    }


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Slots an expert a group: capacity_factor * tokens * k / e, rounded
    up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * group_tokens * cfg.experts_per_token
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _grouped(x: torch.Tensor) -> torch.Tensor:
    """A decode step's (B, 1, d) as one group (1, B, d); else x."""
    if x.shape[1] == 1 and x.shape[0] > 1:
        return x.reshape(1, x.shape[0], -1)
    return x


@dataclasses.dataclass(frozen=True)
class Routing:
    """One ``moe_ffn`` call's routing over the grouped tokens (b, s).

    ``expert_ids``/``gates`` (b, s, k): the top-k experts and their
    renormalised gates; ``probs`` (b, s, e) the softmax; ``aux`` the
    load-balance term; ``order`` (b, s*k) the stable sort of the ids;
    ``keep`` (b, s*k), in sorted order, whether the entry got a slot;
    ``dest`` (b, s*k), in sorted order, its row of the expert-major
    (e * b * c + 1, d) buffer (the last row the sentinel)."""

    expert_ids: torch.Tensor
    gates: torch.Tensor
    probs: torch.Tensor
    aux: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    capacity: int


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` (int64) without its range check, which reads
    the ids back to the host on the CPU: the decode step's ops are the
    same at every position, with no host read (``launch.serve``)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def route(router: torch.Tensor, x: torch.Tensor,
          cfg: ModelConfig) -> Routing:
    """Route x (B, S, d) -- a decode step's tokens as one group -- in
    float32, and place each (token, expert) entry in its slot."""
    x = _grouped(x)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    c = capacity(cfg, s)
    sk = s * k
    dev = x.device

    logits = torch.matmul(x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    frac = _one_hot(expert_ids, e).to(torch.float32).mean(dim=(0, 1, 2))
    aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))

    ids = expert_ids.reshape(b, sk)
    order = torch.sort(ids, dim=-1, stable=True).indices
    sid = torch.gather(ids, -1, order)
    counts = _one_hot(ids, e).sum(dim=1)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(sk, device=dev)[None] - torch.gather(starts, -1, sid)
    keep = pos < c
    brow = torch.arange(b, device=dev)[:, None]
    dest = torch.where(keep, sid * (b * c) + brow * c + pos, e * b * c)
    return Routing(expert_ids, gate_vals, probs, aux, order, keep, dest, c)


def _bmm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (e, m, d) @ w (e, d, f) with float32 products and sums, as
    ``preferred_element_type=float32``: bfloat16 operands on the card
    through cuBLAS's float32 output; elsewhere widened exactly to
    float32 first (a bfloat16 product is exact in float32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


#: calls of the mesh path since the last reset
_MESH_CALLS = 0


def mesh_calls() -> int:
    """``moe_ffn`` calls that took the mesh path since the last reset."""
    return _MESH_CALLS


def reset_mesh_calls() -> None:
    global _MESH_CALLS
    _MESH_CALLS = 0


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux float32 scalar);
    distributed over the ambient mesh when there is one."""
    mesh = sharding.ambient_mesh()
    if mesh is None:
        return _moe_local(params["router"], params["w_gate"],
                          params["w_up"], params["w_down"], x, cfg)
    return _moe_mesh(params, x, cfg, mesh)


def _moe_mesh(params: dict, x, cfg: ModelConfig, mesh):
    """``_moe_local`` on the shards of ``mesh`` (the reference's
    ``shard_map``), one all-reduce of y over ``model``."""
    global _MESH_CALLS
    _MESH_CALLS += 1
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    fsdp, _ = sharding.axis_names(mesh)
    names = mesh.mesh_dim_names
    tp = "model" if "model" in names else None
    ff_split = tp is not None and \
        cfg.d_ff % sharding.axis_size(mesh, tp) == 0
    b_split = bool(fsdp) and \
        x.shape[0] % max(sharding.axis_size(mesh, fsdp), 1) == 0
    R = Replicate()

    def on(batch, model):   # placements: one for fsdp dims, one for tp
        return tuple(R if mesh.size(j) == 1 and p.is_shard() else p
                     for j, p in enumerate(model if n == tp else batch
                                           for n in names))

    rows = Shard(0) if b_split else R
    part_b, part_m = (Partial() if b_split else R), \
        (Partial() if ff_split else R)
    ff_up, ff_down = (Shard(2), Shard(1)) if ff_split else (R, R)
    n_aux = 1
    for n in names:
        if (n == tp and ff_split) or (n != tp and b_split):
            n_aux *= mesh.size(names.index(n))

    def local_fn(router, w_gate, w_up, w_down, xl):
        y, aux = _moe_local(router, w_gate, w_up, w_down, xl, cfg)
        return y, aux / n_aux

    fn = local_map(
        local_fn,
        out_placements=(on(rows, part_m), on(part_b, part_m)),
        in_placements=(on(R, R), on(R, ff_up), on(R, ff_up),
                       on(R, ff_down), on(rows, R)),
        in_grad_placements=(on(part_b, part_m), on(part_b, ff_up),
                            on(part_b, ff_up), on(part_b, ff_down),
                            on(rows, part_m)),
        device_mesh=mesh, redistribute_inputs=True)
    args = (params["router"], params["w_gate"], params["w_up"],
            params["w_down"], x)
    plain = not any(isinstance(a, DTensor) for a in args)
    args = tuple(a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, (R,) * mesh.ndim, run_check=False) for a in args)
    y, aux = fn(*args)
    y = y.redistribute(mesh, on(rows, R))      # the all-reduce over model
    aux = aux.redistribute(mesh, (R,) * mesh.ndim)
    if plain:
        return y.full_tensor(), aux.to_local()
    return y, aux


def _moe_local(router, w_gate, w_up, w_down, x: torch.Tensor,
               cfg: ModelConfig):
    """One shard's MoE FFN (all of it off a mesh)."""
    orig_b = x.shape[0]
    with steps.region("moe.route"):
        r = route(router, x, cfg)
        rec = steps.armed()
        if rec is not None:
            rec.count("moe_routed_entries", r.keep.numel())
            rec.count("moe_dropped_entries", (~r.keep).sum())
    x = _grouped(x)
    b, s, d = x.shape
    e, k, c = cfg.n_experts, cfg.experts_per_token, r.capacity
    sk = s * k
    dev = x.device
    brow = torch.arange(b, device=dev)[:, None]

    # dispatch: token of each sorted entry into its slot; dropped
    # entries all land on the sentinel row, which nothing reads
    with steps.region("moe.dispatch"):
        stok = r.order // k
        flat_dest = r.dest.reshape(-1)
        xg = x.reshape(b * s, d).index_select(
            0, (brow * s + stok).reshape(-1))
        buf = x.new_zeros((e * b * c + 1, d))
        buf.index_copy_(0, flat_dest, xg)
        xe = buf[:e * b * c].view(e, b * c, d)

    # experts: SwiGLU, gate and up kept in float32 until silu(g) * u
    with steps.region("moe.experts"):
        h = F.silu(_bmm_f32(xe, w_gate)) * _bmm_f32(xe, w_up)
        ye = torch.bmm(h.to(x.dtype), w_down).to(x.dtype)
        yflat = torch.cat([ye.reshape(e * b * c, d), ye.new_zeros((1, d))])

    # combine: each token's k entries in ascending sorted position
    with steps.region("moe.combine"):
        sgate = torch.gather(r.gates.reshape(b, sk), -1, r.order)
        weight = (sgate * r.keep).to(x.dtype)
        inv = torch.empty_like(r.order).scatter_(
            1, r.order, torch.arange(sk, device=dev).expand(b, sk))
        at = torch.sort(inv.view(b, s, k), dim=-1).values.reshape(b, sk)
        at = (brow * sk + at).reshape(-1)
        contrib = yflat.index_select(0, flat_dest.index_select(0, at)) \
            * weight.reshape(-1).index_select(0, at)[:, None]
        contrib = contrib.view(b, s, k, d)
        y = x.new_zeros((b, s, d))
        for j in range(k):
            y = y + contrib[:, :, j]
    if orig_b != b:
        y = y.reshape(orig_b, 1, d)
    return y, r.aux

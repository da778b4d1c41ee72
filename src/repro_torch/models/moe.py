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
back to the host: every size comes from shapes.  The mesh path
(``moe_ffn`` under ``shard_map``) waits for the distributed slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal


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
    frac = F.one_hot(expert_ids, e).to(torch.float32).mean(dim=(0, 1, 2))
    aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))

    ids = expert_ids.reshape(b, sk)
    order = torch.sort(ids, dim=-1, stable=True).indices
    sid = torch.gather(ids, -1, order)
    counts = F.one_hot(ids, e).sum(dim=1)
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


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux float32 scalar)."""
    orig_b = x.shape[0]
    r = route(params["router"], x, cfg)
    x = _grouped(x)
    b, s, d = x.shape
    e, k, c = cfg.n_experts, cfg.experts_per_token, r.capacity
    sk = s * k
    dev = x.device
    brow = torch.arange(b, device=dev)[:, None]

    # dispatch: token of each sorted entry into its slot; dropped
    # entries all land on the sentinel row, which nothing reads
    stok = r.order // k
    flat_dest = r.dest.reshape(-1)
    xg = x.reshape(b * s, d).index_select(0, (brow * s + stok).reshape(-1))
    buf = x.new_zeros((e * b * c + 1, d))
    buf.index_copy_(0, flat_dest, xg)
    xe = buf[:e * b * c].view(e, b * c, d)

    # experts: SwiGLU, gate and up kept in float32 until silu(g) * u
    h = F.silu(_bmm_f32(xe, params["w_gate"])) \
        * _bmm_f32(xe, params["w_up"])
    ye = torch.bmm(h.to(x.dtype), params["w_down"]).to(x.dtype)
    yflat = torch.cat([ye.reshape(e * b * c, d), ye.new_zeros((1, d))])

    # combine: each token's k entries in ascending sorted position
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

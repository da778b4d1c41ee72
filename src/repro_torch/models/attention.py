"""GQA attention with RoPE, sliding windows and ring-buffer KV caches, the
port of the JAX package's ``models/attention.py``.

Three entry modes share one parameter set:
  * ``attend``      -- full-sequence attention without a cache (training,
                       and the enc-dec encoder with ``causal=False``);
  * ``prefill``     -- fills a cache (linear for full attention, ring
                       buffer for SWA) and returns outputs for every
                       position, through the ``flash_attention_3d`` kernel;
  * ``decode_step`` -- one new token against the cache
                       (``_cached_attention``, plain torch, as the JAX
                       package's is plain jnp).
The enc-dec decoder's cross-attention adds ``encode_kv`` (the encoder
output's keys and values, once a prefill) and ``cross_attend`` (the
decoder's queries against them, ``flash_attention_3d`` without a mask).

q and k go through the ``rope_3d`` kernel as contiguous (B, H, S, D)
buffers: ``_split_heads`` copies the heads out of the (B, S, H*D)
product once, where the JAX package keeps a transposed view.  Caches are
updated in place (the JAX package returns new arrays): a decode step
writes one slot instead of copying the cache (a sharded cache, a
DTensor, takes each write on the rank whose shard holds the slot:
``sharding.write_at``).  ``decode_step``'s ``pos`` is a Python int or a
0-d int64 tensor on the step's device, the JAX package's traced scalar:
from a tensor every position-dependent value -- the RoPE tables, the
query's position, the slot written and its ``kpos`` -- is computed on
the device, nothing is read back to the host and no Python branch looks
at the position, so one captured CUDA graph serves every position
(``launch.serve``).  A linear cache may hold
int8 keys and values with a float32 scale a (slot, head)
(``kv_cache_dtype="int8"``); an int8 ring raises
``errors.Int8RingCacheError``, as the JAX package cannot decode one.

On a mesh whose ``model`` axis splits ``wq``/``wk``/``wv`` by columns and
``wo`` by rows (the reference's specs, whatever the head counts), every
entry mode runs on each rank's local shards in one ``sharding.tp_block``
a call, plain tensors inside, ``wo``'s local product a partial sum
reduced over ``model`` once, by the layout of ``sharding.attn_layout``:

  * ``"heads"`` (``model`` divides both head counts): Megatron's split,
    ``_qkv``, RoPE, the flash kernel and ``_merge_heads`` at the rank's
    n_heads/tp query and n_kv_heads/tp kv heads (read off the local
    weights' widths, so the GQA group is unchanged); the prefill and the
    decode read and write the rank's shard of the head-split cache --
    exactly its local heads -- in place;
  * ``"groups"`` and ``"sequence"`` (``_split_full``): each rank projects
    its columns of q, k and v and gathers k and v whole over ``model``
    (activations, never a weight); ``"groups"`` attends with its query
    heads against the kv head of their group, ``"sequence"`` with its
    positions' queries against the keys from ``window`` - 1 before
    (``q_offset``), the outputs gathered back over the sequence;
  * a decode against the cache split by slots (``model`` not dividing
    the kv heads: ``_split_decode``): the token's q, k and v gathered
    whole, the new k/v written by the slot's owner, each rank's scores
    over its slots, the max and then the sums of exponentials and the
    value partial sums all-reduced over ``model``.

Where the batch does not split over the fsdp axes (a batch-1 decode),
the projections also keep their fsdp shards and the fsdp axes split
their contracted dim (``sharding.col_product``).  The enc-dec
cross-attention keeps the heads split only (``blocks.for_use`` gathers
it whole otherwise).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import write_at
from repro_torch.errors import Int8RingCacheError
from repro_torch.kernels import attention as k_attention
from repro_torch.kernels import rope as k_rope
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.rope import ref as rope_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.obs import steps


def init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """wq (d, Hq*D), wk and wv (d, Hkv*D), wo (Hq*D, d), normal with the
    JAX package's scales."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d ** -0.5
    return {
        "wq": normal(generator, (d, hq * hd), scale, dtype),
        "wk": normal(generator, (d, hkv * hd), scale, dtype),
        "wv": normal(generator, (d, hkv * hd), scale, dtype),
        "wo": normal(generator, (hq * hd, d), (hq * hd) ** -0.5, dtype),
    }


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _heads(w: torch.Tensor, cfg: ModelConfig) -> int:
    """The heads of a (d, H*D) projection: all of them, or a rank's."""
    return w.shape[-1] // cfg.head_dim


def _proj_heads(x: torch.Tensor, w: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    return _split_heads(sharding.col_product(x, w), _heads(w, cfg),
                        cfg.head_dim)


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor, use_rope: bool):
    q = _proj_heads(x, params["wq"], cfg)
    k = _proj_heads(x, params["wk"], cfg)
    v = _proj_heads(x, params["wv"], cfg)
    if use_rope:
        cos, sin = rope_ref.rope_tables(positions, cfg.head_dim,
                                        cfg.rope_theta, torch.float32)
        q = k_rope(q, cos, sin)
        k = k_rope(k, cos, sin)
    return q, k, v


# ---------------------------------------------------------------------------
# full-sequence attention (the encoder) and cross-attention
# ---------------------------------------------------------------------------

def _split(params: dict) -> bool:
    """Whether the projections are split over ``model`` by heads (or over
    the fsdp axes by their contracted dim)."""
    w = params["wk"]
    return sharding.split_on_model(w) or sharding.split_on_fsdp(w)


def _layout(params: dict, cfg: ModelConfig) -> str | None:
    """The split the projections take on a mesh (``sharding.
    attn_layout``), or None off one (and where ``model`` does not split
    ``wq``: the DTensor ops run as they are)."""
    wq = params["wq"]
    if not (sharding.split_on_model(wq) or sharding.split_on_fsdp(wq)):
        return None
    return sharding.attn_layout(cfg, sharding.model_width(wq.device_mesh))


def _splits(params: dict) -> dict:
    """Which leaves ``model`` splits (the rest come whole)."""
    return {k: sharding.split_on_model(v) for k, v in params.items()}


def _rope_heads(t: torch.Tensor, n_heads: int, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D), rotated at ``positions`` where the
    config uses RoPE."""
    t = _split_heads(t, n_heads, cfg.head_dim)
    if cfg.pos_embed != "rope":
        return t
    cos, sin = rope_ref.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                                    torch.float32)
    return k_rope(t, cos, sin)


def _cache_slots(cache: dict) -> tuple[dict, int]:
    """(the rank's local cache tensors, views the local body writes in
    place; its first slot): a cache split by slots over ``model``
    (``sharding.cache_specs`` where ``model`` does not divide the kv
    heads) or whole there, ``kpos`` whole."""
    k = cache["k"]
    if any(p.is_shard() and p.dim == 1 for p in k.placements):
        raise ValueError("a cache split by kv heads is read by the heads "
                         "layout, not by slots")
    return ({name: v.to_local() for name, v in cache.items()},
            sharding.model_offset(k, 2))


def _write_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, start,
                 cfg: ModelConfig, lo: int | None = None) -> dict:
    """Write k/v (B, Hkv, S, D) at ``start`` as a ring or linearly (the
    layout ``cache["kpos"]``'s length says); ``lo``: the cache's k/v are
    a local shard of slots from ``lo`` (``kpos`` whole)."""
    if cfg.window is not None and cache["kpos"].shape[0] == cfg.window:
        return _write_ring(cache, k, v, start, cfg.window, lo)
    return _write_linear(cache, k.to(cfg.activation_dtype),
                         v.to(cfg.activation_dtype), start, lo)


def _split_full(params: dict, x: torch.Tensor, cfg: ModelConfig, layout: str,
                *, causal: bool, block_kv: int, cache: dict | None = None,
                start: int = 0) -> torch.Tensor:
    """Full-sequence attention (and a prefill's cache writes) on a mesh
    whose ``model`` axis does not divide both head counts, each rank on
    its local shards in one ``sharding.tp_block``:

      * every rank projects its columns of q, k and v (its local ``wq``/
        ``wk``/``wv`` columns) and k and v are gathered whole over
        ``model`` (one gather of the activations, never a weight);
      * ``"groups"``: the rank's query heads (its ``wq`` columns) against
        the kv head of their group;
      * ``"sequence"``: q gathered too, the rank's positions' queries
        (the sequence split, padded to whole parts, causal keys padded
        with them) against the keys from ``window`` - 1 before its first
        (``q_offset``: on the plain route banded as from position 0); the
        outputs gathered back over the sequence;
      * ``wo``: the rank's rows, a partial sum all-reduced once;
      * a prefill writes every kept position's k/v into the rank's slots
        of the slot-split cache (``_write_cache``).
    """
    mesh = params["wq"].device_mesh
    width, rank = sharding.model_width(mesh), sharding.model_rank(mesh)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    split = _splits(params)
    local, lo_c = _cache_slots(cache) if cache is not None else (None, 0)

    def body(p, h):
        b, s, _ = h.shape
        positions = torch.arange(start, start + s, device=h.device)
        if layout == "groups":
            q = sharding.col_product(h, p["wq"])
            k, v = sharding.cols_on_model(h, [p["wk"], p["wv"]],
                                          [split["wk"], split["wv"]], mesh)
        else:
            q, k, v = sharding.cols_on_model(
                h, [p["wq"], p["wk"], p["wv"]],
                [split["wq"], split["wk"], split["wv"]], mesh)
        k = _rope_heads(k, hkv, cfg, positions)
        v = _split_heads(v, hkv, cfg.head_dim)
        if local is not None:
            _write_cache(local, k, v, start, cfg, lo_c)
        if layout == "groups":
            qpr = hq // width
            kv = slice(rank * qpr // (hq // hkv), rank * qpr // (hq // hkv) + 1)
            q = _rope_heads(q, qpr, cfg, positions)
            out = k_attention(q, k[:, kv], v[:, kv], causal=causal,
                              window=cfg.window, block_kv=block_kv)
            return _merge_heads(out) @ p["wo"]     # the rank's heads' rows
        sl = -(-s // width)                 # the rank's positions
        lo = rank * sl
        q = torch.nn.functional.pad(q, (0, 0, 0, width * sl - s))
        q = _rope_heads(q[:, lo:lo + sl], hq, cfg, position_range(
            start + lo, sl, h.device))
        ks, ke = 0, s
        if causal:     # the keys up to the rank's last query, padded as q
            k, v = (torch.nn.functional.pad(t, (0, 0, 0, width * sl - s))
                    for t in (k, v))
            ke = lo + sl
            if cfg.window is not None:
                ks = max(0, lo - cfg.window + 1)
        out = k_attention(q, k[:, :, ks:ke], v[:, :, ks:ke], causal=causal,
                          window=cfg.window, q_offset=lo - ks,
                          block_kv=block_kv)
        o = sharding.gather_on_model(_merge_heads(out), 1, mesh)[:, :s]
        return sharding.rows_on_model(o, p["wo"], split["wo"], mesh)
    rows_like = cache["k"] if cache is not None else None
    return sharding.tp_block(body, params, x, rows_like=rows_like,
                             partial=True)


def _heads_where(like, mesh) -> tuple:
    """Placements of a (B, H, T, D) tensor split by heads over ``model``
    and on its batch as ``like``."""
    from torch.distributed.tensor import Shard
    return sharding.with_model(sharding.rows_of(like, mesh), mesh, Shard(1))


def _local_cache(cache: dict) -> dict:
    """The rank's shard of a head-split cache (its batch rows and kv
    heads; ``kpos`` whole), views the local body writes in place."""
    if not all(sharding.is_dtensor(v) and not any(
            p.is_shard() and p.dim > 1 for p in v.placements)
            for v in cache.values()):
        raise ValueError("attention on local shards needs its cache placed "
                         "by sharding.cache_specs, split by batch and kv "
                         "heads only")
    return {k: v.to_local() for k, v in cache.items()}


def attend(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
           causal: bool = True, block_kv: int = 4096) -> torch.Tensor:
    """x (B, S, d) attending over itself without a cache -> (B, S, d);
    ``causal=False`` for the enc-dec encoder; ``block_kv`` is the
    training path's KV block (the JAX package's default)."""
    layout = _layout(params, cfg)
    if layout == "heads":
        return sharding.tp_block(
            lambda p, h: attend(p, h, cfg, causal=causal, block_kv=block_kv),
            params, x)
    if layout is not None:
        return _split_full(params, x, cfg, layout, causal=causal,
                           block_kv=block_kv)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions, cfg.pos_embed == "rope")
    out = k_attention(q, k, v, causal=causal, window=cfg.window,
                      block_kv=block_kv)
    return _merge_heads(out) @ params["wo"]


def cross_attend(params: dict, x: torch.Tensor, kv_cache: dict,
                 cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention: x (B, S, d) against the encoder's k/v
    (B, Hkv, T, D) of ``encode_kv``, unmasked -> (B, S, d)."""
    if _split(params):
        like = kv_cache["k"] if sharding.is_dtensor(kv_cache["k"]) else x
        return sharding.tp_block(
            lambda p, h, kv: cross_attend(p, h, kv, cfg), params, x,
            rows_like=like, extra=((kv_cache, _heads_where(
                like, params["wq"].device_mesh)),))
    q = _proj_heads(x, params["wq"], cfg)
    out = k_attention(q, kv_cache["k"], kv_cache["v"], causal=False)
    return _merge_heads(out) @ params["wo"]


def encode_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig) -> dict:
    """The cross-attention keys and values of the encoder output
    (B, T, d): {"k", "v"} of (B, Hkv, T, D), once a prefill (split by
    heads over ``model`` with the projections)."""
    if _split(params):
        from torch.distributed.tensor import Replicate, Shard
        heads = Shard(1) if sharding.split_on_model(params["wk"]) \
            else Replicate()
        return {name: sharding.tp_block(
            lambda p, h: _proj_heads(h, p["w"], cfg), {"w": params[w]},
            enc_out, split_out=heads) for name, w in (("k", "wk"),
                                                      ("v", "wv"))}
    k = _proj_heads(enc_out, params["wk"], cfg)
    v = _proj_heads(enc_out, params["wv"], cfg)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# KV cache (linear for full attention, ring buffer for SWA)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """The shape of one layer's KV cache."""

    batch: int
    n_kv_heads: int
    length: int          # cache slots: T_max (full) or window (SWA)
    head_dim: int
    ring: bool           # True for SWA ring buffer
    dtype: str = "bfloat16"   # bfloat16 | int8 (per-slot-scaled KV quant)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> CacheSpec:
    """A ring of ``window`` slots when the window is shorter than
    ``max_len``, else ``max_len`` linear slots; int8 when the config asks
    for it, else the config's dtype.  ``prefill`` and ``decode_step``
    write a cache of exactly ``window`` slots as a ring, so an int8 cache
    with ``window <= max_len`` raises ``Int8RingCacheError``."""
    ring = cfg.window is not None and cfg.window < max_len
    dtype = "int8" if cfg.kv_cache_dtype == "int8" else cfg.dtype
    if dtype == "int8" and cfg.window is not None and cfg.window <= max_len:
        raise Int8RingCacheError(cfg.name, cfg.window, max_len)
    return CacheSpec(batch, cfg.n_kv_heads, cfg.window if ring else max_len,
                     cfg.head_dim, ring, dtype)


def init_cache(spec: CacheSpec, device: torch.device) -> dict:
    """Zeroed k/v (B, Hkv, slots, D) and ``kpos`` (slots,) int32, the
    absolute position held in each slot (-1 = empty); an int8 cache adds
    float32 ``kscale``/``vscale`` (B, Hkv, slots, 1)."""
    shape = (spec.batch, spec.n_kv_heads, spec.length, spec.head_dim)
    dt = getattr(torch, spec.dtype)
    cache = {"kpos": torch.full((spec.length,), -1, dtype=torch.int32,
                                device=device),
             "k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if spec.dtype == "int8":
        for name in ("kscale", "vscale"):
            cache[name] = torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                      device=device)
    return cache


def _quantize(x: torch.Tensor):
    """int8 words and their float32 scale max|x| / 127 over the last
    axis; the words round half to even (``torch.round``, as
    ``jnp.round``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp_min(scale, 1e-9)).to(torch.int8)
    return q, scale


def _cache_kv(cache: dict, which: str) -> torch.Tensor:
    """Read k or v from the cache, dequantized to float32 if int8."""
    x = cache[which]
    if x.dtype == torch.int8:
        return x.float() * cache[which[0] + "scale"]
    return x


def position_range(start, s: int, device: torch.device) -> torch.Tensor:
    """The absolute positions start .. start + s - 1, (s,) int64 on
    ``device``: ``start`` a Python int or a 0-d int64 tensor on
    ``device``, which is never read back to the host."""
    if isinstance(start, torch.Tensor):
        return start + torch.arange(s, device=device)
    return torch.arange(start, start + s, device=device)


def _kv_writer(lo: int | None):
    """The k/v write: ``write_at`` on the cache's tensors, or with ``lo``
    on a local shard of slots from ``lo`` (``write_local``)."""
    if lo is None:
        return write_at
    return lambda dest, dim, index, value: sharding.write_local(
        dest, dim, lo, index, value)


def _write_linear(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                  start, lo: int | None = None) -> dict:
    s = k_new.shape[2]
    positions = position_range(start, s, cache["kpos"].device)
    at = positions if isinstance(start, torch.Tensor) \
        else slice(start, start + s)
    write = _kv_writer(lo)
    if cache["k"].dtype == torch.int8:
        for name, val in (("k", k_new), ("v", v_new)):
            q, scale = _quantize(val)
            write(cache[name], 2, at, q)
            write(cache[name + "scale"], 2, at, scale)
    else:
        write(cache["k"], 2, at, k_new.to(cache["k"].dtype))
        write(cache["v"], 2, at, v_new.to(cache["v"].dtype))
    write_at(cache["kpos"], 0, at, positions.to(torch.int32))
    return cache


def _write_ring(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                start, window: int, lo: int | None = None) -> dict:
    if cache["k"].dtype == torch.int8:   # no scales: refuse, never truncate
        raise Int8RingCacheError("int8 cache", window, cache["kpos"].shape[0])
    s = k_new.shape[2]
    positions = position_range(start, s, cache["kpos"].device).to(torch.int32)
    if s >= window:      # only the last `window` entries survive
        k_new, v_new = k_new[:, :, -window:], v_new[:, :, -window:]
        positions = positions[-window:]
    slots = (positions % window).long()
    write = _kv_writer(lo)
    write(cache["k"], 2, slots, k_new.to(cache["k"].dtype))
    write(cache["v"], 2, slots, v_new.to(cache["v"].dtype))
    write_at(cache["kpos"], 0, slots, positions)
    return cache


def _cached_logits(q: torch.Tensor, cache: dict, kpos: torch.Tensor,
                   qpos: torch.Tensor, window: int | None):
    """q (B, Hq, S, D) against the cache's k over the slots whose
    absolute positions are ``kpos``: (the masked float32 scores, the
    values expanded to the query heads)."""
    group = q.shape[1] // cache["k"].shape[1]
    mask = (kpos >= 0)[None, :] & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    k = attn_ref._expand_kv(_cache_kv(cache, "k"), group)
    v = attn_ref._expand_kv(_cache_kv(cache, "v"), group)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * (q.shape[-1] ** -0.5)
    logits = torch.where(mask[None, None], logits,
                         torch.full((), -1e30, device=q.device))
    return logits, v


def _cached_attention(q: torch.Tensor, cache: dict, qpos: torch.Tensor,
                      window: int | None) -> torch.Tensor:
    """Attend q (B, Hq, S, D) over the cache slots by their absolute
    positions (linear, ring and int8 layouts alike), in float32."""
    logits, v = _cached_logits(q, cache, cache["kpos"], qpos, window)
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _split_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  cache: dict, pos) -> torch.Tensor:
    """One token against a cache split by slots over ``model`` (the
    reference's sequence-sharded decode), each rank on its local shards
    in one ``sharding.tp_block``: its columns of q, k and v gathered
    whole over ``model`` (one token's worth), the new k/v written by the
    rank that owns the slot, scores over the rank's slots with the max
    all-reduced over ``model``, then the sums of exponentials and the
    value partial sums all-reduced together; ``wo``'s rows of the rank,
    a partial sum all-reduced once.  ``pos`` stays on the device."""
    mesh = params["wq"].device_mesh
    split = _splits(params)
    local, lo = _cache_slots(cache)
    n = local["k"].shape[2]
    by_slots = n != cache["k"].shape[2]

    def body(p, h):
        positions = position_range(pos, 1, h.device)
        q, k, v = sharding.cols_on_model(
            h, [p["wq"], p["wk"], p["wv"]],
            [split["wq"], split["wk"], split["wv"]], mesh)
        q = _rope_heads(q, cfg.n_heads, cfg, positions)
        k = _rope_heads(k, cfg.n_kv_heads, cfg, positions)
        _write_cache(local, k, _split_heads(v, cfg.n_kv_heads, cfg.head_dim),
                     pos, cfg, lo)
        logits, vv = _cached_logits(q, local, local["kpos"][lo:lo + n],
                                    positions, cfg.window)
        m = logits.amax(dim=-1, keepdim=True)
        if by_slots:
            m = sharding.reduce_on_model(m, "max", mesh)
        e = torch.exp(logits - m)
        lv = torch.cat([e.sum(dim=-1, keepdim=True),
                        torch.matmul(e, vv.float())], dim=-1)
        if by_slots:
            lv = sharding.reduce_on_model(lv, "sum", mesh)
        out = (lv[..., 1:] / lv[..., :1]).to(q.dtype)
        return sharding.rows_on_model(_merge_heads(out), p["wo"],
                                      split["wo"], mesh)
    return sharding.tp_block(body, params, x, rows_like=cache["k"],
                             partial=True)


def prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
            start: int = 0, block_kv: int = 1024):
    """Process a prompt x (B, S, d): fill the cache, return the
    per-position outputs (B, S, d) and the cache; ``block_kv`` is the
    plain path's KV block (the JAX package's prefill default)."""
    layout = _layout(params, cfg)
    if layout == "heads":
        local = _local_cache(cache)
        return sharding.tp_block(
            lambda p, h: prefill(p, h, cfg, local, start, block_kv)[0],
            params, x, rows_like=cache["k"]), cache
    if layout is not None:
        return _split_full(params, x, cfg, layout, causal=True,
                           block_kv=block_kv, cache=cache,
                           start=start), cache
    with steps.region("attention"):
        b, s, _ = x.shape
        positions = torch.arange(start, start + s, device=x.device)
        q, k, v = _qkv(params, x, cfg, positions, cfg.pos_embed == "rope")
        with steps.region("attention.core"):
            out = k_attention(q, k, v, causal=True, window=cfg.window,
                              q_offset=0, block_kv=block_kv)
        cache = _write_cache(cache, k, v, start, cfg)
        return _merge_heads(out) @ params["wo"], cache


def decode_step(params: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                pos):
    """One token x (B, 1, d) at absolute position ``pos`` (an int or a
    0-d int64 tensor on x's device): writes slot ``pos % window`` of a
    ring (``pos`` of a linear cache) and attends."""
    layout = _layout(params, cfg)
    if layout == "heads":
        local = _local_cache(cache)
        return sharding.tp_block(
            lambda p, h: decode_step(p, h, cfg, local, pos)[0],
            params, x, rows_like=cache["k"]), cache
    if layout is not None:
        return _split_decode(params, x, cfg, cache, pos), cache
    with steps.region("attention"):
        positions = position_range(pos, 1, x.device)
        q, k, v = _qkv(params, x, cfg, positions, cfg.pos_embed == "rope")
        cache = _write_cache(cache, k, v, pos, cfg)
        with steps.region("attention.core"):
            out = _cached_attention(q, cache, positions, cfg.window)
        return _merge_heads(out) @ params["wo"], cache

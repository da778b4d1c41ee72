"""Mamba-2 (SSD, state-space duality) block -- arXiv:2405.21060; the port
of the JAX package's ``models/ssm.py`` (its serving half).

The SSD chunked algorithm evaluates the recurrence as blocked matrix
algebra: an intra-chunk quadratic, attention-like term (the ``ssd_intra``
kernel) and an inter-chunk recurrence on the compressed per-chunk states.

Layout: d_inner = expand * d_model, heads h = d_inner / headdim, one
B/C group, state size n = cfg.ssm_state.

Cache (decode), per layer:
    state (B, h, p, n)    -- the SSM state, float32
    conv  (B, w-1, di+2n) -- the causal conv's tail
Both are written in place (``write_cache``): the prefill's final state
and tail, then each decode step's, go into the tensors ``init_cache``
made, so a CUDA graph replayed over the cache reads the step before's.

Differences from the JAX package, none in the function computed:
  * one code path: the kernel for CUDA tensors, its plain version on the
    CPU or under ``dispatch.use_backend("ref")`` (the JAX package picks
    between its kernel and an inline XLA path by the global backend);
  * the inter-chunk scan is a sequential loop over the chunks where the
    JAX package runs ``associative_scan``: the same products and sums,
    added in another order, so the states agree to float32 rounding;
  * the gated norm (float32 rows of width d_inner) runs through the
    ``rmsnorm_2d`` op, the kernel on the card: it is the same function as
    the JAX package's ``rmsnorm_ref`` call;
  * the sharding constraints (``sharding.constrain``: no-ops off a mesh
    and on plain tensors) shard the sequence over ``model``, as the
    reference's; the products with ``in_proj`` and ``out_proj``, the
    ``ssd_intra`` call and the inter-chunk output, which flatten the
    (batch, sequence) rows split on both, run on each rank's local rows
    (``sharding.local_call``), so no DTensor op flattens a doubly-split
    dim;
  * a decode step on a mesh (``_split_step``) splits ``in_proj``'s
    product by columns and the state on its head dim over ``model``,
    as the reference's specs lay them out, moving one token's worth
    between the ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (any_dtensor, constrain,
                                              local_call, on_shards)
from repro_torch.kernels import rmsnorm as k_rmsnorm
from repro_torch.kernels import ssd_intra
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal


def init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The block's parameters with the JAX package's scales and constants."""
    d = cfg.d_model
    di, n, h, w = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    dev = generator.device
    proj_out = 2 * di + 2 * n + h          # z, xBC, dt
    return {
        "in_proj": normal(generator, (d, proj_out), d ** -0.5, dtype),
        "conv_w": normal(generator, (w, di + 2 * n), w ** -0.5, dtype),
        "conv_b": torch.zeros((di + 2 * n,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm_gain": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": normal(generator, (di, d), di ** -0.5, dtype),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv over (B, S, Ch); tail (B, w-1, Ch) prepends
    history.  Returns (silu(conv + b), new_tail), in xbc's dtype."""
    width = w.shape[0]
    if tail is None:
        tail = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    xfull = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    out = sum(xfull[:, i:i + xbc.shape[1]] * w[i][None, None]
              for i in range(width))
    new_tail = xfull[:, -(width - 1):] if width > 1 else tail
    return F.silu(out + b[None, None].to(out.dtype)), new_tail


def _rows_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, k) @ w (k, n); on DTensors the local rows' product, x
    split on batch and sequence as it is and w whole."""
    if any_dtensor(x, w):
        return local_call(torch.matmul, (x, w), ((0, 1), ()))
    return x @ w


def _intra(xdt, bc, cc, cum):
    """``ssd_intra`` over the (B, nc) chunks flattened: (y (B, nc, lc, h,
    p), the chunk states (B, nc, h, p, n))."""
    bsz, nc, lc, h, p = xdt.shape
    n = bc.shape[-1]
    y, s = ssd_intra(xdt.reshape(bsz * nc, lc, h, p),
                     bc.reshape(bsz * nc, lc, n), cc.reshape(bsz * nc, lc, n),
                     cum.reshape(bsz * nc, lc, h))
    return y.reshape(bsz, nc, lc, h, p), s.reshape(bsz, nc, h, p, n)


def _inter(cc, state_prev, cum):
    """The chunks' outputs from the states entering them: (B, nc, lc, h,
    p) float32."""
    return torch.einsum("bcin,bchpn->bcihp", cc.float(), state_prev) \
        * torch.exp(cum)[..., None]


def _split(proj: torch.Tensor, cfg: ModelConfig):
    di, n = cfg.ssm_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) of a (B, S, ...) tensor by ``pad``;
    a DTensor on its local shards, the sequence made whole first
    (``on_shards``: DTensor's own pad strategy gives a 2-D mesh's output
    one placement in torch 2.11)."""
    return on_shards(lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)),
                     t, (1,))


def _ssd_chunked(x, dt, a_coef, b_in, c_in, chunk: int):
    """SSD as chunk-parallel matrix algebra plus a scan over the chunks.

    x (B, S, h, p), dt (B, S, h), a_coef = dt*A (B, S, h) negative,
    b_in/c_in (B, S, n).  Returns y (B, S, h, p) float32 and the final
    state (B, h, p, n) float32."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    cdtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    pad = (-s) % chunk
    if pad:
        x, dt, a_coef, b_in, c_in = (_pad_seq(t, pad)
                                     for t in (x, dt, a_coef, b_in, c_in))
    sp = s + pad
    nc, lc = sp // chunk, chunk

    def r(t, *trailing):   # (B, S, ...) -> (B, nc, lc, ...), nc sharded
        out = t.reshape(bsz, nc, lc, *trailing)
        return constrain(out, "batch", "model", *(None,) * (out.dim() - 2))

    xc = r(x, h, p)
    dtc = r(dt.float(), h)
    ac = r(a_coef.float(), h)
    bc = r(b_in, n)
    cc = r(c_in, n)
    # (B, nc, lc, h); on a DTensor, the local shard's cumsum: DTensor has
    # no strategy for its backward's flip in every torch release
    cum = on_shards(lambda a: torch.cumsum(a, dim=2), ac, (2,))
    xdt = (xc.float() * dtc[..., None]).to(cdtype)

    if any_dtensor(xdt, bc, cc, cum):   # each rank's (B, nc) chunks
        y_intra, s_c = local_call(_intra, (xdt, bc, cc, cum),
                                  ((0, 1),) * 4, n_out=2)
    else:
        y_intra, s_c = _intra(xdt, bc, cc, cum)

    # -- inter-chunk: state_c = state_{c-1} * exp(cum_last_c) + S_c --------
    decays = torch.exp(cum[:, :, -1, :])[..., None, None]  # (B, nc, h, 1, 1)
    states = [s_c[:, 0]]
    for c in range(1, nc):
        states.append(states[-1] * decays[:, c] + s_c[:, c])
    states = torch.stack(states, dim=1)
    state_prev = torch.cat([torch.zeros_like(states[:, :1]), states[:, :-1]],
                           dim=1)
    if any_dtensor(cc, state_prev, cum):   # each rank's (B, nc) chunks
        y_inter = local_call(_inter, (cc, state_prev, cum), ((0, 1),) * 3)
    else:
        y_inter = _inter(cc, state_prev, cum)
    y = (y_intra + y_inter).reshape(bsz, sp, h, p)[:, :s]
    return y, states[:, -1]


def forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
            conv_tail: torch.Tensor | None = None,
            return_state: bool = False):
    """Full-sequence SSD pass; x (B, S, d) -> y (B, S, d) (and the cache
    {state, conv} with ``return_state``)."""
    x = constrain(x, "batch", "model", None)
    proj = constrain(_rows_product(x, params["in_proj"]), "batch", "model",
                     None)
    z, xbc, dt_raw = _split(proj, cfg)
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_tail)
    xbc = constrain(xbc, "batch", "model", None)
    di, n, h, p = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    xs = xbc[..., :di].reshape(*xbc.shape[:2], h, p)
    b_in = xbc[..., di:di + n]
    c_in = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])
    a = -torch.exp(params["A_log"])[None, None]            # (1, 1, h)
    y, state = _ssd_chunked(xs, dt, dt * a, b_in, c_in, cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(*x.shape[:2], di)
    y = k_rmsnorm(y * F.silu(z.float()), params["norm_gain"], eps=cfg.norm_eps)
    out = _rows_product(y.to(x.dtype), params["out_proj"])
    if return_state:
        return out, {"state": state, "conv": new_tail}
    return out


def init_cache(cfg: ModelConfig, batch: int, device: torch.device) -> dict:
    """A zero state (B, h, p, n) float32 and conv tail (B, w-1, di+2n)."""
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             cfg.ssm_inner + 2 * cfg.ssm_state),
                            dtype=cfg.activation_dtype, device=device),
    }


def write_cache(cache: dict, new: dict) -> dict:
    """Store ``new``'s state and conv tail in ``cache``'s own tensors, in
    place; returns ``cache``."""
    for name in ("state", "conv"):
        cache[name].copy_(new[name])
    return cache


def decode_step(params: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: dict):
    """One token x (B, 1, d) against the recurrent state; the new state
    and conv tail are written into ``cache`` in place, and ``cache`` is
    returned.  A cache on a mesh (DTensors placed by ``sharding.
    cache_specs``) runs ``_split_step``."""
    if sharding.is_dtensor(cache["state"]):
        return _split_step(params, x, cfg, cache), cache
    proj = x @ params["in_proj"]
    z, xbc, dt_raw = _split(proj, cfg)
    w = params["conv_w"]
    xfull = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", xfull[:, -w.shape[0]:], w)
    xbc1 = F.silu(conv_out + params["conv_b"][None].to(conv_out.dtype))
    new_conv = xfull[:, 1:] if w.shape[0] > 1 else cache["conv"]

    di, n, h, p = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    xs = xbc1[..., :di].reshape(-1, h, p).float()
    b_in = xbc1[..., di:di + n].float()
    c_in = xbc1[..., di + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"][None])  # (B, h)
    a = -torch.exp(params["A_log"])[None]                  # (1, h)
    decay = torch.exp(dt * a)                              # (B, h)
    state = cache["state"] * decay[:, :, None, None] + \
        torch.einsum("bhp,bn,bh->bhpn", xs, b_in, dt)
    y = torch.einsum("bn,bhpn->bhp", c_in, state) + \
        params["D"][None, :, None] * xs
    y = y.reshape(-1, 1, di)
    y = k_rmsnorm(y * F.silu(z.float()), params["norm_gain"], eps=cfg.norm_eps)
    out = y.to(x.dtype) @ params["out_proj"]
    return out, write_cache(cache, {"state": state, "conv": new_conv})


def _split_step(params: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: dict) -> torch.Tensor:
    """The decode step on each rank's local shards, one ``sharding.
    tp_block``, with the reference's layout over ``model``: ``in_proj``
    split by columns, the state (B, h, p, n) on ``p`` and the conv tail
    on its channels (``cache_specs``), ``out_proj`` by rows.  Three
    slicings of the channels meet here; what crosses ranks is one
    token's worth, never a weight or the state: the projection's columns
    (z, xBC and dt) gathered whole, the conv outputs of each rank's
    channels gathered whole (B and C among them), the state's output
    gathered over ``p`` for the gated norm (the ``rmsnorm_2d`` kernel on
    whole rows of ``di``), then ``out_proj``'s partial sums all-reduced
    once.  The state update and ``y`` are independent in ``p``."""
    mesh = cache["state"].device_mesh
    in_split = sharding.split_on_model(params["in_proj"])
    out_split = sharding.split_on_model(params["out_proj"])
    state, conv = cache["state"].to_local(), cache["conv"].to_local()
    p_lo = sharding.model_offset(cache["state"], 2)
    c_lo = sharding.model_offset(cache["conv"], 2)
    by_p = state.shape[2] != cfg.ssm_headdim
    by_ch = conv.shape[2] != cache["conv"].shape[2]

    def body(prm, h1):
        (proj,) = sharding.cols_on_model(h1, [prm["in_proj"]], [in_split],
                                         mesh)
        z, xbc, dt_raw = _split(proj, cfg)
        w = prm["conv_w"]
        ch = slice(c_lo, c_lo + conv.shape[2])
        xfull = torch.cat([conv.to(xbc.dtype), xbc[..., ch]], dim=1)
        conv_out = torch.einsum("bwc,wc->bc", xfull[:, -w.shape[0]:],
                                w[:, ch])
        xbc1 = F.silu(conv_out + prm["conv_b"][ch][None].to(conv_out.dtype))
        if w.shape[0] > 1:
            conv.copy_(xfull[:, 1:])
        if by_ch:
            xbc1 = sharding.gather_on_model(xbc1, -1, mesh)
        di, n, hh = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
        pp = state.shape[2]
        xs = xbc1[..., :di].reshape(-1, hh, cfg.ssm_headdim)[
            :, :, p_lo:p_lo + pp].float()
        b_in = xbc1[..., di:di + n].float()
        c_in = xbc1[..., di + n:].float()
        dt = F.softplus(dt_raw[:, 0].float() + prm["dt_bias"][None])
        a = -torch.exp(prm["A_log"])[None]
        decay = torch.exp(dt * a)
        new = state * decay[:, :, None, None] + \
            torch.einsum("bhp,bn,bh->bhpn", xs, b_in, dt)
        y = torch.einsum("bn,bhpn->bhp", c_in, new) + \
            prm["D"][None, :, None] * xs
        state.copy_(new)
        if by_p:
            y = sharding.gather_on_model(y, 2, mesh)
        y = y.reshape(-1, 1, di)
        y = k_rmsnorm(y * F.silu(z.float()), prm["norm_gain"],
                      eps=cfg.norm_eps)
        return sharding.rows_on_model(y.to(h1.dtype), prm["out_proj"],
                                      out_split, mesh)
    return sharding.tp_block(body, params, x, rows_like=cache["state"],
                             partial=True)

"""Plain PyTorch attention: the function of the ``flash_attention_3d``
kernel, the full-softmax oracle and the training path's differentiable
attention, ports of the JAX package's ``kernels/flash_attention/ref.py``
(``attention``, ``_expand_kv``, ``blockwise_attention``,
``banded_swa_attention``).

Layouts: ``flash_attention`` takes the kernel's q (BHq, S, D), k/v
(BHkv, T, D), with q row-block bh reading kv head bh // group; the
others take q (B, Hq, S, D), k/v (B, Hkv, T, D).  ``q_offset`` places
the queries in the sequence: qpos = q_offset + i, kpos = j.

Serving's plain path is ``flash_attention`` (the kernel's function).
Training differentiates ``autodiff_attention``, the JAX ``ref``
backend's choice between ``banded_swa_attention`` (O(S * 2W) scores for
a sliding window) and ``blockwise_attention`` (an online softmax over
KV blocks), which ``kernels.grad.FlashAttention`` also takes the vjp of
on the card.
"""
from __future__ import annotations

import torch

#: the TPU kernel's mask sentinel: finite, so a live tile whose keys are
#: all masked for a row gives exp(0) = 1 there, which the row's first
#: unmasked tile erases (corr = exp(-1e30 - m) = 0); -inf would give NaN
NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int | None, t_actual: int | None) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if t_actual is not None:
        m &= (kpos < t_actual)[None, :]
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _expand_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, Hkv, T, D) -> (B, Hkv*group, T, D): kv head h serves q heads
    h*group .. h*group + group - 1."""
    if group == 1:
        return x
    b, hkv, t, d = x.shape
    return x[:, :, None].expand(b, hkv, group, t, d).reshape(
        b, hkv * group, t, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """The kernel's function: q (BHq, S, D), k/v (BHkv, T, D) ->
    (BHq, S, D) in q's dtype.  q is widened to float32 and then scaled
    (the kernel's order; the oracle scales before the cast), scores and
    the value sum are float32, masked scores are ``NEG_INF``, and the
    denominator is floored at 1e-30.  One softmax over all T where the
    kernel runs an online one over its live tiles: the same function up
    to float32 rounding for every row with an unmasked key (a row with
    none is on no path: it averages the values here and the live tiles'
    values in the kernel)."""
    bhq, s, d = q.shape
    bhkv, t, _ = k.shape
    if bhq % bhkv:
        raise ValueError(f"q heads {bhq} are no multiple of kv heads {bhkv}")
    g = bhq // bhkv
    qf = (q.float() * scale).reshape(bhkv, g * s, d)
    logits = torch.matmul(qf, k.float().transpose(1, 2)).reshape(bhkv, g, s, t)
    qpos = q_offset + torch.arange(s, device=q.device)
    kpos = torch.arange(t, device=q.device)
    mask = _mask(qpos, kpos, causal, window, t)
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.matmul(p.reshape(bhkv, g * s, t), v.float())
    return (acc.reshape(bhkv, g, s, d) / l).reshape(bhq, s, d).to(q.dtype)


def attention(q, k, v, *, scale: float, causal: bool = True,
              window: int | None = None, q_offset: int = 0,
              t_actual: int | None = None) -> torch.Tensor:
    """Full-softmax oracle (O(S*T) memory; tests only): the scale folded
    into q in q's dtype, float32 scores, the probabilities cast to v's
    dtype before the float32 value sum, out in q's dtype."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    k = _expand_kv(k, hq // hkv)
    v = _expand_kv(v, hq // hkv)
    q = (q * scale).to(q.dtype)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    qpos = q_offset + torch.arange(s, device=q.device)
    kpos = torch.arange(t, device=q.device)
    logits = torch.where(_mask(qpos, kpos, causal, window, t_actual),
                         logits, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def banded_swa_attention(q, k, v, *, scale: float, window: int,
                         q_offset: int = 0) -> torch.Tensor:
    """Sliding-window causal self-attention as banded block attention:
    each ``window``-sized query block attends to its own and the previous
    key block, O(S * 2W) scores instead of O(S * T).  The queries stand
    at ``q_offset`` + i (0 <= ``q_offset`` < ``window``) and the keys run
    from position 0 to the last query, T == ``q_offset`` + S: the first
    query block's previous block holds the ``q_offset`` keys before it,
    zeros in front (from position 0, none).  q/k/v widened to float32 for
    the products (a bfloat16 product is exact in float32), the
    probabilities cast to v's dtype before the float32 value sum, out in
    q's dtype."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if t != q_offset + s or not 0 <= q_offset < window:
        raise ValueError(f"banded attention needs T == q_offset + S and "
                         f"q_offset below the window, got T {t}, S {s}, "
                         f"q_offset {q_offset}, window {window}")
    k = _expand_kv(k, hq // hkv)
    v = _expand_kv(v, hq // hkv)
    win = window
    pad = (-s) % win
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (q, k, v))
    nb = q.shape[2] // win
    from repro_torch.distributed.sharding import constrain
    own = (k[:, :, q_offset:], v[:, :, q_offset:]) if q_offset else (k, v)
    qb, kb, vb = (constrain(x.reshape(b, hq, nb, win, d), "batch", None,
                            "model", None, None) for x in (q, *own))
    zero = torch.zeros((b, hq, 1, win, d), dtype=k.dtype, device=k.device)
    if q_offset:    # the block before the first: the keys before it
        kfirst, vfirst = (torch.cat([zero[:, :, 0, q_offset:],
                                     x[:, :, :q_offset]], dim=2)[:, :, None]
                          for x in (k, v))
    else:
        kfirst = vfirst = zero
    kband = torch.cat([torch.cat([kfirst, kb[:, :, :-1]], dim=2), kb], dim=3)
    vband = torch.cat([torch.cat([vfirst, vb[:, :, :-1]], dim=2), vb], dim=3)
    logits = torch.matmul(qb.float(), kband.float().transpose(-1, -2)) \
        * scale                                          # (B,H,nb,win,2win)
    ii = torch.arange(win, device=q.device)
    jj = torch.arange(2 * win, device=q.device)
    mask = (jj[None, :] <= win + ii[:, None]) & (jj[None, :] > ii[:, None])
    first = jj[None, :] >= win - q_offset     # block 0: the keys it has
    mask = torch.where(torch.arange(nb, device=q.device)[:, None, None] == 0,
                       mask[None] & first[None], mask[None])
    if pad:   # padded keys at the tail must not be attended
        kpos = (torch.arange(nb, device=q.device)[:, None, None] - 1) * win \
            + jj[None, None, :]
        mask = mask & (kpos < s)
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.matmul(p.to(vband.dtype).float(), vband.float())
    return out.to(q.dtype).reshape(b, hq, nb * win, d)[:, :, :s]


def blockwise_attention(q, k, v, *, scale: float, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        block_kv: int = 1024,
                        t_actual: int | None = None) -> torch.Tensor:
    """An online softmax over KV blocks of ``block_kv`` keys: O(S *
    block_kv) live scores.  With T <= block_kv it is one direct softmax
    (``attention``); otherwise the keys are padded to whole blocks (the
    tail masked) and a loop over the blocks keeps the running max, sum
    and value accumulator in float32, q scaled in its own dtype first."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = hq // hkv
    if t <= block_kv:
        return attention(q, k, v, scale=scale, causal=causal, window=window,
                         q_offset=q_offset, t_actual=t_actual)
    if t % block_kv:   # pad KV to a block multiple; the tail is masked
        pad = block_kv - t % block_kv
        k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
        t_actual = t if t_actual is None else min(t, t_actual)
        t = k.shape[2]
    qpos = q_offset + torch.arange(s, device=q.device)
    qs = (q * scale).to(q.dtype).float()
    m = torch.full((b, hq, s, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    for ki in range(t // block_kv):
        sl = slice(ki * block_kv, (ki + 1) * block_kv)
        kblk = _expand_kv(k[:, :, sl], group)
        vblk = _expand_kv(v[:, :, sl], group)
        sc = torch.matmul(qs, kblk.float().transpose(-1, -2))
        kpos = ki * block_kv + torch.arange(block_kv, device=q.device)
        sc = torch.where(_mask(qpos, kpos, causal, window, t_actual), sc,
                         torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(vblk.dtype).float(),
                                        vblk.float())
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def autodiff_attention(q, k, v, *, scale: float, causal: bool = True,
                       window: int | None = None, q_offset: int = 0,
                       block_kv: int = 1024) -> torch.Tensor:
    """The training path's attention, the JAX ``ref`` backend's choice:
    ``banded_swa_attention`` for causal sliding-window self-attention
    from position 0 (S > 1, T == S, window < S, window a multiple of
    128) -- and, on a rank of the sequence split, of a query block whose
    keys start ``q_offset`` < ``window`` positions before it (T ==
    ``q_offset`` + S) --, else ``blockwise_attention`` with ``block_kv``."""
    s = q.shape[2]
    if (causal and window is not None and 0 <= q_offset < window and s > 1
            and k.shape[2] == q_offset + s and window < s
            and window % 128 == 0):
        return banded_swa_attention(q, k, v, scale=scale, window=window,
                                    q_offset=q_offset)
    return blockwise_attention(q, k, v, scale=scale, causal=causal,
                               window=window, q_offset=q_offset,
                               block_kv=block_kv)

"""Plain PyTorch attention: the function of the ``flash_attention_3d``
kernel and the full-softmax oracle, ports of the JAX package's
``kernels/flash_attention/ref.py`` (``attention``, ``_expand_kv``).

Layouts: ``flash_attention`` takes the kernel's q (BHq, S, D), k/v
(BHkv, T, D), with q row-block bh reading kv head bh // group;
``attention`` takes q (B, Hq, S, D), k/v (B, Hkv, T, D).  ``q_offset``
places the queries in the sequence: qpos = q_offset + i, kpos = j.
The JAX ``ref`` backend's training-path variants
(``blockwise_attention``, ``banded_swa_attention``) are not ported yet:
serving runs the kernel's function.
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

"""Operations and bytes that a cell's work needs, from its shapes alone.

A kernel's bound is the larger of its operations over the peak rate and
its bytes over the memory bandwidth (``peaks.json``); each input byte is
counted once read and each output byte once written.  The counts read the
same work whatever implements it: attention counts the live (causal,
windowed) query-key pairs, the SSD's intra-chunk term the causal pairs of
each chunk.
"""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(kind: str) -> dict | None:
    """The datasheet peaks of a device by its name, None if unlisted."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)["devices"].get(kind)


def live_pairs(s: int, t: int | None = None, *, causal: bool = True,
               window: int | None = None, q_offset: int = 0) -> int:
    """Query-key pairs a query row block attends: queries at q_offset ..
    q_offset + s - 1 against keys 0 .. t - 1, causal and windowed."""
    t = s + q_offset if t is None else t
    total = 0
    for i in range(s):
        q = q_offset + i
        hi = min(q, t - 1) if causal else t - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_ops(bhq: int, pairs: int, d: int) -> float:
    """Two products of 2 * d operations a live pair, each query head."""
    return 4.0 * d * pairs * bhq


def flash_bytes(b: int, hq: int, hkv: int, s: int, t: int, d: int,
                itemsize: int = 2) -> float:
    """q and the output (B, Hq, S, D), k and v (B, Hkv, T, D)."""
    return float(itemsize * d * (2 * b * hq * s + 2 * b * hkv * t))


def flash_bound_s(dev: dict, *, b: int, hq: int, hkv: int, s: int, d: int,
                  window: int | None) -> float:
    """The least time of one causal self-attention launch."""
    ops = flash_ops(b * hq, live_pairs(s, window=window), d)
    return max(ops / dev["bf16_flops"],
               flash_bytes(b, hq, hkv, s, s, d) / dev["hbm_bytes_per_s"])


def ssd_ops(bc: int, lc: int, h: int, p: int, n: int) -> float:
    """C B^T over the causal pairs (2 n), the masked product with x dt
    (2 h p), and the chunk states (2 lc h p n), each chunk."""
    pairs = lc * (lc + 1) // 2
    return float(bc * (2 * n * pairs + 2 * h * p * pairs + 2 * lc * h * p * n))


def ssd_bytes(bc: int, lc: int, h: int, p: int, n: int,
              itemsize: int = 2) -> float:
    """x dt (bc, lc, h, p), B and C (bc, lc, n) in the input dtype; the
    cumulative decays (bc, lc, h), y (bc, lc, h, p) and the chunk states
    (bc, h, p, n) in float32."""
    inputs = itemsize * bc * lc * (h * p + 2 * n) + 4 * bc * lc * h
    outputs = 4 * bc * lc * h * p + 4 * bc * h * p * n
    return float(inputs + outputs)


def ssd_bound_s(dev: dict, *, bc: int, lc: int, h: int, p: int,
                n: int) -> float:
    """The least time of one ``ssd_intra`` launch."""
    return max(ssd_ops(bc, lc, h, p, n) / dev["bf16_flops"],
               ssd_bytes(bc, lc, h, p, n) / dev["hbm_bytes_per_s"])


def flash_launch_s(dev: dict, m: dict, rows: int, seq: int) -> float:
    """The least time of one self-attention launch of configuration ``m``
    over ``rows`` sequences of ``seq`` positions."""
    hd = m.get("d_head") or m["d_model"] // m["n_heads"]
    return flash_bound_s(dev, b=rows, hq=m["n_heads"], hkv=m["n_kv_heads"],
                         s=seq, d=hd, window=m.get("window"))


def ssd_launch_s(dev: dict, m: dict, rows: int, seq: int) -> float | None:
    """The least time of one ``ssd_intra`` launch of configuration ``m``
    over ``rows`` sequences of ``seq`` positions; None without an SSM."""
    if m["family"] != "hybrid":
        return None
    lc = m.get("ssm_chunk", 256)
    di = m.get("ssm_expand", 2) * m["d_model"]
    p = m.get("ssm_headdim", 64)
    return ssd_bound_s(dev, bc=rows * -(-seq // lc), lc=lc, h=di // p, p=p,
                       n=m["ssm_state"])


def layer_params(m: dict) -> tuple[int, int]:
    """(parameters a token multiplies in one layer's dense products,
    of which expert parameters): attention, the SSM's projections, the
    MLP or the k active experts and the router."""
    d = m["d_model"]
    hd = m.get("d_head") or d // m["n_heads"]
    n = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    if m["family"] == "hybrid":
        di = m.get("ssm_expand", 2) * d
        ns = m["ssm_state"]
        n += d * (2 * di + 2 * ns + di // m.get("ssm_headdim", 64)) + di * d
    ff = 3 * d * m["d_ff"]
    if m.get("n_experts"):
        return n + d * m["n_experts"] + m["experts_per_token"] * ff, \
            m["experts_per_token"] * ff
    return n + ff, 0


def ssm_token_ops(m: dict) -> float:
    """A token's state update and read-out, each SSM layer: the decay and
    the outer product into (h, p, n), and C against the state."""
    if m["family"] != "hybrid":
        return 0.0
    di = m.get("ssm_expand", 2) * m["d_model"]
    return 6.0 * di * m["ssm_state"]


def forward_flops(m: dict, *, tokens: int, pairs_per_head: int,
                  head_rows: int) -> float:
    """One forward pass's model FLOPs: 2 per parameter a token in every
    layer, the SSM's recurrence, attention over the live pairs (4 d a
    pair a query head a layer) and the head's 2 V d a logits row."""
    hd = m.get("d_head") or m["d_model"] // m["n_heads"]
    per_token = 2.0 * layer_params(m)[0] + ssm_token_ops(m)
    attn = 4.0 * hd * pairs_per_head * m["n_heads"]
    head = 2.0 * m["vocab_size"] * m["d_model"] * head_rows
    return m["n_layers"] * (per_token * tokens + attn) + head


def serve_flops(m: dict, b: int, s: int, g: int) -> float:
    """The model FLOPs of one served batch: the prompts (B, S) once, the
    G - 1 served tokens fed back, and G logits rows a sequence."""
    w = m.get("window")
    pairs = live_pairs(s, window=w)
    for q in range(s, s + g - 1):
        pairs += min(q + 1, w) if w else q + 1
    return forward_flops(m, tokens=b * (s + g - 1), pairs_per_head=b * pairs,
                         head_rows=b * g)


def train_flops(m: dict, rows: int, seq: int) -> float:
    """The model FLOPs of one training step over rows x seq tokens:
    3 times the forward (its backward is twice it), every position's
    logits; recomputation is not counted."""
    pairs = rows * live_pairs(seq, window=m.get("window"))
    return 3.0 * forward_flops(m, tokens=rows * seq, pairs_per_head=pairs,
                               head_rows=rows * seq)

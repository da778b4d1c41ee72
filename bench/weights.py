"""Random weights for a decoder-only configuration, made from the seed.

The benchmark makes the weights itself and hands the same tensors to the
program under test and to the plain reference.  The layout is the one
``repro_torch``'s models read (a dict with ``embed``, ``final_norm``,
``unembed`` when untied, and ``layers``, a list of one dict a layer); the
values are the benchmark's own: one ``torch.randn`` call over all the
leaves of the activation dtype and one over the float32 leaves, on the
generator's device, each leaf a view scaled in place.

Scales follow the usual fan-in rule (std ``fan_in ** -0.5``); the
embedding tables take the usual initializer range, std 0.02, so that with
tied embeddings the logits are not the input token's self-similarity
(a standard normal table makes a random model repeat its last token,
whatever its layers compute); norm gains, the SSM's ``D``, ``dt_bias`` and
``A_log`` are drawn around their usual constants so that a reader who
ignores one of them is seen.
"""
from __future__ import annotations

import math

import torch

#: std of the embedding tables
EMBED_STD = 0.02


def leaf_specs(m: dict) -> list:
    """(path, shape, kind, scale) of every leaf of a decoder-only model
    of configuration ``m`` (the ``model`` object of a configuration
    file).  kind: "w" (activation dtype, normal times scale), "gain"
    (float32, 1 + scale * normal), "f32" (float32, normal times scale),
    "alog" (float32, log(1..16) plus a small normal), "zero_ish"
    (float32, scale * normal)."""
    d, v = m["d_model"], m["vocab_size"]
    hd = m.get("d_head") or d // m["n_heads"]
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    specs = [(("embed",), (v, d), "w", EMBED_STD),
             (("final_norm",), (d,), "gain", 0.1)]
    if not m.get("tie_embeddings", False):
        specs.append((("unembed",), (v, d), "w", EMBED_STD))
    for i in range(m["n_layers"]):
        lay = ("layers", i)
        specs += [(lay + ("attn_norm",), (d,), "gain", 0.1),
                  (lay + ("attn", "wq"), (d, hq * hd), "w", d ** -0.5),
                  (lay + ("attn", "wk"), (d, hkv * hd), "w", d ** -0.5),
                  (lay + ("attn", "wv"), (d, hkv * hd), "w", d ** -0.5),
                  (lay + ("attn", "wo"), (hq * hd, d), "w",
                   (hq * hd) ** -0.5)]
        if m["family"] == "hybrid":
            di = m.get("ssm_expand", 2) * d
            n = m["ssm_state"]
            h = di // m.get("ssm_headdim", 64)
            w = m.get("ssm_conv_width", 4)
            specs += [
                (lay + ("ssm", "in_proj"), (d, 2 * di + 2 * n + h), "w",
                 d ** -0.5),
                (lay + ("ssm", "conv_w"), (w, di + 2 * n), "w", w ** -0.5),
                (lay + ("ssm", "conv_b"), (di + 2 * n,), "zero_ish", 0.1),
                (lay + ("ssm", "A_log"), (h,), "alog", 0.1),
                (lay + ("ssm", "D"), (h,), "gain", 0.1),
                (lay + ("ssm", "dt_bias"), (h,), "zero_ish", 0.1),
                (lay + ("ssm", "norm_gain"), (di,), "gain", 0.1),
                (lay + ("ssm", "out_proj"), (di, d), "w", di ** -0.5),
                (lay + ("attn_gain",), (d,), "gain", 0.1),
                (lay + ("ssm_gain",), (d,), "gain", 0.1)]
        ff = m["d_ff"]
        specs.append((lay + ("mlp_norm",), (d,), "gain", 0.1))
        if m.get("n_experts"):
            e = m["n_experts"]
            specs += [(lay + ("moe", "router"), (d, e), "f32", d ** -0.5),
                      (lay + ("moe", "w_gate"), (e, d, ff), "w", d ** -0.5),
                      (lay + ("moe", "w_up"), (e, d, ff), "w", d ** -0.5),
                      (lay + ("moe", "w_down"), (e, ff, d), "w", ff ** -0.5)]
        else:
            specs += [(lay + ("mlp", "w_gate"), (d, ff), "w", d ** -0.5),
                      (lay + ("mlp", "w_up"), (d, ff), "w", d ** -0.5),
                      (lay + ("mlp", "w_down"), (ff, d), "w", ff ** -0.5)]
    return specs


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def make(m: dict, seed: int, device) -> dict:
    """The parameters of configuration ``m`` from ``seed`` on ``device``:
    two ``randn`` calls, one in the activation dtype for the weights and
    one in float32 for the rest."""
    dtype = getattr(torch, m.get("dtype", "bfloat16"))
    specs = leaf_specs(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {"w": 0, "f": 0}
    for _, shape, kind, _ in specs:
        sizes["w" if kind == "w" else "f"] += math.prod(shape)
    wbuf = torch.randn(sizes["w"], generator=gen, dtype=dtype, device=device)
    fbuf = torch.randn(sizes["f"], generator=gen, dtype=torch.float32,
                       device=device)
    at = {"w": 0, "f": 0}
    params: dict = {}
    with torch.no_grad():
        for path, shape, kind, scale in specs:
            key = "w" if kind == "w" else "f"
            n = math.prod(shape)
            t = (wbuf if key == "w" else fbuf)[at[key]:at[key] + n].view(shape)
            at[key] += n
            if kind in ("w", "f32", "zero_ish"):
                t.mul_(scale)
            elif kind == "gain":
                t.mul_(scale).add_(1.0)
            elif kind == "alog":
                base = torch.log(torch.linspace(1.0, 16.0, shape[0],
                                                device=device))
                t.mul_(scale).add_(base)
            _put(params, path, t)
    return params


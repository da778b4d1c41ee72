"""Frozen copies of what ``repro_torch.launch.train.train_loop`` draws from
its seed, so the reference works the same inputs out again by itself.

``init_params`` draws the parameters in the order and at the scales of the
port's ``Model.init`` (one ``torch.randn`` a weight, in float32, scaled and
rounded to the activation dtype; norm gains and the SSM's constants made,
not drawn), keyed by their path in the parameter tree.  ``global_batch``
is the port's ``SyntheticLMData`` generator: a Zipf stream with a Markov
continuation, a pure function of (seed, step).  A test holds both against
the port on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def _layer_specs(m: dict, prefix: tuple) -> list:
    """(path, shape, scale or a constant's name) of one decoder layer, in
    the order ``blocks.init`` makes them."""
    d = m["d_model"]
    hd = m.get("d_head") or d // m["n_heads"]
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    out = [(prefix + ("attn_norm",), (d,), "ones"),
           (prefix + ("attn", "wq"), (d, hq * hd), d ** -0.5),
           (prefix + ("attn", "wk"), (d, hkv * hd), d ** -0.5),
           (prefix + ("attn", "wv"), (d, hkv * hd), d ** -0.5),
           (prefix + ("attn", "wo"), (hq * hd, d), (hq * hd) ** -0.5)]
    if m["family"] == "hybrid":
        di = m.get("ssm_expand", 2) * d
        n = m["ssm_state"]
        h = di // m.get("ssm_headdim", 64)
        w = m.get("ssm_conv_width", 4)
        s = prefix + ("ssm",)
        out += [(s + ("in_proj",), (d, 2 * di + 2 * n + h), d ** -0.5),
                (s + ("conv_w",), (w, di + 2 * n), w ** -0.5),
                (s + ("conv_b",), (di + 2 * n,), "zeros"),
                (s + ("A_log",), (h,), "alog"),
                (s + ("D",), (h,), "ones"),
                (s + ("dt_bias",), (h,), "zeros"),
                (s + ("norm_gain",), (di,), "ones"),
                (s + ("out_proj",), (di, d), di ** -0.5),
                (prefix + ("attn_gain",), (d,), "ones"),
                (prefix + ("ssm_gain",), (d,), "ones")]
    ff = m["d_ff"]
    out.append((prefix + ("mlp_norm",), (d,), "ones"))
    if m.get("n_experts"):
        e = m["n_experts"]
        out += [(prefix + ("moe", "router"), (d, e), ("f32", d ** -0.5)),
                (prefix + ("moe", "w_gate"), (e, d, ff), d ** -0.5),
                (prefix + ("moe", "w_up"), (e, d, ff), d ** -0.5),
                (prefix + ("moe", "w_down"), (e, ff, d), ff ** -0.5)]
    else:
        out += [(prefix + ("mlp", "w_gate"), (d, ff), d ** -0.5),
                (prefix + ("mlp", "w_up"), (d, ff), d ** -0.5),
                (prefix + ("mlp", "w_down"), (ff, d), ff ** -0.5)]
    return out


def param_specs(m: dict) -> list:
    """Every leaf of a decoder-only model in ``Model.init``'s order."""
    d, v = m["d_model"], m["vocab_size"]
    out = [(("embed",), (v, d), 1.0), (("final_norm",), (d,), "ones")]
    if not m.get("tie_embeddings", False):
        out.append((("unembed",), (v, d), 1.0))
    for i in range(m["n_layers"]):
        out += _layer_specs(m, ("layers", i))
    return out


def stored_low(how) -> bool:
    """Whether a leaf of ``param_specs`` is stored in the activation dtype
    (a drawn weight) rather than float32 (gains, constants, the router)."""
    return not isinstance(how, (str, tuple))


def init_params(m: dict, seed: int, device, dtype=None):
    """Yield (path, tensor) of the initial parameters from ``seed``, one
    leaf at a time (float32 unless ``dtype`` is given: the activation
    dtype's values, widened)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    act = getattr(torch, m.get("dtype", "bfloat16"))
    for path, shape, how in param_specs(m):
        if how == "ones":
            t = torch.ones(shape, device=device)
        elif how == "zeros":
            t = torch.zeros(shape, device=device)
        elif how == "alog":
            t = torch.log(torch.linspace(1.0, 16.0, shape[0], device=device))
        else:
            f32 = isinstance(how, tuple)
            scale = how[1] if f32 else how
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale
            if not f32:
                t = t.to(act).float()
        yield path, (t if dtype is None else t.to(dtype))


def global_batch(vocab: int, seq_len: int, rows: int, seed: int,
                 step: int) -> dict:
    """``tokens`` and ``labels`` (rows, seq_len) int32 of one step."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    base = rng.zipf(1.3, size=(rows, seq_len + 1))
    base = (base - 1) % vocab
    coin = rng.random((rows, seq_len)) < 0.5
    tokens = np.empty_like(base)
    tokens[:, 0] = base[:, 0]
    for t in range(seq_len):
        tokens[:, t + 1] = np.where(coin[:, t], (tokens[:, t] * 31 + 7)
                                    % vocab, base[:, t + 1])
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}

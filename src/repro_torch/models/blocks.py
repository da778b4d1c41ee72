"""Residual blocks of the dense, MoE, SSM and hybrid families, the port of
the JAX package's ``models/blocks.py`` (its serving half: ``init``,
``init_cache``, ``prefill``, ``decode``).

One layer's cache, per family:

  dense/moe : the attention cache dict (k, v, kpos)
  ssm       : {state, conv}
  hybrid    : {"attn": ..., "ssm": ...}

A hybrid layer runs, in prefill: the attention norm (``rmsnorm_2d``),
attention (``rope_3d`` on q and k, ``flash_attention_3d``) and the SSM
branch (``ssd_intra``, its gated norm) on the same normed input, a norm
of each branch by its gain, their mean as the residual delta
(``vecadd_2d``), then the MLP norm, the SwiGLU MLP and a second residual
add.  A dense or MoE layer is the attention norm, attention, a residual
add, the MLP norm, then the SwiGLU MLP -- or, when the config sets
experts, the top-k MoE FFN (``moe.moe_ffn``), whose ``aux`` term
``_ffn`` returns and serving ignores, as in the reference -- and a
second residual add.  The encoder-decoder blocks, and full-sequence
``apply`` (training), come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, mlp_init, residual_add, rmsnorm


def init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """One decoder layer's parameters; norm gains are float32 ones."""
    d = cfg.d_model
    dev = generator.device

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    p = {}
    if cfg.family == "ssm":
        p["ssm_norm"] = ones()
        p["ssm"] = ssm_mod.init(generator, cfg, dtype)
        return p
    p["attn_norm"] = ones()
    p["attn"] = attn.init(generator, cfg, dtype)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.init(generator, cfg, dtype)
        p["attn_gain"] = ones()
        p["ssm_gain"] = ones()
    if cfg.d_ff:
        p["mlp_norm"] = ones()
        if cfg.n_experts:
            p["moe"] = moe_mod.init(generator, cfg, dtype)
        else:
            p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The channel mixer: (delta, aux), delta None without one; aux is
    the MoE load-balance term (0.0 for the SwiGLU MLP)."""
    if not cfg.d_ff:
        return None, 0.0
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts:
        return moe_mod.moe_ffn(p["moe"], h, cfg)
    return mlp(p["mlp"], h), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device):
    """One layer's empty cache for ``batch`` sequences of ``max_len``."""
    if cfg.family == "ssm":
        return ssm_mod.init_cache(cfg, batch, device)
    c = attn.init_cache(attn.cache_spec(cfg, batch, max_len), device)
    if cfg.family == "hybrid":
        return {"attn": c, "ssm": ssm_mod.init_cache(cfg, batch, device)}
    return c


def _hybrid_delta(p: dict, a: torch.Tensor, s: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    return 0.5 * (rmsnorm(a, p["attn_gain"], cfg.norm_eps)
                  + rmsnorm(s, p["ssm_gain"], cfg.norm_eps))


def prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, cache, *,
            start: int = 0):
    """Prompt pass filling the cache.  Returns (x, new_cache)."""
    if cfg.family == "ssm":
        h = rmsnorm(x, p["ssm_norm"], cfg.norm_eps)
        delta, new_cache = ssm_mod.forward(p["ssm"], h, cfg,
                                           conv_tail=cache["conv"],
                                           return_state=True)
        return residual_add(x, delta.to(x.dtype)), new_cache
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.family == "hybrid":
        a, attn_cache = attn.prefill(p["attn"], h, cfg, cache["attn"],
                                     start=start)
        s, ssm_cache = ssm_mod.forward(p["ssm"], h, cfg,
                                       conv_tail=cache["ssm"]["conv"],
                                       return_state=True)
        x = residual_add(x, _hybrid_delta(p, a, s, cfg).to(x.dtype))
        new_cache = {"attn": attn_cache, "ssm": ssm_cache}
    else:
        a, new_cache = attn.prefill(p["attn"], h, cfg, cache, start=start)
        x = residual_add(x, a.to(x.dtype))
    delta, _ = _ffn(p, x, cfg)
    if delta is not None:
        x = residual_add(x, delta.to(x.dtype))
    return x, new_cache


def decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache, pos: int):
    """One-token step.  Returns (x, new_cache)."""
    if cfg.family == "ssm":
        h = rmsnorm(x, p["ssm_norm"], cfg.norm_eps)
        delta, new_cache = ssm_mod.decode_step(p["ssm"], h, cfg, cache)
        return residual_add(x, delta.to(x.dtype)), new_cache
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.family == "hybrid":
        a, attn_cache = attn.decode_step(p["attn"], h, cfg, cache["attn"], pos)
        s, ssm_cache = ssm_mod.decode_step(p["ssm"], h, cfg, cache["ssm"])
        x = residual_add(x, _hybrid_delta(p, a, s, cfg).to(x.dtype))
        new_cache = {"attn": attn_cache, "ssm": ssm_cache}
    else:
        a, new_cache = attn.decode_step(p["attn"], h, cfg, cache, pos)
        x = residual_add(x, a.to(x.dtype))
    delta, _ = _ffn(p, x, cfg)
    if delta is not None:
        x = residual_add(x, delta.to(x.dtype))
    return x, new_cache

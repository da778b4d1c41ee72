"""Residual blocks of every family, the port of the JAX package's
``models/blocks.py`` (``init``, ``apply``, ``init_cache``, ``prefill``,
``decode``).

One layer's cache, per family:

  dense/moe/vlm : the attention cache dict (k, v, kpos; an int8 cache
                  adds kscale, vscale)
  ssm           : {state, conv}
  hybrid        : {"attn": ..., "ssm": ...}
  encdec dec    : {"self": attention cache, "cross": {k, v}}

A hybrid layer runs, in prefill: the attention norm (``rmsnorm_2d``),
attention (``rope_3d`` on q and k, ``flash_attention_3d``) and the SSM
branch (``ssd_intra``, its gated norm) on the same normed input, a norm
of each branch by its gain, their mean as the residual delta
(``vecadd_2d``), then the MLP norm, the SwiGLU MLP and a second residual
add.  A dense, MoE or VLM layer is the attention norm, attention, a
residual add, the MLP norm, then the SwiGLU MLP -- or, when the config
sets experts, the top-k MoE FFN (``moe.moe_ffn``), whose ``aux`` term
``_ffn`` returns and serving ignores, as in the reference -- and a
second residual add.  An enc-dec decoder layer (``role=
"encdec_decoder"``) puts cross-attention between the two: the cross norm,
``cross_attend`` against the encoder's keys and values (``encode_kv``
in prefill, the cache's ``cross`` in decode) and a third residual add.
``apply`` is the full-sequence block without a cache, the training
forward's (and the encoder's, ``role="encoder"``, without a causal
mask): the same mixers as prefill for every family -- an SSM layer's
norm and SSD mixer, a hybrid layer's two branches and their
``0.5 * (norm + norm)`` delta -- and, given ``cross_kv`` (``encode_kv``
of the encoder output), the enc-dec decoder's cross-attention.

``for_use`` readies a layer's parameters on a mesh: the sub-blocks that
split over ``model`` as the reference's specs lay them out keep their
``model`` shards (``sharding.gathered(keep_model=True)``) -- attention
under each layout of ``sharding.attn_layout`` (by heads where ``model``
divides both head counts; by query heads and their kv group where it
divides the query heads, yi-6b's 32/4 on 8; by the sequence where it
does not, hymba's 25/5 heads), the SwiGLU MLP where it divides ``d_ff``
(the leaves' sanitized specs), the MoE experts, and in a decode step
the SSM's ``in_proj``/``out_proj`` (``ssm.decode_step`` splits its
state on the head dim) -- and the rest come whole: the full-sequence
SSM, which splits the sequence instead.  A batch the fsdp axes do not
divide (a batch-1 decode) keeps attention's, the MLP's and the decode
step's SSM's fsdp shards as well: the fsdp axes split their
contractions, as XLA splits the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, mlp_init, residual_add, rmsnorm
from repro_torch.obs import steps


def init(generator: torch.Generator, cfg: ModelConfig, dtype,
         role: str = "decoder") -> dict:
    """One layer's parameters; norm gains are float32 ones.  role:
    decoder | encoder | encdec_decoder (adds ``cross_norm``, ``cross``)."""
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
    if role == "encdec_decoder":
        p["cross_norm"] = ones()
        p["cross"] = attn.init(generator, cfg, dtype)
    if cfg.d_ff:
        p["mlp_norm"] = ones()
        if cfg.n_experts:
            p["moe"] = moe_mod.init(generator, cfg, dtype)
        else:
            p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def for_use(p: dict, cfg: ModelConfig, x=None, *,
            decode: bool = False) -> dict:
    """One layer's parameters gathered for use under the ambient mesh,
    fed ``x``: attention under every layout of ``sharding.attn_layout``
    (cross-attention where ``model`` divides its heads), the MLP, the
    MoE experts and, in a ``decode`` step, the SSM over the fsdp axes
    only, keeping their ``model`` shards; the rest whole.  Where the
    fsdp axes split the contractions instead of x's batch
    (``sharding.contraction_split``), attention, the MLP and the decode
    step's SSM keep their fsdp shards too.  Plain tensors come back as
    they are."""
    width = sharding.model_width()
    heads = width == 1 or sharding.attn_layout(cfg, width) == "heads"
    split = ("mlp", "moe", "attn") + (("cross",) if heads else ()) \
        + (("ssm",) if decode else ())
    fsdp = ("mlp", "attn") + (("cross",) if heads else ()) \
        + (("ssm",) if decode else ()) \
        if sharding.contraction_split(x) else ()
    return {k: sharding.gathered(v, keep_model=k in split,
                                 keep_fsdp=k in fsdp) for k, v in p.items()}


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The channel mixer: (delta, aux), delta None without one; aux is
    the MoE load-balance term (0.0 for the SwiGLU MLP)."""
    if not cfg.d_ff:
        return None, 0.0
    h = _norm(x, p["mlp_norm"], cfg)
    with steps.region("ffn"):
        if cfg.n_experts:
            return moe_mod.moe_ffn(p["moe"], h, cfg)
        return mlp(p["mlp"], h), 0.0


def _norm(x: torch.Tensor, gain: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """A sub-block's pre-norm, the ``norm`` span of a layer."""
    with steps.region("norm"):
        return rmsnorm(x, gain, cfg.norm_eps)


def _hybrid_delta(p: dict, a: torch.Tensor, s: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    return 0.5 * (rmsnorm(a, p["attn_gain"], cfg.norm_eps)
                  + rmsnorm(s, p["ssm_gain"], cfg.norm_eps))


def _mixer_full(p: dict, x: torch.Tensor, cfg: ModelConfig,
                causal: bool) -> torch.Tensor:
    """The token mixer over the full sequence: the residual delta."""
    if cfg.family == "ssm":
        return ssm_mod.forward(p["ssm"], rmsnorm(x, p["ssm_norm"],
                                                 cfg.norm_eps), cfg)
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    a = attn.attend(p["attn"], h, cfg, causal=causal)
    if cfg.family == "hybrid":
        return _hybrid_delta(p, a, ssm_mod.forward(p["ssm"], h, cfg), cfg)
    return a


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
          cross_kv: dict | None = None):
    """The full-sequence block without a cache (training and the enc-dec
    encoder): the mixer's residual add, the cross-attention's when
    ``cross_kv`` is given, the FFN's.  (x, aux) out, aux the MoE
    load-balance term (0.0 without experts)."""
    x = constrain(residual_add(x, _mixer_full(p, x, cfg, causal).to(x.dtype)),
                  "batch", None, None)
    if cross_kv is not None:
        h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
        x = residual_add(x, attn.cross_attend(p["cross"], h, cross_kv,
                                              cfg).to(x.dtype))
    delta, aux = _ffn(p, x, cfg)
    if delta is not None:
        x = constrain(residual_add(x, delta.to(x.dtype)), "batch", None, None)
    return x, aux


# ---------------------------------------------------------------------------
# cached paths
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               role: str = "decoder", enc_len: int = 0, *,
               device: torch.device):
    """One layer's empty cache for ``batch`` sequences of ``max_len``; an
    enc-dec decoder layer's adds the cross keys and values of ``enc_len``
    encoder positions, zeroed until prefill writes them."""
    if cfg.family == "ssm":
        return ssm_mod.init_cache(cfg, batch, device)
    c = attn.init_cache(attn.cache_spec(cfg, batch, max_len), device)
    if cfg.family == "hybrid":
        return {"attn": c, "ssm": ssm_mod.init_cache(cfg, batch, device)}
    if role == "encdec_decoder":
        shape = (batch, cfg.n_kv_heads, enc_len, cfg.head_dim)
        return {"self": c, "cross": {
            name: torch.zeros(shape, dtype=cfg.activation_dtype,
                              device=device) for name in ("k", "v")}}
    return c


def _write_cross(cache: dict, kv: dict, cfg: ModelConfig) -> None:
    """Store ``encode_kv``'s keys and values, in the activation dtype, in
    the cross cache in place."""
    for name, val in kv.items():
        if cache[name].shape != val.shape:
            raise ValueError(f"the cross cache holds {tuple(cache[name].shape)}"
                             f" but the encoder gave {tuple(val.shape)}: "
                             "init_cache's enc_len must be the encoder's "
                             "length")
        cache[name].copy_(val.to(cfg.activation_dtype))


def prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, cache, *,
            start: int = 0, enc_out: torch.Tensor | None = None):
    """Prompt pass filling the cache in place (an enc-dec decoder layer's
    against the encoder output ``enc_out``).  Returns (x, the cache)."""
    if cfg.family == "ssm":
        h = _norm(x, p["ssm_norm"], cfg)
        with steps.region("ssm"):
            delta, new_cache = ssm_mod.forward(p["ssm"], h, cfg,
                                               conv_tail=cache["conv"],
                                               return_state=True)
            new_cache = ssm_mod.write_cache(cache, new_cache)
        return residual_add(x, delta.to(x.dtype)), new_cache
    h = _norm(x, p["attn_norm"], cfg)
    if cfg.family == "hybrid":
        a, attn_cache = attn.prefill(p["attn"], h, cfg, cache["attn"],
                                     start=start)
        with steps.region("ssm"):
            s, ssm_cache = ssm_mod.forward(p["ssm"], h, cfg,
                                           conv_tail=cache["ssm"]["conv"],
                                           return_state=True)
            ssm_cache = ssm_mod.write_cache(cache["ssm"], ssm_cache)
        x = residual_add(x, _hybrid_delta(p, a, s, cfg).to(x.dtype))
        new_cache = {"attn": attn_cache, "ssm": ssm_cache}
    elif "cross" in p:
        a, self_cache = attn.prefill(p["attn"], h, cfg, cache["self"],
                                     start=start)
        x = residual_add(x, a.to(x.dtype))
        if enc_out is None:
            raise ValueError("an enc-dec decoder layer needs enc_out")
        h = _norm(x, p["cross_norm"], cfg)
        with steps.region("cross_attention"):
            cross_kv = attn.encode_kv(p["cross"], enc_out, cfg)
            a = attn.cross_attend(p["cross"], h, cross_kv, cfg)
            _write_cross(cache["cross"], cross_kv, cfg)
        x = residual_add(x, a.to(x.dtype))
        new_cache = {"self": self_cache, "cross": cache["cross"]}
    else:
        a, new_cache = attn.prefill(p["attn"], h, cfg, cache, start=start)
        x = residual_add(x, a.to(x.dtype))
    delta, _ = _ffn(p, x, cfg)
    if delta is not None:
        x = residual_add(x, delta.to(x.dtype))
    return x, new_cache


def decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache, pos):
    """One-token step at ``pos`` (an int or a 0-d int64 tensor on x's
    device), the cache written in place.  Returns (x, the cache)."""
    if cfg.family == "ssm":
        h = _norm(x, p["ssm_norm"], cfg)
        with steps.region("ssm"):
            delta, new_cache = ssm_mod.decode_step(p["ssm"], h, cfg, cache)
        return residual_add(x, delta.to(x.dtype)), new_cache
    h = _norm(x, p["attn_norm"], cfg)
    if cfg.family == "hybrid":
        a, attn_cache = attn.decode_step(p["attn"], h, cfg, cache["attn"], pos)
        with steps.region("ssm"):
            s, ssm_cache = ssm_mod.decode_step(p["ssm"], h, cfg, cache["ssm"])
        x = residual_add(x, _hybrid_delta(p, a, s, cfg).to(x.dtype))
        new_cache = {"attn": attn_cache, "ssm": ssm_cache}
    elif "cross" in p:
        a, self_cache = attn.decode_step(p["attn"], h, cfg, cache["self"],
                                         pos)
        x = residual_add(x, a.to(x.dtype))
        h = _norm(x, p["cross_norm"], cfg)
        with steps.region("cross_attention"):
            a = attn.cross_attend(p["cross"], h, cache["cross"], cfg)
        x = residual_add(x, a.to(x.dtype))
        new_cache = {"self": self_cache, "cross": cache["cross"]}
    else:
        a, new_cache = attn.decode_step(p["attn"], h, cfg, cache, pos)
        x = residual_add(x, a.to(x.dtype))
    delta, _ = _ffn(p, x, cfg)
    if delta is not None:
        x = residual_add(x, delta.to(x.dtype))
    return x, new_cache

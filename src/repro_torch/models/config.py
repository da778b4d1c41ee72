"""Unified model configuration covering all assigned architecture families.

A copy of the JAX package's ``models/config.py``: one frozen dataclass
drives dense / MoE / SSM / hybrid / enc-dec / VLM builds;
``repro_torch/configs/<arch>.py`` instantiates the exact assigned configs
and ``reduced()`` derives the CPU smoke-test variants.  The one change:
``activation_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: its family, widths, depth and numerics."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # -- attention ----------------------------------------------------------
    window: Optional[int] = None     # sliding-window size (SWA)
    rope_theta: float = 10000.0
    pos_embed: str = "rope"          # rope | sinusoidal (whisper)
    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # -- SSM (mamba-2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # -- enc-dec / frontend stubs ----------------------------------------------
    encoder_layers: int = 0          # > 0 -> encoder-decoder
    frontend: Optional[str] = None   # audio | vision (stub: precomputed embeds)
    n_frontend_tokens: int = 0       # vision: patch tokens replacing prefix
    # -- numerics / training ----------------------------------------------------
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (serving)
    tie_embeddings: bool = False
    remat: str = "dots"              # none | dots | full
    logit_softcap: float = 0.0
    # -- source note -------------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ derived
    @property
    def head_dim(self) -> int:
        """Per-head width: ``d_head`` or d_model / n_heads."""
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_free(self) -> bool:
        """True for the attention-free SSM family."""
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        """True for encoder-decoder configs."""
        return self.encoder_layers > 0

    @property
    def ssm_inner(self) -> int:
        """The SSM branch's inner width, expand * d_model."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """SSM heads: inner width / head dim."""
        return self.ssm_inner // self.ssm_headdim

    @property
    def activation_dtype(self) -> torch.dtype:
        """``dtype`` as a ``torch.dtype``."""
        return getattr(torch, self.dtype)

    # -------------------------------------------------------------- param count
    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim
        per_layer = 0
        if not self.attn_free:
            per_layer += d * (self.n_heads * hd)              # wq
            per_layer += 2 * d * (self.n_kv_heads * hd)       # wk, wv
            per_layer += (self.n_heads * hd) * d              # wo
            per_layer += d                                    # attn norm gain
        if self.family == "ssm" or self.family == "hybrid":
            di, ns, gh = self.ssm_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * di + 2 * ns + gh)           # in_proj (z,x,B,C,dt)
            per_layer += self.ssm_conv_width * (di + 2 * ns)  # conv
            per_layer += di * d                               # out_proj
            per_layer += 2 * gh + di                          # A_log, D, dt_bias... norm
            per_layer += d                                    # ssm norm gain
        if self.d_ff > 0:
            ffn = 3 * d * self.d_ff                           # SwiGLU: gate, up, down
            if self.n_experts:
                per_layer += self.n_experts * ffn + d * self.n_experts  # + router
            else:
                per_layer += ffn
            per_layer += d                                    # mlp norm gain
        total_layers = self.n_layers + self.encoder_layers
        cross = 0
        if self.is_encdec:   # decoder cross-attention per decoder layer
            cross = self.n_layers * (2 * d * (self.n_kv_heads * hd)
                                     + d * (self.n_heads * hd)
                                     + (self.n_heads * hd) * d + d)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return per_layer * total_layers + cross + embed + d   # final norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        ffn = 3 * d * self.d_ff
        dead = (self.n_experts - self.experts_per_token) * ffn * self.n_layers
        return self.param_count() - dead

    # ---------------------------------------------------------------- reduction
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2,
            encoder_layers=2 if self.is_encdec else 0,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            window=min(self.window, 32) if self.window else None,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            dtype="float32",
        )


def flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS/token = 6 * N_active (the roofline's 'useful' compute)."""
    return 6.0 * cfg.active_param_count()


def attention_flops(cfg: ModelConfig, batch: int, seq: int,
                    kv_len: int | None = None, causal: bool = True) -> float:
    """Extra attention score/value FLOPs not counted in 6N (for roofline)."""
    if cfg.attn_free:
        return 0.0
    kv_len = kv_len or seq
    if cfg.window:
        kv_len = min(kv_len, cfg.window)
    pairs = batch * cfg.n_heads * seq * kv_len
    if causal and kv_len == seq:
        pairs /= 2
    layers = cfg.n_layers + cfg.encoder_layers
    return 12.0 * pairs * cfg.head_dim * layers  # 2 matmuls * 2 ops * 3 (fwd+bwd)


def ssd_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """SSD chunked-scan FLOPs beyond 6N (intra-chunk quadratic + states).

    Per chunk of length Lc: G = C B^T (2 Lc^2 n), y_intra = att @ xdt
    (2 Lc^2 h p), chunk state S_c and y_inter (2 Lc h p n each).  x3 for
    fwd+bwd in training (callers divide for inference)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    lc = cfg.ssm_chunk
    n, h, p = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    tokens = batch * seq
    per_token = 2 * lc * (n + h * p) + 4 * h * p * n
    return 3.0 * per_token * tokens * cfg.n_layers

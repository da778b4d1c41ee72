"""Model assembly: the decoder-only LMs (dense, MoE, SSM, hybrid, VLM)
and the whisper-style encoder-decoder, the port of the JAX package's
``models/transformer.py`` (``init``, ``forward``, ``loss``,
``init_cache``, ``prefill``, ``decode``, ``build``).

Parameters are plain dicts of tensors: ``embed`` (V, d), ``final_norm``
(d,) float32, ``unembed`` (V, d) unless the embeddings are tied, and
``layers``, a list of one dict per layer (the JAX package stacks the
layers on a leading axis for ``lax.scan``; a Python loop over the list
takes its place); an enc-dec model adds ``enc_layers``, a list of
``encoder_layers`` dicts, and ``enc_final_norm``.  The cache is a list
of one layer cache each, updated in place.  On a mesh the parameters
may be DTensors (``launch.train.train_loop(mesh=)``): each layer's are
gathered for use inside the layer's body (``blocks.for_use``,
recomputed under remat), the ZeRO-3 pattern over the fsdp axes, with
the leaves that split over ``model`` keeping their shards (Megatron's
split: heads, the SwiGLU hidden dim; ``models/attention.py``); the
embedding and the head keep their vocabulary split where ``model``
divides it (``layers.embed``, ``layers.logits_head``, whose logits
come split over ``model``), and the head its fsdp shards where the fsdp
axes split its contraction (``sharding.contraction_split``); plain
tensors pass as they are.  The
sinusoidal positions meet a DTensor activation as a whole DTensor
(``sharding.replicate_as``).

``forward``/``loss`` are the training pass.  Each layer (the encoder's
too) runs under the config's ``remat`` policy while autograd records:
``"full"`` saves nothing and recomputes the layer in the backward pass,
``"dots"`` saves the outputs of the dense products (``aten.mm`` and
``aten.addmm``) and recomputes the rest -- the counterpart of the JAX
package's ``dots_with_no_batch_dims_saveable``: ``bmm`` and ``einsum``,
with their batch dims, are recomputed -- and ``"none"`` runs plain.  The
hand-written kernels are opaque to the dispatcher, so under ``"dots"``
and ``"full"`` every layer's kernels launch again in the backward pass.

Batch dict convention, as in the JAX package:
  LM      : {"tokens": (B, S) integers, "labels": (B, S) integers}
  VLM     : + {"patches": (B, P, d) precomputed patch embeddings (stub)}
  enc-dec : {"frames": (B, S_enc, d) precomputed frame embeddings (stub),
             "tokens": the decoder side}
``launch.serve.serve_inputs`` builds the stubs the serving launcher feeds.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (contraction_split, gathered,
                                              replicate_as, whole)
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy, embed, embed_init,
                                       logits_head, rmsnorm,
                                       sinusoidal_positions)
from repro_torch.obs import steps

#: the families this port serves and trains: every family of the JAX package
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
REMAT_POLICIES = ("none", "dots", "full")
#: the products ``remat="dots"`` saves: the dense ones without batch dims
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


class Model:
    """Functional model: the parameters are a dict the methods take."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in SERVED_FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r} "
                             f"({cfg.name}); one of {SERVED_FAMILIES}")
        self.cfg = cfg
        #: the compiled serve steps of ``launch.serve`` by key (their CUDA
        #: graphs, static buffers and cache), freed with the model
        self.serve_graphs: dict = {}

    @property
    def _role(self) -> str:
        return "encdec_decoder" if self.cfg.is_encdec else "decoder"

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device, at the JAX
        package's scales (the draws differ: ``jax.random`` is not
        ``torch``'s generator)."""
        cfg = self.cfg
        dtype = cfg.activation_dtype
        dev = generator.device
        params = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(generator, cfg.vocab_size,
                                           cfg.d_model, dtype)
        params["layers"] = [blocks.init(generator, cfg, dtype, self._role)
                            for _ in range(cfg.n_layers)]
        if cfg.is_encdec:
            params["enc_layers"] = [blocks.init(generator, cfg, dtype,
                                                "encoder")
                                    for _ in range(cfg.encoder_layers)]
            params["enc_final_norm"] = torch.ones(
                (cfg.d_model,), dtype=torch.float32, device=dev)
        return params

    def _embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        """The token embeddings, the VLM's patch prefix in place of the
        first ``patches.shape[1]`` positions, plus sinusoidal positions
        where the config uses them."""
        cfg = self.cfg
        x = embed(gathered(params["embed"], keep_model=True),
                  batch["tokens"])
        if cfg.frontend == "vision" and "patches" in batch:
            p = replicate_as(batch["patches"].to(x.dtype), x)
            x = torch.cat([p, x[:, p.shape[1]:]], dim=1)
        if cfg.pos_embed == "sinusoidal":
            pos = sinusoidal_positions(
                torch.arange(x.shape[1], device=x.device), cfg.d_model)
            x = x + replicate_as(pos[None].to(x.dtype), x)
        return x

    def _encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """The encoder stack over precomputed frame embeddings (the audio
        stub): sinusoidal positions, the layers without a causal mask,
        then the encoder's final norm."""
        cfg = self.cfg
        x = frames.to(cfg.activation_dtype)
        pos = sinusoidal_positions(torch.arange(x.shape[1], device=x.device),
                                   cfg.d_model)
        x = x + replicate_as(pos[None].to(x.dtype), x)
        for lp in params["enc_layers"]:
            x, _ = self._layer(
                lambda h, lp=lp: blocks.apply(blocks.for_use(lp, cfg, h),
                                              h, cfg, causal=False), x)
        return rmsnorm(x, whole(params["enc_final_norm"]), cfg.norm_eps)

    def _layer(self, body, x: torch.Tensor):
        """``body(x)`` under the config's remat policy when autograd
        records it (plain otherwise: nothing is saved to recompute)."""
        remat = self.cfg.remat
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r}; one of "
                             f"{REMAT_POLICIES}")
        if remat == "none" or not torch.is_grad_enabled():
            return body(x)
        # no forward draws random numbers: no RNG state is saved and
        # restored around the recomputation, eager or under a capture
        if remat == "full":
            return checkpoint(body, x, use_reentrant=False,
                              preserve_rng_state=False)
        return checkpoint(body, x, use_reentrant=False,
                          preserve_rng_state=False, context_fn=_dots_context)

    def forward(self, params: dict, batch: dict):
        """Full-sequence logits: (logits (B, S, V) float32, aux), aux the
        layers' summed MoE load-balance term (0 without experts)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        enc_out = (self._encode(params, batch["frames"]) if cfg.is_encdec
                   else None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            def body(h, lp=lp):
                lp = blocks.for_use(lp, cfg, h)
                ckv = (attn_mod.encode_kv(lp["cross"], enc_out, cfg)
                       if cfg.is_encdec else None)
                return blocks.apply(lp, h, cfg, causal=True, cross_kv=ckv)
            x, aux_l = self._layer(body, x)
            aux = aux + aux_l
        x = rmsnorm(x, whole(params["final_norm"]), cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return logits_head(x, gathered(table, keep_model=True),
                           cfg.logit_softcap), aux

    def loss(self, params: dict, batch: dict):
        """(ce + router_aux_weight * aux, {"ce", "aux"}) of ``forward``
        against ``batch["labels"]`` (labels below 0 masked)."""
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        total = ce + self.cfg.router_aux_weight * aux
        return total, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0, *,
                   device: str | torch.device = "cuda") -> list:
        """One empty layer cache per layer, on ``device`` (the GPU unless
        the caller asks for the CPU); an enc-dec model's holds the cross
        keys and values of ``enc_len`` encoder positions."""
        dev = dispatch.resolve_device(device)
        return [blocks.init_cache(self.cfg, batch, max_len, self._role,
                                  enc_len, device=dev)
                for _ in range(self.cfg.n_layers)]

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with steps.region("head"):
            x = rmsnorm(x, whole(params["final_norm"]), cfg.norm_eps)
            table = params["embed"] if cfg.tie_embeddings \
                else params["unembed"]
            table = gathered(table, keep_model=True,
                             keep_fsdp=contraction_split(x))
            return logits_head(x, table, cfg.logit_softcap)[:, 0]

    def prefill(self, params: dict, batch: dict, cache: list):
        """Prompt pass over ``batch["tokens"]`` (B, S) (and the batch's
        ``patches`` or ``frames``).  Returns the last position's logits
        (B, V) float32 and the cache, every layer's written in place (the
        attention k/v/kpos, the SSM state and conv tail, the enc-dec
        cross keys and values)."""
        cfg = self.cfg
        with steps.region("embed"):
            x = self._embed_inputs(params, batch)
        enc_out = None
        if cfg.is_encdec:
            with steps.region("encoder"):
                enc_out = self._encode(params, batch["frames"])
        new_cache = []
        for i, (lp, c) in enumerate(zip(params["layers"], cache)):
            with steps.region("layer", layer=i):
                x, c = blocks.prefill(blocks.for_use(lp, cfg, x), x, cfg, c,
                                      start=0, enc_out=enc_out)
            new_cache.append(c)
        return self._head(params, x[:, -1:]), new_cache

    def decode(self, params: dict, tokens: torch.Tensor, pos,
               cache: list):
        """One step: tokens (B,) at absolute position ``pos``, a Python
        int or a 0-d int64 tensor on the tokens' device (the JAX
        launcher's traced scalar: nothing reads it back to the host, so
        ``launch.serve`` captures one CUDA graph for every position).
        Returns logits (B, V) float32 and the cache, written in place."""
        cfg = self.cfg
        with steps.region("embed"):
            x = embed(gathered(params["embed"], keep_model=True),
                      tokens[:, None])
            if cfg.pos_embed == "sinusoidal":
                p = sinusoidal_positions(
                    attn_mod.position_range(pos, 1, x.device), cfg.d_model)
                x = x + replicate_as(p[None].to(x.dtype), x)
        new_cache = []
        for i, (lp, c) in enumerate(zip(params["layers"], cache)):
            with steps.region("layer", layer=i):
                x, c = blocks.decode(blocks.for_use(lp, cfg, x, decode=True),
                                     x, cfg, c, pos)
            new_cache.append(c)
        return self._head(params, x), new_cache


def build(cfg: ModelConfig) -> Model:
    """The model of ``cfg`` (any of ``SERVED_FAMILIES``)."""
    return Model(cfg)

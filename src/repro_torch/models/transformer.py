"""Model assembly for serving: the decoder-only LMs of the dense, MoE,
SSM and hybrid families, the port of the JAX package's
``models/transformer.py`` (``init``, ``init_cache``, ``prefill``,
``decode``, ``build``).

Parameters are plain dicts of tensors: ``embed`` (V, d), ``final_norm``
(d,) float32, ``unembed`` (V, d) unless the embeddings are tied, and
``layers``, a list of one dict per layer (the JAX package stacks the
layers on a leading axis for ``lax.scan``; a Python loop over the list
takes its place).  The cache is a list of one layer cache each, updated
in place.  ``build`` raises ``NotPortedError`` for the encoder-decoder
and VLM families, and for any config that sets sinusoidal positions or
a frontend (the fields the JAX package's model branches on that the port
does not run yet); ``forward``/``loss`` come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.errors import NotPortedError
from repro_torch.kernels import dispatch
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed, embed_init, logits_head, rmsnorm

#: the families this port serves
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
#: the ROADMAP.md item that ports each family it does not serve yet
NOT_PORTED = {"encdec": "queue 1 item 10.2 (enc-dec serving)",
              "vlm": "queue 1 item 10.3 (VLM serving)"}
#: the config fields the JAX package's model branches on and the port
#: does not run yet, whatever the family: (what, ROADMAP.md sub-item,
#: test of the config that sets the field)
NOT_PORTED_FIELDS = (
    ("sinusoidal positions (pos_embed != 'rope')",
     "queue 1 item 10.2 (enc-dec serving)",
     lambda cfg: cfg.pos_embed != "rope"),
    ("a frontend (frontend is not None)", "queue 1 item 10.3 (VLM serving)",
     lambda cfg: cfg.frontend is not None))


class Model:
    """Functional model: the parameters are a dict the methods take."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in SERVED_FAMILIES:
            raise NotPortedError(f"the {cfg.family} family ({cfg.name})",
                                 NOT_PORTED.get(cfg.family, "queue 1 item 10"))
        # the reference branches on these fields, not on the family: a
        # served family with one of them set would build another model
        for what, roadmap, is_set in NOT_PORTED_FIELDS:
            if is_set(cfg):
                raise NotPortedError(f"{what} in {cfg.name}", roadmap)
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device, at the JAX
        package's scales (the draws differ: ``jax.random`` is not
        ``torch``'s generator)."""
        cfg = self.cfg
        dtype = cfg.activation_dtype
        params = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=generator.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(generator, cfg.vocab_size,
                                           cfg.d_model, dtype)
        params["layers"] = [blocks.init(generator, cfg, dtype)
                            for _ in range(cfg.n_layers)]
        return params

    def init_cache(self, batch: int, max_len: int, *,
                   device: str | torch.device = "cuda") -> list:
        """One empty layer cache per layer, on ``device`` (the GPU unless
        the caller asks for the CPU)."""
        dev = dispatch.resolve_device(device)
        return [blocks.init_cache(self.cfg, batch, max_len, dev)
                for _ in range(self.cfg.n_layers)]

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return logits_head(x, table, cfg.logit_softcap)[:, 0]

    def prefill(self, params: dict, batch: dict, cache: list):
        """Prompt pass over ``batch["tokens"]`` (B, S).  Returns the
        last position's logits (B, V) float32 and the filled cache."""
        x = embed(params["embed"], batch["tokens"])
        new_cache = []
        for lp, c in zip(params["layers"], cache):
            x, c = blocks.prefill(lp, x, self.cfg, c, start=0)
            new_cache.append(c)
        return self._head(params, x[:, -1:]), new_cache

    def decode(self, params: dict, tokens: torch.Tensor, pos: int,
               cache: list):
        """One step: tokens (B,) at absolute position ``pos``.  Returns
        logits (B, V) float32 and the cache."""
        x = embed(params["embed"], tokens[:, None])
        new_cache = []
        for lp, c in zip(params["layers"], cache):
            x, c = blocks.decode(lp, x, self.cfg, c, pos)
            new_cache.append(c)
        return self._head(params, x), new_cache


def build(cfg: ModelConfig) -> Model:
    """The model of ``cfg``; raises ``NotPortedError`` for a family the
    port does not serve yet, and for a config of a served family that
    sets a field of ``NOT_PORTED_FIELDS``."""
    return Model(cfg)

"""Assigned input-shape set + per-(arch x shape) applicability: a copy of
the JAX package's ``configs/shapes.py`` over the port's configs, so the
dry-run records of both compare cell for cell.

LM transformer shapes are seq_len x global_batch.  decode_*/long_* lower
``serve_step`` (one new token against a seq_len KV cache), not train_step.
long_500k needs sub-quadratic state: it runs only for archs whose per-token
state is bounded (SSM / hybrid / SWA); skips are recorded with reasons
(the reference's design notes, section Arch-applicability)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicability(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    if shape != "long_500k":
        return True, ""
    if cfg.family in ("ssm", "hybrid"):
        return True, ""
    if cfg.is_encdec:
        return False, "enc-dec audio backbone: no 500k decode stream"
    if cfg.window is not None:
        return True, ""                      # SWA bounds the cache
    return False, "pure full attention: unbounded 500k KV cache (assignment: skip)"


def cells(archs: list[str]) -> list[tuple[str, str, bool, str]]:
    """All 40 (arch, shape) cells with applicability flags."""
    from repro_torch import configs
    out = []
    for a in archs:
        cfg = configs.get(a)
        for s in SHAPES:
            ok, why = applicability(cfg, s)
            out.append((a, s, ok, why))
    return out


# training knobs per arch: sequences per data shard per microbatch
# (gradient accumulation covers the rest of the global batch)
MICROBATCH_PER_SHARD = {
    "internvl2-76b": 1,
    "deepseek-67b": 1,
    "dbrx-132b": 1,
    "yi-6b": 2,
    "phi3-mini-3.8b": 2,
    "whisper-medium": 2,
    "granite-moe-3b-a800m": 1,
    "h2o-danube-1.8b": 4,
    "hymba-1.5b": 2,
    "mamba2-130m": 2,
}

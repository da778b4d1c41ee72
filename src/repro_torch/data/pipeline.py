"""Deterministic synthetic data pipeline, stateless-seekable for exact
restart: a copy of the JAX package's ``data/pipeline.py`` generator
(numpy on the host, as a real loader), so both packages draw the same
batches bit for bit for the same ``(seed, step)``.

Batches are a pure function of (seed, step), so a job restarted from a
step-k checkpoint regenerates byte-identical batches from step k with no
pipeline state to persist -- the fault-tolerance contract of
``launch/train.py``.  The generator is a Zipf-ish token sampler with a
next-token structure (labels are tokens shifted by one over a
Markov-noised stream) so small models show a real, decreasing loss.

Host sharding: ``local_batch(step, host_id, n_hosts)`` returns only this
host's rows, which concatenate to the global batch.  ``make_batch_specs``
gives the dry-run's storage-free stand-ins of a batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """A batch's shape, its seed and the frontend's stub inputs."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str | None = None     # vision|audio -> extra stub inputs
    n_frontend_tokens: int = 0
    d_model: int = 0                # for stub embeddings


class SyntheticLMData:
    """Stateless step -> batch derivation (numpy arrays)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def global_batch(self, step: int) -> dict:
        """``tokens``/``labels`` (global_batch, seq_len) int32, plus
        float32 ``patches`` (vision) or ``frames`` (audio) stubs."""
        c = self.cfg
        rng = self._rng(step)
        # Zipf-distributed stream with Markov continuation: token t+1 is a
        # deterministic function of the *visible* token t half the time ->
        # genuinely learnable next-token structure.
        base = rng.zipf(1.3, size=(c.global_batch, c.seq_len + 1))
        base = (base - 1) % c.vocab_size
        coin = rng.random((c.global_batch, c.seq_len)) < 0.5
        tokens = np.empty_like(base)
        tokens[:, 0] = base[:, 0]
        for t in range(c.seq_len):
            tokens[:, t + 1] = np.where(
                coin[:, t], (tokens[:, t] * 31 + 7) % c.vocab_size,
                base[:, t + 1])
        batch = {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }
        if c.frontend == "vision":
            batch["patches"] = rng.standard_normal(
                (c.global_batch, c.n_frontend_tokens, c.d_model),
                dtype=np.float32)
        elif c.frontend == "audio":
            batch["frames"] = rng.standard_normal(
                (c.global_batch, c.seq_len, c.d_model), dtype=np.float32)
        return batch

    def local_batch(self, step: int, host_id: int, n_hosts: int) -> dict:
        """Host ``host_id``'s rows of ``global_batch(step)``."""
        g = self.global_batch(step)
        per = self.cfg.global_batch // n_hosts
        return {k: v[host_id * per:(host_id + 1) * per] for k, v in g.items()}


def make_batch_specs(cfg: DataConfig, *, device: str = "meta") -> dict:
    """Stand-ins for one global batch (the dry-run's inputs): tensors of
    the reference's shapes and dtypes on ``device`` (``meta``: no
    storage), ``patches``/``frames`` by the frontend."""
    c = cfg

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    specs = {
        "tokens": spec((c.global_batch, c.seq_len), torch.int32),
        "labels": spec((c.global_batch, c.seq_len), torch.int32),
    }
    if c.frontend == "vision":
        specs["patches"] = spec(
            (c.global_batch, c.n_frontend_tokens, c.d_model), torch.float32)
    elif c.frontend == "audio":
        specs["frames"] = spec(
            (c.global_batch, c.seq_len, c.d_model), torch.float32)
    return specs

"""The general traffic generator: a traffic file's parameters and the seed
give every request.

A serving mix lists length buckets, each a prompt length, an output
length and a whole-number ``share``.  One pass of the mix's deck holds
every bucket ``share`` times, in an order that the seed draws anew for
each pass; a run's window ends on a whole pass.  So every seed does the
same work, pass by pass, in another order, and only the token ids and
the order differ."""
from __future__ import annotations

import numpy as np


class ServeTraffic:
    """Closed-loop serving traffic (``kind: serve``): call ``i`` sends
    ``batch`` prompts of its bucket's ``prompt_tokens`` token ids, drawn
    uniformly from the vocabulary, and asks for its bucket's
    ``output_tokens`` greedy tokens."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        if spec["kind"] != "serve" or spec.get("clients", 1) != 1:
            raise ValueError(f"not one closed-loop serving client: {spec}")
        if spec.get("token_ids", "uniform") != "uniform":
            raise ValueError(f"unknown token_ids {spec['token_ids']!r}")
        self.batch = spec["batch"]
        self.buckets = [(b["prompt_tokens"], b["output_tokens"])
                        for b in spec["buckets"]]
        self.deck = [k for k, b in enumerate(spec["buckets"])
                     for _ in range(b["share"])]
        self.seed, self.vocab = seed, vocab
        self._orders: dict = {}

    def _rng(self, *words: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, *words]))

    def bucket_of(self, i: int) -> int:
        """The bucket of call ``i`` of the window: its pass's order."""
        p, j = divmod(i, len(self.deck))
        if p not in self._orders:
            self._orders[p] = self._rng(3, p).permutation(self.deck)
        return int(self._orders[p][j])

    def shape(self, i: int) -> tuple:
        """(prompt_tokens, output_tokens) of call ``i`` of the window."""
        return self.buckets[self.bucket_of(i)]

    def ends_pass(self, i: int) -> bool:
        """Whether call ``i`` is the last of its pass of the deck."""
        return (i + 1) % len(self.deck) == 0

    def _draw(self, prompt: int, *words: int) -> np.ndarray:
        return self._rng(*words).integers(0, self.vocab, (self.batch, prompt),
                                          dtype=np.int64).astype(np.int32)

    def prompts(self, i: int) -> np.ndarray:
        """The prompts (batch, prompt_tokens) of call ``i`` of the window."""
        return self._draw(self.shape(i)[0], 0, i)

    def extra(self, k: int, j: int, stream: int = 1) -> np.ndarray:
        """The prompts of bucket ``k``'s ``j``-th call outside the window
        (warm-up on stream 1, the traced stretch on stream 4)."""
        return self._draw(self.buckets[k][0], stream, k, j)

    def sample(self, calls: int, per_bucket: int) -> list:
        """``per_bucket`` calls of each bucket among the first ``calls``,
        drawn from the seed, so the longest bucket's calls are in it."""
        rng = self._rng(2)
        picked = []
        for k in range(len(self.buckets)):
            mine = [i for i in range(calls) if self.bucket_of(i) == k]
            picked += rng.choice(mine, size=min(per_bucket, len(mine)),
                                 replace=False).tolist()
        return sorted(int(i) for i in picked)

"""HBM-traffic accounting for the chain kernels.

A composite transform that runs as one pass moves (k+1)x fewer point-buffer
bytes than k sequential primitive passes.  Every fused chain application
and every packed serving launch records ``(op_name, bytes_moved)`` --
bytes read from plus written to device memory under the memory-bound
model (inputs + outputs, parameters included) -- while a ``counting()``
scope is active.  The formulas are the JAX package's, unchanged, so the
two packages count the same bytes for the same work.
"""
from __future__ import annotations

import contextlib

_ACTIVE: list[tuple[str, int]] | None = None


@contextlib.contextmanager
def counting():
    """Collect ``(op, nbytes)`` records emitted inside the scope."""
    global _ACTIVE
    prev, records = _ACTIVE, []
    _ACTIVE = records
    try:
        yield records
    finally:
        _ACTIVE = prev


def record(op: str, nbytes: int) -> None:
    """Record ``nbytes`` moved by ``op`` if a ``counting()`` scope is open."""
    if _ACTIVE is not None:
        _ACTIVE.append((op, int(nbytes)))


def total_bytes(records: list[tuple[str, int]]) -> int:
    """Sum of the bytes of ``(op, nbytes)`` records."""
    return sum(b for _, b in records)


def chain_param_words(d: int, kind: str) -> int:
    """Composed-parameter words of one folded chain, by plan kind: (s, t)
    for diag, (A, t) for matrix, (H, lo, hi) for projective."""
    return {"diag": 2 * d, "matrix": d * d + d,
            "projective": (d + 1) ** 2 + 2 * d}[kind]


def chain_passes(kind: str) -> int:
    """HBM passes of one fused chain launch: read + write, plus the
    point-buffer-width cull-mask write for projective plans."""
    return 3 if kind == "projective" else 2


def fused_chain_bytes(n_points: int, d: int, *, itemsize: int = 4,
                      kind: str = "matrix") -> int:
    """HBM bytes moved by ONE fused single-chain launch over (N, d)
    points (memory-bound model): the point buffer once in and once out
    (plus the mask pass for projective plans) and the composed-parameter
    words, at ``itemsize`` bytes per word."""
    return (chain_passes(kind) * n_points * d * itemsize
            + chain_param_words(d, kind) * itemsize)


def packed_chain_bytes(bsz: int, lpad: int, d: int, *, itemsize: int = 4,
                       kind: str = "matrix") -> int:
    """HBM bytes moved by one packed-batch chain launch (memory-bound
    model): a bucket of ``bsz`` requests packed to ``lpad`` points each
    moves the padded point buffer once in and once out plus the
    per-request folded parameters.  The serving engine records this
    number per launch."""
    return (chain_passes(kind) * bsz * lpad * d * itemsize
            + bsz * chain_param_words(d, kind) * itemsize)

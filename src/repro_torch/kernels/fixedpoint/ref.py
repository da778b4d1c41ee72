"""Plain versions of the fixed-point chain kernels, and the numpy Q oracle.

Two twins of the SAME arithmetic:

  * ``np_chain_diag_q`` / ``np_chain_matrix_q`` -- the numpy Qm.n oracle
    of the JAX package (``repro/kernels/fixedpoint/ref.py``), verbatim:
    int32 multiply-accumulate, one requantising shift
    ``(acc + 2**(n-1)) >> n``, int16 wrap.
  * ``chain_diag_q`` / ``chain_matrix_q`` and their batch forms -- the
    plain PyTorch versions, in int32 tensor ops: widen, multiply, add
    ``t << n``, add ``1 << (n-1)`` when n > 0, shift right by n, narrow
    to int16.  They run on the CPU for CPU tensors and on the card when
    a caller asks for ``backend="ref"``; the CUDA kernels in
    ``fixedpoint.py`` compute the same words.

All overflow wraps mod 2**32 in the accumulator and mod 2**16 at the
output -- everywhere, numpy included (``errstate(over="ignore")``).
Integer addition is associative mod 2**32, so any order of the
multiply-adds gives the same bits: the twins cannot diverge.
"""
from __future__ import annotations

import numpy as np
import torch


def _np_requant(acc: np.ndarray, n_frac: int) -> np.ndarray:
    """int32 accumulator -> int16 words: round-half-up shift, then wrap."""
    with np.errstate(over="ignore"):
        if n_frac:
            acc = (acc + np.int32(1 << (n_frac - 1))) >> n_frac
    return (acc & 0xFFFF).astype(np.uint16).view(np.int16).copy()


def np_chain_diag_q(p: np.ndarray, s: np.ndarray, t: np.ndarray,
                    n_frac: int) -> np.ndarray:
    """Numpy Q oracle, diagonal plan: q = requant(p*s + (t << n))."""
    with np.errstate(over="ignore"):
        acc = (np.asarray(p, np.int16).astype(np.int32)
               * np.asarray(s, np.int16).astype(np.int32)
               + (np.asarray(t, np.int16).astype(np.int32) << n_frac))
    return _np_requant(acc, n_frac)


def np_chain_matrix_q(p: np.ndarray, a: np.ndarray, t: np.ndarray,
                      n_frac: int) -> np.ndarray:
    """Numpy Q oracle, matrix plan: q = requant(p @ A + (t << n)) over
    (..., d) int16 points; A (d, d), t (d,) int16 words."""
    p32 = np.asarray(p, np.int16).astype(np.int32)
    a32 = np.asarray(a, np.int16).astype(np.int32)
    t32 = np.asarray(t, np.int16).astype(np.int32)
    d = p32.shape[-1]
    with np.errstate(over="ignore"):
        cols = [
            sum(p32[..., m] * a32[m, c] for m in range(d)) + (t32[c] << n_frac)
            for c in range(d)
        ]
        acc = np.stack(cols, axis=-1).astype(np.int32)
    return _np_requant(acc, n_frac)


# -- the plain PyTorch versions ------------------------------------------------

def _requant(acc: torch.Tensor, n_frac: int) -> torch.Tensor:
    """int32 accumulator -> int16 words: the rounding add and the
    arithmetic shift when n > 0, then the wrapping narrow."""
    if n_frac:
        acc = (acc + (1 << (n_frac - 1))) >> n_frac
    return acc.to(torch.int16)


def chain_diag_q(p: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                 n_frac: int) -> torch.Tensor:
    """Diagonal plan q = requant(p*s + (t << n)) over (..., d) int16
    words, s and t broadcasting against the trailing coordinate axis."""
    acc = p.to(torch.int32) * s.to(torch.int32) \
        + (t.to(torch.int32) << n_frac)
    return _requant(acc, n_frac)


def chain_matrix_q(p: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
                   n_frac: int) -> torch.Tensor:
    """Matrix plan q = requant(p @ A + (t << n)) over (..., d) int16
    words; ``a`` (..., d, d) and ``t`` (..., d) broadcast against p's
    leading axes (a single chain passes (d, d) and (d,))."""
    p32, a32, t32 = p.to(torch.int32), a.to(torch.int32), t.to(torch.int32)
    d = p.shape[-1]
    cols = []
    for c in range(d):
        acc = p32[..., 0] * a32[..., 0, c]
        for m in range(1, d):
            acc = acc + p32[..., m] * a32[..., m, c]
        cols.append(acc + (t32[..., c] << n_frac))
    return _requant(torch.stack(cols, dim=-1), n_frac)


def chain_diag_batch_q(p3: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                       n_frac: int) -> torch.Tensor:
    """Batched diagonal plans on a packed (B, L, d) batch with (B, d)
    words: the per-request ``chain_diag_q`` broadcast over B."""
    return chain_diag_q(p3, s[:, None, :], t[:, None, :], n_frac)


def chain_matrix_batch_q(p3: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
                         n_frac: int) -> torch.Tensor:
    """Batched matrix plans on a packed (B, L, d) batch with (B, d, d)
    and (B, d) words: the per-request ``chain_matrix_q`` broadcast over B."""
    return chain_matrix_q(p3, a[:, None], t[:, None], n_frac)

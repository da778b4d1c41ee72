"""Folded-chain quantisation + the per-chain quantisation error bound.

The port of ``repro/quantize/chains.py``, verbatim numpy: the chain
compiler folds in float32 (one shared host fold -- see
``core.transform_chain``), and THIS module is where a folded parameter
set crosses into the fixed-point lane.  ``quantize_fold`` turns the
float32 ``(s, t)`` / ``(A, t)`` into int16 Qm.n words once per request,
so the port and the JAX package stage the same words, and
``error_bound`` predicts how far the lane's int16 result may sit from
the exact float chain.

Derivation (matrix plan; diag is the 1-term special case).  Writing
``e = 2**-(n+1)`` (a half ulp -- the worst case of round-to-nearest for
inputs and parameters, and of the add-then-shift requantise), hatted
values for dequantised quantities, and ``x_max`` for a bound on |x_m|:

    y_c      = sum_m x_m A[m, c] + t_c                 (exact)
    z_c      = requant(sum_m x^_m A^[m, c] + t^_c)     (the lane; the
                                                        int32 MAC is exact)
    |z_c - y_c| <= sum_m (|A^[m, c]| |x^_m - x_m| + |x_m| |A^[m, c] - A[m, c]|)
                   + |t^_c - t_c| + e_requant
                <= e * (sum_m |A^[m, c]| + d * x_max + 2)

valid whenever nothing wraps: every intermediate magnitude must stay
inside the format (``fits`` checks that, with the same e inflation).
Wrap-around is the M1's semantics, not an error -- but a wrapped result
is outside this bound's contract.
"""
from __future__ import annotations

import numpy as np

from repro_torch.errors import QRangeError
from repro_torch.quantize.qformat import QFormat, as_qformat

#: plan kinds the fixed-point lane executes.  Projective plans are
#: EXCLUDED by design: the in-kernel perspective divide has no
#: single-shift Qm.n form (w varies per point), so projective chains
#: stay on the float lane and ``TransformChain`` rejects them loudly.
QUANTIZABLE_KINDS = ("diag", "matrix")


def reject_projective(is_projective: bool) -> None:
    """The ONE spelling of the lane's affine-only intake rule, raised by
    every entry that accepts a chain + fixed-point format
    (``TransformChain.apply``/``project`` via ``_apply_q``,
    ``GeometryServer.submit``): projective plans keep the in-kernel
    perspective divide in float32 (no single-shift Qm.n form exists --
    w varies per point)."""
    if is_projective:
        raise ValueError(
            "projective chains have no fixed-point lane: the in-kernel "
            "perspective divide stays float32 (drop the fixed-point "
            "format, or split the affine prefix into its own chain)")


def points_need_quantize(dtype) -> bool:
    """The ONE point-dtype intake rule of the lane: True for float
    dtypes (quantise at the boundary, dequantise on the way out), False
    for int16 (already Qm.n words, returned as words); anything else
    raises."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return True
    if dt == np.int16:
        return False
    raise TypeError(f"fixed-point points must be float (to be quantised) "
                    f"or int16 Qm.n words, got {dt}")


def quantize_fold(folded: tuple, kind: str, fmt) -> tuple[np.ndarray, ...]:
    """Quantise one host-folded parameter set to int16 Qm.n words:
    ``(s_q, t_q)`` for a diag plan, ``(A_q, t_q)`` for a matrix plan --
    the exact arrays the ``chain_*_q`` kernels stage.  One code path for
    ``TransformChain.apply`` and the serving engine's bucket packing, so
    a request quantises to bit-identical words however it is dispatched.
    """
    fmt = as_qformat(fmt)
    if kind not in QUANTIZABLE_KINDS:
        raise ValueError(
            f"the fixed-point lane is affine-only: cannot quantise a "
            f"{kind!r} plan (projective chains keep the in-kernel divide "
            "in float32)")
    return tuple(fmt.quantize(part) for part in folded)


def _abs_dequant(fmt: QFormat, q: np.ndarray) -> np.ndarray:
    return np.abs(fmt.dequantize(q)).astype(np.float64)


def error_bound(folded: tuple, kind: str, fmt, x_max: float) -> np.ndarray:
    """Per-output-coordinate bound on |lane result - exact float chain|
    for inputs with |x_m| <= x_max, as a (d,) float64 array.  Contract:
    holds whenever ``fits(...)`` is True (no wrap anywhere)."""
    fmt = as_qformat(fmt)
    half_ulp = fmt.eps / 2.0
    quant = quantize_fold(folded, kind, fmt)
    if kind == "diag":
        s_hat = _abs_dequant(fmt, quant[0])
        return half_ulp * (s_hat + x_max + 2.0)
    a_hat = _abs_dequant(fmt, quant[0])
    d = a_hat.shape[0]
    return half_ulp * (a_hat.sum(axis=0) + d * x_max + 2.0)


def fits(folded: tuple, kind: str, fmt, x_max: float) -> bool:
    """True when the lane cannot wrap for inputs with |x_m| <= x_max:
    parameters and inputs are representable, every output coordinate
    (inflated by its error bound) stays inside the format, and the int32
    accumulator has headroom.  The bound contract of ``error_bound``
    only applies under this predicate -- the M1 datapath wraps silently
    beyond it."""
    fmt = as_qformat(fmt)
    if kind not in QUANTIZABLE_KINDS:
        return False
    if x_max > fmt.hi:
        return False
    parts = [np.asarray(p, np.float64) for p in folded]
    if any(np.abs(p).max(initial=0.0) > fmt.hi for p in parts):
        return False
    if kind == "diag":
        s, t = parts
        out_max = np.abs(s) * x_max + np.abs(t)
        acc_terms = out_max
    else:
        a, t = parts
        out_max = np.abs(a).sum(axis=0) * x_max + np.abs(t)
        acc_terms = out_max
    bound = error_bound(folded, kind, fmt, x_max)
    if np.any(out_max + bound > fmt.hi):
        return False
    # int32 accumulator: values carry scale 2**2n pre-shift
    return bool(np.all((acc_terms + bound) * fmt.scale * fmt.scale
                       < 2.0 ** 31))


def ensure_fits(folded: tuple, kind: str, fmt, x_max: float, *,
                ticket: int | None = None) -> None:
    """Raise a typed ``repro_torch.errors.QRangeError`` when ``fits`` is
    False -- the reject arm of the serving engine's wrap policy
    (``FaultConfig.on_q_overflow``).  The M1 datapath would wrap silently
    past this point; the serving boundary refuses to return wrapped
    words as if they were results."""
    fmt = as_qformat(fmt)
    if not fits(folded, kind, fmt, x_max):
        raise QRangeError(
            f"fixed-point format {fmt.name} would wrap for this chain at "
            f"|x| <= {float(x_max):.6g} (range bound exceeds "
            f"{fmt.hi:.6g} or the int32 accumulator): submit on the "
            "float32 lane, pick a wider-integer format, or enable the "
            "on_q_overflow='fallback' policy", ticket=ticket)

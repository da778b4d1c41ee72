"""Typed request-validation errors: the serving fault taxonomy's base layer.

A malformed request -- NaN points, a float64 buffer, an empty point set
-- would otherwise detonate later, inside a packed bucket, where the
failure poisons every co-batched request of the flush.  These exceptions
move the failure to the intake boundary and give it a machine-readable
shape: every class carries a stable ``code`` (the taxonomy key counters
and logs group by) and the offending ``ticket`` (request id) when one
exists, and every class subclasses ``ValueError``.

This module depends on numpy only.  ``repro_torch.core`` (the chain
compiler) and ``repro_torch.serving`` (the engine) both raise these;
``repro_torch.serving.errors`` re-exports the taxonomy.  The codes and
messages are the same as the JAX package's, so logs from either read
alike.
"""
from __future__ import annotations

import math

import numpy as np


class RequestError(ValueError):
    """Base of the typed request-error taxonomy.

    ``code`` is the stable taxonomy key ("shape", "dtype", "empty",
    "nonfinite", "q-range", "launch"); ``ticket`` is the serving request
    id when the error is tied to one (None at the library boundary,
    e.g. ``TransformChain.apply``)."""
    code = "request"

    def __init__(self, message: str, *, ticket: int | None = None):
        self.message = message
        self.ticket = ticket
        prefix = f"[request {ticket}] " if ticket is not None else ""
        super().__init__(f"{prefix}{message}")

    def with_ticket(self, ticket: int) -> "RequestError":
        """The same error re-raised with the offending request id."""
        return type(self)(self.message, ticket=ticket)


class ShapeError(RequestError):
    """Points whose shape cannot mean anything for the chain: wrong last
    dimension, or a bare scalar."""
    code = "shape"


class DtypeError(RequestError, TypeError):
    """Points in a dtype the lane does not execute (float64 is rejected
    rather than silently narrowed; the serving boundary is strict
    float32).  Also a ``TypeError``, so both spellings catch it."""
    code = "dtype"


class EmptyPointsError(RequestError):
    """A zero-point request: an empty launch wastes a bucket slot and an
    empty result is indistinguishable from a lost one."""
    code = "empty"


class NonFiniteError(RequestError):
    """NaN/Inf in the submitted points, or chain parameters that fold to
    non-finite composed values -- either would poison every co-batched
    request's kernel launch."""
    code = "nonfinite"


class QRangeError(RequestError):
    """The fixed-point error bound predicts int16 wrap-around for a
    request (the Qm.n lane; raised once that lane is ported)."""
    code = "q-range"


class LaunchError(RequestError):
    """A kernel launch failed for this request and recovery is exhausted
    (the terminal per-request resolution of the recovery ladder)."""
    code = "launch"


def check_points(points, dim: int, *, ticket: int | None = None) -> None:
    """The shared boundary check of ``TransformChain.apply`` and
    ``GeometryServer.submit``: points must be (..., dim)-shaped,
    non-empty, and not float64.  Works on numpy arrays and torch tensors
    (only ``shape`` and ``dtype`` are read, so no device sync);
    finiteness is the serving boundary's extra check."""
    shape = getattr(points, "shape", None)
    if shape is None or len(shape) < 1 or shape[-1] != dim:
        raise ShapeError(
            f"chain is {dim}D, points are {tuple(shape) if shape is not None else None}",
            ticket=ticket)
    if math.prod(shape) == 0:
        raise EmptyPointsError(
            f"empty point set {tuple(shape)}: zero-point requests are "
            "rejected at the boundary (an empty result is "
            "indistinguishable from a lost one)", ticket=ticket)
    if _is_float64(getattr(points, "dtype", np.float32)):
        raise DtypeError(
            "float64 points are not executed (the lanes are float32 / "
            "int16 Qm.n); convert with .astype(np.float32)", ticket=ticket)


def _is_float64(dtype) -> bool:
    # torch dtypes are not numpy dtypes; compare by name for both
    return str(dtype).rsplit(".", 1)[-1] == "float64"

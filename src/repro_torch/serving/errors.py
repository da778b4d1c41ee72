"""The serving fault taxonomy: typed request errors + serving-only faults.

The validation layer (``RequestError`` and its intake subclasses) lives in
``repro_torch.errors`` so the chain compiler can raise the same types;
this module is the serving-side spelling of the family plus the members
only the engine produces:

  * ``LaunchError``       -- terminal per-request resolution after the
    recovery ladder (retry -> backend degradation -> bisection) is
    exhausted; occupies the request's result slot in ``flush``.
  * ``InjectedFault``     -- raised by the seeded fault-injection
    harness (``serving.faults``) to stand in for a real launch failure;
    deliberately NOT a ``RequestError``: it models the infrastructure
    failing, not the request being malformed.
  * ``CorruptionError``   -- the engine detected non-finite values in a
    launch's output whose inputs validated finite (staging corruption in
    the fault model); treated as a failed launch and retried from the
    clean host copy.

``is_error`` is the one-line test drivers use on ``flush`` results.
"""
from __future__ import annotations

import typing

from repro_torch.errors import (DtypeError, EmptyPointsError, LaunchError,
                                NonFiniteError, QRangeError, RequestError,
                                ShapeError)


class InjectedFault(RuntimeError):
    """A deterministic, injector-scheduled launch failure (see
    ``serving.faults.FaultInjector``).  The engine's recovery path makes
    no distinction between this and a real kernel-launch exception --
    that indistinguishability is what makes the harness a test of the
    real recovery machinery."""


class CorruptionError(RuntimeError):
    """Non-finite values detected in a launch's output although every
    input validated finite at submit: the staged operand buffer (or the
    launch itself) corrupted in flight.  The launch result is discarded
    wholesale and the bucket retried from the clean host copy."""


def is_error(result: typing.Any) -> bool:
    """True when a ``flush`` result slot resolved to a typed error
    instead of a transformed point set."""
    return isinstance(result, RequestError)


__all__ = [
    "RequestError", "ShapeError", "DtypeError", "EmptyPointsError",
    "NonFiniteError", "QRangeError", "LaunchError", "InjectedFault",
    "CorruptionError", "is_error",
]

"""The serving fault taxonomy: typed request errors + serving-only faults.

The validation layer (``RequestError`` and its intake subclasses) lives in
``repro_torch.errors`` so the chain compiler can raise the same types;
this module is the serving-side spelling of the family plus the member
only the engine produces.  ``InjectedFault`` arrives with the
fault-injection harness in the fault-tolerance slice.

``is_error`` is the one-line test drivers use on ``flush`` results.
"""
from __future__ import annotations

import typing

from repro_torch.errors import (DtypeError, EmptyPointsError, LaunchError,
                                NonFiniteError, QRangeError, RequestError,
                                ShapeError)


class CorruptionError(RuntimeError):
    """Non-finite values detected in a launch's output although every
    input validated finite at submit: the staged operand buffer (or the
    launch itself) corrupted in flight."""


def is_error(result: typing.Any) -> bool:
    """True when a ``flush`` result slot resolved to a typed error
    instead of a transformed point set."""
    return isinstance(result, RequestError)


__all__ = [
    "RequestError", "ShapeError", "DtypeError", "EmptyPointsError",
    "NonFiniteError", "QRangeError", "LaunchError", "CorruptionError",
    "is_error",
]

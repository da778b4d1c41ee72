"""Qm.n fixed-point format descriptors + float<->fixed converters.

The port of ``repro/quantize/qformat.py``: ``QFormat``, ``as_qformat``,
``is_qformat``, ``Q8_7``, ``Q15_0`` and the numpy ``quantize``/
``dequantize`` are that module's, verbatim, so both packages quantise
the same floats to the same words.  The JAX package's traced twins
become ``quantize_torch``/``dequantize_torch`` on tensors, so points are
quantised where they lie (on the card for a CUDA tensor).

The MorphoSys M1 prototype's RC-array ALUs are 16-bit signed integer
units (paper section 3).  ``QFormat`` is that numeric contract as data: a
signed 16-bit word interpreted as ``Qm.n`` -- 1 sign bit, ``m`` integer
bits, ``n`` fraction bits (m + n = 15), representing ``word / 2**n``.

Conversion discipline (shared by every consumer -- the host quantisers
here, the numpy Q oracle, and the fixed-point kernels -- so the lane has
ONE rounding story):

  * float -> fixed: round-half-to-even (``np.rint`` / ``torch.round``,
    the IEEE default -- host and tensor quantisation agree bit for bit),
    then SATURATE to the int16 range.  Saturation happens only at the
    boundary into the lane; it is the converter's job, not the ALU's.
  * fixed arithmetic: int32-accumulate multiply-adds, one requantising
    shift ``(acc + 2**(n-1)) >> n`` (round half toward +inf -- the cheap
    add-then-arithmetic-shift hardware idiom), then WRAP to int16 -- the
    M1 ALU's wrap-around semantics (it wraps, it never saturates).  At
    n = 0 the shift vanishes and the lane is bit for bit the M1's integer
    datapath.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

WORD_BITS = 16          #: the M1 RC-array ALU width
_NAME_RE = re.compile(r"^q(\d+)\.(\d+)$")


@dataclasses.dataclass(frozen=True)
class QFormat:
    """A signed 16-bit Qm.n fixed-point format (1 sign + m int + n frac).

    ``name`` ("q8.7") is the canonical spelling used everywhere a format
    travels as a string: ``TransformChain.apply(dtype=...)`` and serving
    bucket keys.
    """
    m: int                         # integer bits
    n: int                         # fraction bits

    def __post_init__(self):
        if self.m < 0 or self.n < 0 or self.m + self.n != WORD_BITS - 1:
            raise ValueError(
                f"Qm.n must satisfy m + n = {WORD_BITS - 1} with m, n >= 0 "
                f"(16-bit signed word); got q{self.m}.{self.n}")

    @property
    def name(self) -> str:
        return f"q{self.m}.{self.n}"

    @property
    def scale(self) -> int:
        """Values represent ``word / scale``."""
        return 1 << self.n

    @property
    def lo(self) -> float:
        """Smallest representable value (-2**m)."""
        return float(-(1 << self.m))

    @property
    def hi(self) -> float:
        """Largest representable value (2**m - 2**-n)."""
        return float((1 << self.m)) - self.eps

    @property
    def eps(self) -> float:
        """One unit in the last place: 2**-n."""
        return 1.0 / self.scale

    # -- converters ----------------------------------------------------------

    def quantize(self, x) -> np.ndarray:
        """float -> int16 words: round-half-to-even, saturating.  The
        scaling multiply runs in float32 so this host quantiser and the
        tensor twin ``quantize_torch`` agree BIT FOR BIT (a float64
        intermediate could resolve a tie the float32 path rounds away)."""
        w = np.rint(np.asarray(x, np.float32) * np.float32(self.scale))
        return np.clip(w, -(1 << 15), (1 << 15) - 1).astype(np.int16)

    def dequantize(self, w) -> np.ndarray:
        """int16 words -> float32 values (exact: 21-bit significands)."""
        return (np.asarray(w).astype(np.float32) / np.float32(self.scale)
                ).astype(np.float32)

    def quantize_torch(self, x):
        """The tensor twin of ``quantize`` (the same float32 multiply, the
        same half-to-even rounding -- bit-identical), on the tensor's
        device; this is what ``TransformChain``'s q lane runs."""
        import torch
        w = torch.round(x.to(torch.float32) * float(self.scale))
        return torch.clamp(w, -(1 << 15), (1 << 15) - 1).to(torch.int16)

    def dequantize_torch(self, w):
        """The tensor twin of ``dequantize`` (exact)."""
        import torch
        return w.to(torch.float32) / float(self.scale)


def as_qformat(fmt) -> QFormat:
    """Coerce a format spec -- a ``QFormat`` or a name like "q8.7" -- to a
    ``QFormat``; raises ValueError for anything else (including float
    dtype names, which belong on the default float lane)."""
    if isinstance(fmt, QFormat):
        return fmt
    if isinstance(fmt, str):
        match = _NAME_RE.match(fmt)
        if match:
            return QFormat(int(match.group(1)), int(match.group(2)))
    raise ValueError(
        f"not a fixed-point format: {fmt!r} (expected 'qM.N' with "
        f"M + N = {WORD_BITS - 1}, e.g. 'q8.7', or a QFormat)")


def is_qformat(fmt) -> bool:
    """True if ``fmt`` names a Qm.n format this lane can execute."""
    try:
        as_qformat(fmt)
        return True
    except ValueError:
        return False


#: the lane's house format: q8.7 covers the workload range (|x| < 256)
#: at 2**-7 ~ 0.008 resolution, and its Q7 coefficients are the paper's
#: Q7 rotation immediates (the 8-bit context-word field, |coef| <= 127).
Q8_7 = QFormat(8, 7)
#: the integer instantiation: no shift, bit for bit the M1's datapath.
Q15_0 = QFormat(15, 0)

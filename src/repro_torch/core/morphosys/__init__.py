"""Faithful-reproduction layer: MorphoSys M1 emulator (mULATE analogue).

The port's copy of ``repro/core/morphosys/__init__.py``: the same code, the
imports renamed and a one-line docstring on each public name that had
none.  Numpy only, so the port keeps the M1 emulator (the cycle oracle)
without importing the JAX package.

The paper maps linear-algebraic functions (vector-vector "translation",
vector-scalar "scaling", matrix-matrix "rotation/composite") onto the
MorphoSys M1 coarse-grained reconfigurable array and reports cycle counts
against Intel 80386/80486/Pentium instruction-level cycle models.

This package re-implements:
  * the 8x8 RC array, double-banked frame buffer and context memory
    (``rc_array``),
  * the TinyRISC control-ISA subset used by the paper's listings, with
    1-instruction/cycle accounting (``isa``),
  * program generators for the paper's Table 1 / Table 2 routines plus the
    section-5.3 matrix mapping (``programs``),
  * the Intel cycle models of Tables 3-4 and the published Table 5 constants
    (``intel``).
"""
from repro_torch.core.morphosys.rc_array import FrameBuffer, RCArray, ContextMemory, encode_context, decode_context
from repro_torch.core.morphosys.isa import Machine, Program, I
from repro_torch.core.morphosys import programs, intel

__all__ = [
    "FrameBuffer", "RCArray", "ContextMemory", "encode_context", "decode_context",
    "Machine", "Program", "I", "programs", "intel",
]

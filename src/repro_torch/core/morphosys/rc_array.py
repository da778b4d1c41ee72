"""MorphoSys M1 datapath emulation: RC array, frame buffer, context memory.

The port's copy of ``repro/core/morphosys/rc_array.py``: the same code, the
imports renamed and a one-line docstring on each public name that had
none.  Numpy only, so the port keeps the M1 emulator (the cycle oracle)
without importing the JAX package.

Functional semantics follow sections 2-3 and 5 of the paper:

  * The RC array is an 8x8 grid of 16-bit ALU/multiplier cells.  Every cell
    in a column (column-broadcast mode) or row (row-broadcast mode) executes
    the *same* context word -- SIMD by configuration.
  * Each cell has a small register file; we model the output register and one
    accumulator register (enough for the paper's routines, which use the
    multiply-accumulate path for the matrix mapping of section 5.3).
  * The frame buffer has two *sets* (0/1) for compute/DMA overlap and two
    *banks* (A/B) per set so a double-bank broadcast (``dbcdc``) can feed two
    operand streams in one cycle.
  * Arithmetic is 16-bit signed wrap-around (the current M1 prototype's
    ALU-Multiplier "operates only on signed numbers", section 3).

Context-word encoding: the paper publishes two words -- ``0x0000F400`` for
``Out = A + B`` (Table 1) and ``0x00009005`` for ``Out = c x A`` with
``c = 5`` (Table 2).  We define a decode consistent with both:

  bits [15:12]  major opcode: 0xF = two-operand ALU, 0x9 = constant multiply
  bits [11:8]   ALU subfunction for 0xF: 0x4 add, 0x5 sub, 0x6 mul
  bits [7:0]    immediate (constant) operand for 0x9 / 0xA
  0xA           constant multiply-accumulate (CMUL+acc, section 5.3 mapping)
  0xB           constant add (vector-scalar add; section 5.2 "or any other
                operation (arithmetic or logical)")
"""
from __future__ import annotations

import dataclasses
import numpy as np

N = 8  # RC array is 8x8


# ---------------------------------------------------------------------------
# context words
# ---------------------------------------------------------------------------

OP_ADD_AB = "add_ab"
OP_SUB_AB = "sub_ab"
OP_MUL_AB = "mul_ab"
OP_CMUL = "cmul"        # out = imm * a
OP_CMAC = "cmac"        # acc += imm * a   (matrix mapping, section 5.3)
OP_CADD = "cadd"        # out = a + imm

_MAJOR = {OP_ADD_AB: 0xF, OP_SUB_AB: 0xF, OP_MUL_AB: 0xF,
          OP_CMUL: 0x9, OP_CMAC: 0xA, OP_CADD: 0xB}
_SUB = {OP_ADD_AB: 0x4, OP_SUB_AB: 0x5, OP_MUL_AB: 0x6}


def encode_context(op: str, imm: int = 0) -> int:
    """Encode an RC context word; 0x0000F400 == add, 0x00009005 == cmul(5)."""
    major = _MAJOR[op]
    if major == 0xF:
        return (major << 12) | (_SUB[op] << 8)
    return (major << 12) | (int(imm) & 0xFF)


def decode_context(word: int) -> tuple[str, int]:
    """The (op, immediate) of a context word; inverse of ``encode_context``."""
    major = (word >> 12) & 0xF
    if major == 0xF:
        sub = (word >> 8) & 0xF
        for op, s in _SUB.items():
            if s == sub:
                return op, 0
        raise ValueError(f"bad ALU subfunction {sub:#x} in context {word:#010x}")
    imm = word & 0xFF
    if imm >= 0x80:          # immediates are 8-bit two's-complement
        imm -= 0x100
    if major == 0x9:
        return OP_CMUL, imm
    if major == 0xA:
        return OP_CMAC, imm
    if major == 0xB:
        return OP_CADD, imm
    raise ValueError(f"bad context word {word:#010x}")


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

class FrameBuffer:
    """Two sets x two banks of 16-bit words (set 1 mirrors set 0's layout).

    The double-set organisation is what lets DMA refill proceed while the RC
    array computes (paper section 2) -- the property our Pallas kernels
    reproduce as double-buffered HBM->VMEM pipelines.
    """

    WORDS_PER_BANK = 1024

    def __init__(self) -> None:
        # [set][bank] -> int16 array
        self.mem = np.zeros((2, 2, self.WORDS_PER_BANK), dtype=np.int16)

    def write(self, fb_set: int, bank: int, addr: int, data: np.ndarray) -> None:
        """Store ``data`` at ``addr`` of one bank of one set."""
        data = np.asarray(data, dtype=np.int16)
        self.mem[fb_set, bank, addr:addr + data.size] = data

    def read(self, fb_set: int, bank: int, addr: int, count: int) -> np.ndarray:
        """A copy of ``count`` words at ``addr`` of one bank of one set."""
        return self.mem[fb_set, bank, addr:addr + count].copy()


class ContextMemory:
    """Column block / row block of context words (two planes each)."""

    WORDS = 32

    def __init__(self) -> None:
        self.col = np.zeros((2, self.WORDS), dtype=np.uint32)   # [plane, word]
        self.row = np.zeros((2, self.WORDS), dtype=np.uint32)

    def load(self, block: str, plane: int, start: int, words: np.ndarray) -> None:
        """Load context words into one plane of the column or row block."""
        words = np.asarray(words, dtype=np.uint32)
        target = self.col if block == "col" else self.row
        target[plane, start:start + words.size] = words

    def get(self, block: str, plane: int, word: int) -> int:
        """One context word of one plane of the column or row block."""
        target = self.col if block == "col" else self.row
        return int(target[plane, word])


@dataclasses.dataclass
class RCArray:
    """8x8 array of 16-bit cells.

    Each cell exposes its *output register*, which is also an ALU input port
    (section 3: "one port takes data from the output register") -- that port
    is what makes single-cycle multiply-accumulate possible, and is the
    accumulator of the section-5.3 matrix mapping.
    """

    out: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((N, N), dtype=np.int16))

    # -- column broadcast ---------------------------------------------------
    def exec_column(self, col: int, ctx_word: int,
                    a: np.ndarray, b: np.ndarray | None) -> None:
        """All 8 cells of ``col`` execute ``ctx_word`` on operand streams.

        ``a``/``b`` are the 8-element operand vectors fed from the frame
        buffer banks (b is None for single-bank broadcasts)."""
        op, imm = decode_context(ctx_word)
        self.out[:, col] = _alu(op, imm, a, b, self.out[:, col])

    # -- row broadcast ------------------------------------------------------
    def exec_row_all(self, ctx_words: list[int], b_row: np.ndarray) -> None:
        """Row-context broadcast used by the section-5.3 matrix mapping.

        Row ``r``'s context word (typically CMAC with immediate A[r, k]) is
        executed by every cell in row ``r``; the operand stream ``b_row`` is
        the broadcast row of B (one element per column).
        """
        for r in range(N):
            op, imm = decode_context(ctx_words[r])
            self.out[r, :] = _alu(op, imm, b_row, None, self.out[r, :])

    def read_column(self, col: int) -> np.ndarray:
        """A copy of column ``col``'s output registers."""
        return self.out[:, col].copy()


def _alu(op: str, imm: int, a: np.ndarray, b: np.ndarray | None,
         acc: np.ndarray) -> np.ndarray:
    """16-bit signed wrap-around ALU (numpy int16 arithmetic wraps)."""
    a16 = np.asarray(a, dtype=np.int16)
    with np.errstate(over="ignore"):
        if op == OP_ADD_AB:
            return (a16 + np.asarray(b, np.int16)).astype(np.int16)
        if op == OP_SUB_AB:
            return (a16 - np.asarray(b, np.int16)).astype(np.int16)
        if op == OP_MUL_AB:
            return (a16 * np.asarray(b, np.int16)).astype(np.int16)
        if op == OP_CMUL:
            return (np.int16(imm) * a16).astype(np.int16)
        if op == OP_CMAC:
            return (acc + np.int16(imm) * a16).astype(np.int16)
        if op == OP_CADD:
            return (a16 + np.int16(imm)).astype(np.int16)
    raise ValueError(op)

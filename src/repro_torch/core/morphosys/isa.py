"""TinyRISC control-ISA subset + cycle accounting.

The port's copy of ``repro/core/morphosys/isa.py``: the same code, the
imports renamed and a one-line docstring on each public name that had
none.  Numpy only, so the port keeps the M1 emulator (the cycle oracle)
without importing the JAX package.

The paper's listings (Tables 1-2) are straight-line TinyRISC programs whose
*line index* is the cycle count: Table 1 occupies addresses 0..96 and Table 5
reports 96 cycles for the 64-element translation; Table 2 occupies 0..55 and
Table 5 reports 55 cycles.  We therefore account

    cycles(program) = len(program) - 1

i.e. the issue time of the last instruction relative to the first, with one
instruction issued per cycle and RC-array / DMA activity overlapped (DMA
completion is represented by explicit ``nop`` wait slots exactly as the
"..." gaps in the paper's tables do).

DMA wait model: Table 1/2 hide 31 wait slots behind each 64-element frame
buffer load, i.e. ~0.484 cycles per 16-bit element.  We generalise to

    dma_wait(n) = max(1, round(31 * n / 64))

which reproduces the paper's published 8-element cycle counts (21 and 14)
as well as the 64-element ones (96 and 55).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.morphosys.rc_array import (
    N, ContextMemory, FrameBuffer, RCArray,
)


def dma_wait(n_elements: int) -> int:
    """Wait slots hidden behind a frame-buffer DMA of ``n_elements`` int16."""
    return max(1, round(31 * n_elements / 64))


@dataclasses.dataclass(frozen=True)
class I:
    """One TinyRISC instruction: mnemonic + operands (kwargs)."""
    op: str
    args: tuple[Any, ...] = ()

    def __repr__(self) -> str:  # readable program dumps
        return f"{self.op} {', '.join(map(str, self.args))}"


Program = list  # list[I]


class Machine:
    """Executes straight-line TinyRISC programs against the M1 datapath."""

    def __init__(self) -> None:
        self.regs = [0] * 16
        self.fb = FrameBuffer()
        self.ctx = ContextMemory()
        self.rc = RCArray()
        # element-addressed main memory for data, word-addressed for contexts
        self.main = {}      # addr -> np.int16 scalar
        self.main_ctx = {}  # addr -> uint32 context word
        self.cycles = 0
        self.trace: list[str] = []

    # -- host-side helpers (not instructions; model the "main memory" that
    #    the TinyRISC program assumes has been DMA'd in from the host) ------
    def poke_vector(self, addr: int, data: np.ndarray) -> None:
        """Store ``data`` as int16 words at ``addr`` of main memory."""
        for i, v in enumerate(np.asarray(data, dtype=np.int16)):
            self.main[addr + i] = np.int16(v)

    def peek_vector(self, addr: int, count: int) -> np.ndarray:
        """Read ``count`` int16 words from ``addr`` of main memory."""
        return np.array([self.main.get(addr + i, np.int16(0)) for i in range(count)],
                        dtype=np.int16)

    def poke_contexts(self, addr: int, words: list[int]) -> None:
        """Store context words at ``addr`` of context main memory."""
        for i, w in enumerate(words):
            self.main_ctx[addr + i] = np.uint32(w)

    # -- execution ----------------------------------------------------------
    def run(self, program: Program) -> int:
        """Execute; returns the paper-style cycle count (len - 1)."""
        for inst in program:
            self._exec(inst)
        self.cycles = len(program) - 1
        return self.cycles

    def _exec(self, inst: I) -> None:
        getattr(self, f"_op_{inst.op}")(*inst.args)
        self.trace.append(repr(inst))

    # -- instruction semantics ----------------------------------------------
    def _op_nop(self) -> None:                       # add r0, r0, r0
        pass

    def _op_ldui(self, rd: int, imm: int) -> None:   # rd <- imm << 16
        self.regs[rd] = (imm & 0xFFFF) << 16

    def _op_ldli(self, rd: int, imm: int) -> None:   # rd[15:0] <- imm
        self.regs[rd] = (self.regs[rd] & 0xFFFF0000) | (imm & 0xFFFF)

    def _op_ldfb(self, addr_reg: int, fb_set: int, bank: int,
                 fb_addr: int, count: int) -> None:
        """DMA ``count`` int16 elements main->frame buffer."""
        src = self.regs[addr_reg]
        data = self.peek_vector(src, count)
        self.fb.write(fb_set, bank, fb_addr, data)

    def _op_ldctxt(self, addr_reg: int, block: str, plane: int,
                   start: int, count: int) -> None:
        src = self.regs[addr_reg]
        words = np.array([self.main_ctx.get(src + i, np.uint32(0))
                          for i in range(count)], dtype=np.uint32)
        self.ctx.load(block, plane, start, words)

    def _op_dbcdc(self, col: int, ctx_word: int, fb_set: int,
                  addr_a: int, addr_b: int) -> None:
        """Double-bank column broadcast (Table 1): col executes ctx on A,B."""
        a = self.fb.read(fb_set, 0, addr_a, N)
        b = self.fb.read(fb_set, 1, addr_b, N)
        self.rc.exec_column(col, self.ctx.get("col", 0, ctx_word), a, b)

    def _op_sbcb(self, col: int, ctx_word: int, fb_set: int,
                 bank: int, addr: int) -> None:
        """Single-bank column broadcast (Table 2): immediate in context."""
        a = self.fb.read(fb_set, bank, addr, N)
        self.rc.exec_column(col, self.ctx.get("col", 0, ctx_word), a, None)

    def _op_sbrb(self, fb_set: int, bank: int, addr: int) -> None:
        """Single-bank *row* broadcast (section 5.3 matrix mapping): every
        row executes its own row-context word on the broadcast B row."""
        b_row = self.fb.read(fb_set, bank, addr, N)
        words = [self.ctx.get("row", 0, r) for r in range(N)]
        self.rc.exec_row_all(words, b_row)

    def _op_wfbi(self, col: int, fb_set: int, addr: int) -> None:
        self.fb.write(fb_set, 1, addr, self.rc.read_column(col))

    def _op_wfbr(self, row: int, fb_set: int, addr: int) -> None:
        """Row-mode write-back used by the matrix mapping."""
        self.fb.write(fb_set, 1, addr, self.rc.out[row, :])

    def _op_stfb(self, addr_reg: int, fb_set: int, fb_addr: int,
                 count: int) -> None:
        dst = self.regs[addr_reg]
        data = self.fb.read(fb_set, 1, fb_addr, count)
        for i, v in enumerate(data):
            self.main[dst + i] = np.int16(v)

"""The port's M1 emulator against the JAX package's and against the
paper's published constants.

``repro_torch.core.morphosys`` is a numpy copy of
``repro.core.morphosys``: for the same seeds the two give the same
values, cycle counts, programs, context words and machine state, and
the same Intel cycle models and Table 5 constants.  Integer arithmetic:
no tolerance.
"""
import dataclasses

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
pytest.importorskip("torch")

from repro.core import morphosys as jax_m
from repro_torch.core import morphosys as m
from repro_torch.core.morphosys import intel, programs, rc_array


def _same_run(got, want) -> None:
    """Two ``RunResult``s agree in values, cycles, program length, the
    instruction trace and the machine's final state."""
    assert got.values.dtype == want.values.dtype == np.int16
    assert np.array_equal(got.values, want.values)
    assert got.cycles == want.cycles
    assert got.n_instructions == want.n_instructions
    assert got.machine.trace == want.machine.trace
    assert np.array_equal(got.machine.fb.mem, want.machine.fb.mem)
    assert np.array_equal(got.machine.rc.out, want.machine.rc.out)
    assert np.array_equal(got.machine.ctx.col, want.machine.ctx.col)
    assert np.array_equal(got.machine.ctx.row, want.machine.ctx.row)
    assert got.machine.regs == want.machine.regs


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_translation_and_scaling_equal_reference(n):
    rng = np.random.default_rng([41, n])
    u = rng.integers(-30000, 30000, n)
    v = rng.integers(-30000, 30000, n)
    _same_run(programs.run_translation(u, v),
              jax_m.programs.run_translation(u, v))
    for c in (5, -3, 127):
        _same_run(programs.run_scaling(u, c),
                  jax_m.programs.run_scaling(u, c))
    assert np.array_equal(programs.run_translation(u, v).values,
                          programs.oracle_translation(u, v))
    assert np.array_equal(programs.run_scaling(u, 5).values,
                          programs.oracle_scaling(u, 5))


@pytest.mark.parametrize("rows,inner", [(8, 8), (2, 2), (5, 3), (1, 8)])
def test_matmul_equals_reference(rows, inner):
    rng = np.random.default_rng([42, rows, inner])
    a = rng.integers(-127, 128, (rows, inner))
    b = rng.integers(-1000, 1000, (inner, 8))
    got = programs.run_matmul(a, b)
    _same_run(got, jax_m.programs.run_matmul(a, b))
    assert np.array_equal(got.values, programs.oracle_matmul(a, b))
    assert [repr(i) for i in programs.matmul_program(rows, inner)] \
        == [repr(i) for i in jax_m.programs.matmul_program(rows, inner)]


def test_rotation_points_equal_reference():
    rng = np.random.default_rng(43)
    pts = rng.integers(-100, 100, (2, 8))
    got = programs.run_rotation_points((3, 4), pts)
    _same_run(got, jax_m.programs.run_rotation_points((3, 4), pts))
    rot = np.array([[3, -4], [4, 3]])
    assert np.array_equal(got.values, programs.oracle_matmul(rot, pts))


def test_wrap_around_equals_reference():
    u = np.full(8, 32767, np.int16)
    got = programs.run_translation(u, np.ones(8, np.int16))
    _same_run(got, jax_m.programs.run_translation(u, np.ones(8, np.int16)))
    assert (got.values == -32768).all()
    big = np.full((2, 2), 127)
    pts = np.full((2, 8), 30000)
    _same_run(programs.run_matmul(big, pts),
              jax_m.programs.run_matmul(big, pts))


@pytest.mark.parametrize("op", [rc_array.OP_ADD_AB, rc_array.OP_SUB_AB,
                                rc_array.OP_MUL_AB, rc_array.OP_CMUL,
                                rc_array.OP_CMAC, rc_array.OP_CADD])
def test_context_words_equal_reference(op):
    for imm in (0, 5, -4, 127, -128):
        word = rc_array.encode_context(op, imm)
        assert word == jax_m.rc_array.encode_context(op, imm)
        assert rc_array.decode_context(word) \
            == jax_m.rc_array.decode_context(word)


def test_published_context_words():
    # Table 1: Out = A + B -> 0x0000F400; Table 2: Out = 5 x A -> 0x00009005
    assert m.encode_context(rc_array.OP_ADD_AB) == 0xF400
    assert m.decode_context(0x0000F400) == (rc_array.OP_ADD_AB, 0)
    assert m.encode_context(rc_array.OP_CMUL, 5) == 0x9005
    assert m.decode_context(0x00009005) == (rc_array.OP_CMUL, 5)


@pytest.mark.parametrize("algorithm,n,published,matches", [
    ("translation", 8, 21, True), ("translation", 64, 96, True),
    ("scaling", 8, 14, True), ("scaling", 64, 55, True),
    ("rotation_matmul", 64, 256, False), ("composite_ii", 16, 70, False),
])
def test_cycles_against_the_paper(algorithm, n, published, matches):
    """Table 5's M1 rows: the listings the paper prints reproduce exactly;
    the two matrix routines have no listing and our reconstruction is
    faster (90 and 25 cycles), as in ``tests/test_morphosys.py``."""
    ones = np.ones
    run = {"translation": lambda: programs.run_translation(ones(n), ones(n)),
           "scaling": lambda: programs.run_scaling(ones(n), 5),
           "rotation_matmul": lambda: programs.run_matmul(
               ones((8, 8), np.int16), ones((8, 8), np.int16)),
           "composite_ii": lambda: programs.run_rotation_points(
               (1, 1), ones((2, 8), np.int16))}[algorithm]
    cycles = run().cycles
    assert intel.paper_row(algorithm, "m1", n).cycles == published
    assert (cycles == published) == matches
    assert cycles == {("rotation_matmul", 64): 90,
                      ("composite_ii", 16): 25}.get((algorithm, n), published)


@pytest.mark.parametrize("cpu", ["80486", "80386"])
def test_intel_models_equal_reference(cpu):
    for n in (1, 8, 17, 64):
        assert intel.translation_cycles(cpu, n) \
            == jax_m.intel.translation_cycles(cpu, n)
        assert intel.scaling_cycles(cpu, n) \
            == jax_m.intel.scaling_cycles(cpu, n)
        assert intel.time_us(cpu, 1000) == jax_m.intel.time_us(cpu, 1000)
    # Table 4 exact; Table 3's 8-element totals exact
    assert intel.scaling_cycles(cpu, 64) == intel.paper_row(
        "scaling", cpu, 64).cycles
    assert intel.translation_cycles(cpu, 8) == intel.paper_row(
        "translation", cpu, 8).cycles


def test_paper_table5_equals_reference():
    assert [dataclasses.astuple(r) for r in intel.PAPER_TABLE5] \
        == [dataclasses.astuple(r) for r in jax_m.intel.PAPER_TABLE5]
    assert intel.CLOCK_MHZ == jax_m.intel.CLOCK_MHZ
    for row in intel.PAPER_TABLE5:
        if row.speedup is not None:
            m1 = intel.paper_row(row.algorithm, "m1", row.n_elements).cycles
            assert row.cycles / m1 == pytest.approx(row.speedup, rel=0.02)

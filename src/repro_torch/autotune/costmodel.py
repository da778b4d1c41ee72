"""Analytic per-kernel cost models: the paper's methodology as a pruner.

The port of ``repro/autotune/costmodel.py``.  The source paper's loop is
map -> predict analytically -> validate on the emulator; this module is
the "predict" step.  Every tunable kernel gets a closed-form cost built
from the same byte accounting ``repro_torch.kernels.opcount`` records at
run time, plus FLOPs and a per-launch cost.  The tuner uses these
predictions to PRUNE the candidate space before timing it.

What is the JAX package's, unchanged, so that both packages give equal
numbers for every input: the byte and FLOP accounting
(``chain_param_bytes``, ``_chain_flops_per_point``, the ``hbm_bytes`` and
``flops`` of ``chain_cost`` and ``packed_chain_cost``), ``predict_launch``,
``grid_cost``'s launches and bytes, ``workload_shape``, and the paper
cross-checks ``morphosys_cycles``, ``m1_chain_cycles`` and ``perf_rows``
(on the port's own ``core.morphosys`` and ``core.analysis``).

What is the card's: the scoring (``CostEstimate.predicted_us``) and the
feasibility of a candidate.  A launch costs the H100's HBM time for its
bytes (or its tensor-core time, for ``matmul_2d``), a per-launch cost,
and a tail: a grid of G blocks over the R the card holds at once runs
ceil(G/R) waves, the last one partly empty.  Feasibility is Hopper's:
``matmul_2d``'s ring must fit a block's dynamic shared memory,
``rmsnorm_2d``'s warps must hold the row in registers, a chain kernel's
block must be a block the card launches.  The model needs the
candidates' ORDER right, not their times: the timer decides.
"""
from __future__ import annotations

import dataclasses
import math
import typing

from repro_torch.autotune.cache import DEFAULTS, KernelConfig, merge
from repro_torch.core import analysis
from repro_torch.core.morphosys.isa import dma_wait
from repro_torch.core.morphosys.rc_array import N as RC_N

#: one kernel launch's cost: the ~5 us floor a launch showed on the card
#: (PERF.md section 6, "PRs 11-22": "a launch has a ~0.005 ms floor")
LAUNCH_OVERHEAD_US = 5.0
#: one serving bucket's cost, mostly host (pack, staging, unpack): the
#: mixed flush took 151.0 ms for 112 launches on an H100 (PERF.md section
#: 5, chip run 6 of PR 16), about 1.35 ms a bucket -- what makes "fewer
#: launches" beat "fewer padded bytes" in the grid model
GRID_LAUNCH_US = 151.0e3 / 112
#: per-block cost inside one launch: the card schedules blocks in
#: hardware, so none is charged; the term keeps the reference's form
STEP_OVERHEAD_US = 0.0
#: H100 SXM HBM3 rate (NVIDIA data sheet)
MODEL_BW = 3.35e12
#: H100 SXM dense peaks (NVIDIA data sheet, 700 W): bfloat16 on the
#: tensor cores, float32 on the CUDA cores
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12

#: Hopper's limits (the H100 column of the Hopper architecture white
#: paper): SMs, threads and blocks an SM, threads a block, and the
#: dynamic shared memory a block may use
SMS = 132
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
MAX_BLOCK_THREADS = 1024
SMEM_BYTES = 232_448
#: the chain kernels' launch constants (``csrc/launch.cuh``): the scalar
#: kernels' grid cap and the 16-byte kernels' block; a 16-byte kernel's
#: block walks about VEC_CHUNK vectors a step (its kUnroll * kVecThreads)
MAX_BLOCKS_X = 4096
MAX_BLOCKS_Y = 1024
VEC_THREADS = 128
VEC_CHUNK = 4 * VEC_THREADS
#: ``csrc/matmul_2d.cu``'s wgmma tile: 128 rows, 64-deep K panels of 128
#: swizzled bytes a row; A_BYTES a stage for X, BK * 128 * BN / 64 for Y,
#: plus 1024 bytes of alignment slack (``Tile<BN>::SMEM``)
MM_BM, MM_BK, MM_PANEL = 128, 64, 128
MM_A_BYTES = MM_BM * MM_PANEL


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """One candidate's analytic cost.  ``predicted_us`` is the pruning
    score: the launches' cost + grid-step cost + streaming time + the
    last wave's tail.  ``bucket_launches`` charges a launch the serving
    bucket's cost (``GRID_LAUNCH_US``) instead of a kernel's;
    ``waves`` is the grid in waves of resident blocks (0: no tail term);
    ``peak_ops`` adds a compute floor (the streaming time is the larger
    of bytes over HBM and operations over the peak)."""
    kernel: str
    hbm_bytes: int
    flops: int
    launches: int
    grid_steps: int
    feasible: bool = True
    bucket_launches: bool = False
    waves: float = 0.0
    peak_ops: float | None = None

    @property
    def stream_us(self) -> float:
        """The bytes over HBM's rate, or the operations over the peak."""
        us = self.hbm_bytes / MODEL_BW * 1e6
        if self.peak_ops:
            us = max(us, self.flops / self.peak_ops * 1e6)
        return us

    @property
    def tail_us(self) -> float:
        """The idle share of the last wave: stream time x (ceil(w)/w - 1)."""
        if self.waves <= 0:
            return 0.0
        return self.stream_us * (math.ceil(self.waves) / self.waves - 1.0)

    @property
    def predicted_us(self) -> float:
        """The pruning score (inf when infeasible)."""
        if not self.feasible:
            return math.inf
        per_launch = GRID_LAUNCH_US if self.bucket_launches \
            else LAUNCH_OVERHEAD_US
        return (self.launches * per_launch
                + self.grid_steps * STEP_OVERHEAD_US
                + self.stream_us + self.tail_us)


def _cfg(kernel: str, config: KernelConfig | None) -> KernelConfig:
    base = DEFAULTS.get(kernel, KernelConfig(kernel))
    return base if config is None else merge(base, config)


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def resident_blocks(threads: int) -> int:
    """Blocks of ``threads`` the card holds at once, by its thread and
    block limits (the chain kernels use few registers, so registers do
    not bound them)."""
    return SMS * min(BLOCKS_PER_SM, THREADS_PER_SM // threads)


def _grid(work: int, threads: int, waves: int | None, rows: int = 1,
          per_block: int = 1) -> tuple[int, float]:
    """(blocks, waves) of a grid-stride launch over ``rows`` rows of
    ``work`` units, ``per_block`` units a block a step: x capped at
    MAX_BLOCKS_X, or, for ``waves``, so that the grid is that many waves
    of resident blocks (``csrc/launch.cuh``'s ``scalar_grid`` and
    ``row_grid``)."""
    gy = min(max(1, rows), MAX_BLOCKS_Y)
    cap = MAX_BLOCKS_X if waves is None \
        else max(1, waves * resident_blocks(threads) // gy)
    gx = min(max(1, _cdiv(work, per_block)), cap)
    return gx * gy, gx * gy / resident_blocks(threads)


# -- chain kernels (the paper's one-pass composite) ---------------------------

#: plan kind -> (single-chain kernel, batched kernel).  The ``_q`` kinds
#: are the int16 fixed-point lane: same maths, 2-byte words.
_CHAIN_KERNELS = {"diag": ("chain_diag", "chain_diag_batch"),
                  "matrix": ("chain_apply", "chain_apply_batch"),
                  "projective": ("chain_project", "chain_project_batch"),
                  "diag_q": ("chain_diag_q", "chain_diag_batch_q"),
                  "matrix_q": ("chain_apply_q", "chain_apply_batch_q")}

#: ``csrc/chain_project.cu``: from this many points (on aligned buffers)
#: ``chain_project_1d`` takes its 16-byte kernel
PROJECT_VEC_POINTS = 1 << 19


def _base_kind(kind: str) -> str:
    """The plan-kind lattice rung of a (possibly fixed-point) cost kind:
    byte passes and parameter-word counts come from the ONE ``opcount``
    table keyed by the base kind; the ``_q`` suffix only halves the word
    size."""
    return kind[:-2] if kind.endswith("_q") else kind


def _kind_itemsize(kind: str, itemsize: int | None) -> int:
    return itemsize if itemsize is not None else \
        (2 if kind.endswith("_q") else 4)


def chain_param_bytes(d: int, kind: str, itemsize: int = 4) -> int:
    """Composed-parameter bytes of one folded chain: (d,d)+(d,) words for a
    matrix plan, (d,)+(d,) for a diagonal plan, (d+1)^2 + 2d (homogeneous
    H plus cull bounds) for a projective plan -- delegating to the ONE
    table in ``opcount`` that ``TransformChain.apply`` and the serving
    engine also record from."""
    from repro_torch.kernels import opcount   # late: keep imports one-way
    return opcount.chain_param_words(d, _base_kind(kind)) * itemsize


def _chain_flops_per_point(d: int, kind: str) -> int:
    """Work per point: one MAC for diag lanes, 2d-1 rolled MACs for
    matrix lanes, and for projective lanes a second MAC set (the
    homogeneous w), the divide, and the cull compares.  The fixed-point
    kinds run the same MAC schedule (in int32)."""
    kind = _base_kind(kind)
    if kind == "diag":
        return 2 * d
    if kind == "matrix":
        return 2 * (2 * d - 1) * d
    return (4 * (2 * d - 1) + 4) * d


def _chain_passes(kind: str) -> int:
    from repro_torch.kernels import opcount   # late: keep imports one-way
    return opcount.chain_passes(_base_kind(kind))


def _chain_feasible(cfg: KernelConfig) -> bool:
    bt = cfg.block_threads
    return (bt is None or (32 <= bt <= MAX_BLOCK_THREADS and bt % 32 == 0)) \
        and (cfg.waves is None or cfg.waves >= 1)


def chain_cost(n_points: int, d: int, kind: str,
               config: KernelConfig | None = None, *,
               itemsize: int | None = None) -> CostEstimate:
    """One fused single-chain launch over (N, d) points: the point buffer
    moves once in, once out (plus the mask pass for projective plans),
    plus the O(1) composed parameters.  ``itemsize`` defaults by kind: 4
    bytes on the float kinds, 2 on the ``_q`` (int16 Qm.n) kinds.  The
    grid is the kernel's: a thread an element (diag) or a point, or, for
    ``chain_project_1d`` from 2^19 points, its 16-byte kernel's groups of
    four points."""
    from repro_torch.kernels import opcount   # late: keep imports one-way
    kernel = _CHAIN_KERNELS[kind][0]
    itemsize = _kind_itemsize(kind, itemsize)
    cfg = _cfg(kernel, config)
    nbytes = opcount.fused_chain_bytes(n_points, d, itemsize=itemsize,
                                       kind=_base_kind(kind))
    flops = n_points * _chain_flops_per_point(d, kind)
    if _base_kind(kind) == "projective" and n_points >= PROJECT_VEC_POINTS:
        steps, waves = _grid(n_points // 4, VEC_THREADS, cfg.waves or 1,
                             per_block=VEC_CHUNK)
    else:
        work = n_points * d if _base_kind(kind) == "diag" else n_points
        threads = cfg.block_threads or 256
        steps, waves = _grid(work, threads, cfg.waves, per_block=threads)
    return CostEstimate(kernel, nbytes, flops, launches=1, grid_steps=steps,
                        feasible=_chain_feasible(cfg), waves=waves)


def batch_takes_vectors(kind: str, lpad: int, d: int) -> bool:
    """Whether a packed (B, lpad, d) batch of plan ``kind`` runs its
    batch kernel's 16-byte kernel, by the C entries' rule on the row
    (the packed buffers are fresh, 16-byte-aligned allocations): L * d
    floats a multiple of 4 (diag), L even at d = 2 and a multiple of 4
    at d = 3 (matrix), L a multiple of 4 (projective), L * d words a
    multiple of 8 (the ``_q`` kinds)."""
    if kind.endswith("_q"):
        return lpad * d % 8 == 0
    if kind == "diag":
        return lpad * d % 4 == 0
    if kind == "matrix":
        return lpad % (2 if d == 2 else 4) == 0
    return lpad % 4 == 0


def packed_chain_cost(bsz: int, lpad: int, d: int, kind: str,
                      config: KernelConfig | None = None, *,
                      itemsize: int | None = None) -> CostEstimate:
    """One packed-bucket launch (B requests padded to L points): the same
    byte count ``opcount.packed_chain_bytes`` records per serving launch.
    ``itemsize`` defaults by kind (2-byte words on the ``_q`` kinds).  The
    grid is the 16-byte kernel's (a request a block row, one wave, or
    ``waves``) where ``batch_takes_vectors``, else the scalar one's."""
    from repro_torch.kernels import opcount   # late: keep imports one-way
    kernel = _CHAIN_KERNELS[kind][1]
    itemsize = _kind_itemsize(kind, itemsize)
    cfg = _cfg(kernel, config)
    nbytes = opcount.packed_chain_bytes(bsz, lpad, d, itemsize=itemsize,
                                        kind=_base_kind(kind))
    flops = bsz * lpad * _chain_flops_per_point(d, kind)
    if batch_takes_vectors(kind, lpad, d):
        steps, waves = _grid(lpad * d * itemsize // 16, VEC_THREADS,
                             cfg.waves or 1, rows=bsz, per_block=VEC_CHUNK)
    else:
        threads = cfg.block_threads or 256
        work = lpad * d if _base_kind(kind) == "diag" else lpad
        steps, waves = _grid(work, threads, cfg.waves, rows=bsz,
                             per_block=threads)
    return CostEstimate(kernel, nbytes, flops, launches=1, grid_steps=steps,
                        feasible=_chain_feasible(cfg), waves=waves)


@dataclasses.dataclass(frozen=True)
class LaunchPrediction:
    """The cost model's view of ONE dispatched serving launch, attached
    to the launch's trace instant at dispatch time (``serving.engine.
    _count_launch``) so the profiler can fold predicted-vs-observed
    ratios out of the span stream.

    ``hbm_bytes`` and ``flops`` come from ``packed_chain_cost``, whose
    byte formula IS ``opcount.packed_chain_bytes`` -- the same number the
    engine records as the launch's observed ``hbm_bytes`` -- so the
    byte ratio is exactly 1.0 by construction, and any drift between the
    two is a real accounting bug, not model error.  ``m1_cycles`` is the
    paper-methodology projection (``m1_chain_cycles``): what this launch
    would cost on the M1 array.
    """
    kernel: str
    hbm_bytes: int
    flops: int
    m1_cycles: int


def predict_launch(kind: str, bsz: int, lpad: int, d: int, *,
                   qformat: str | None = None,
                   itemsize: int | None = None) -> LaunchPrediction:
    """Predict one packed-bucket launch (B requests padded to L points)
    of a serving plan: the per-launch prediction API the engine calls at
    dispatch time.  ``kind`` is the plan kind (``diag`` / ``matrix`` /
    ``projective``); a non-None ``qformat`` selects the int16 ``_q``
    cost kind (2-byte words), mirroring how the engine's plans carry
    the format separately from the kind."""
    cost_kind = kind if kind.endswith("_q") or qformat is None \
        else kind + "_q"
    est = packed_chain_cost(bsz, lpad, d, cost_kind, itemsize=itemsize)
    return LaunchPrediction(kernel=est.kernel, hbm_bytes=est.hbm_bytes,
                            flops=est.flops,
                            m1_cycles=m1_chain_cycles(cost_kind,
                                                      bsz * lpad, d))


# -- matmul / rmsnorm ---------------------------------------------------------

def matmul_bn(m: int, n: int, config: KernelConfig | None = None) -> int:
    """The wgmma tile width ``matmul_2d`` runs: the config's ``bn``, else
    the kernel's SM-fill choice (128 unless 128-wide tiles would leave
    SMs without a tile, then 64; ``csrc/matmul_2d.cu``'s ``wg::launch``)."""
    bn = _cfg("matmul", config).bn
    if bn is not None:
        return bn
    return 128 if _cdiv(m, MM_BM) * _cdiv(n, 128) >= SMS else 64


def matmul_smem(bn: int, stages: int) -> int:
    """Dynamic shared memory of ``matmul_2d``'s wgmma block: ``stages``
    X and Y panels plus the alignment slack (``Tile<BN>::SMEM``)."""
    return stages * (MM_A_BYTES + MM_BK * MM_PANEL * (bn // 64)) + 1024


def matmul_cost(m: int, k: int, n: int, config: KernelConfig | None = None,
                *, itemsize: int = 2) -> CostEstimate:
    """``matmul_2d``'s wgmma regime: operands move once, 2mkn FLOPs at
    the tensor cores' bf16 peak (float32's CUDA-core peak for 4-byte
    inputs), one 128 x BN tile a block, one block an SM (its ring takes
    most of the SM's shared memory), so a grid of T tiles runs T / 132
    waves.  Feasible when BN is 64 or 128, the ring has at least 2
    stages and it fits a block's 232 448 bytes of shared memory."""
    cfg = _cfg("matmul", config)
    bn, stages = matmul_bn(m, n, config), cfg.stages or 4
    tiles = _cdiv(m, MM_BM) * _cdiv(n, bn)
    feasible = bn in (64, 128) and stages >= 2 \
        and matmul_smem(bn, stages) <= SMEM_BYTES
    return CostEstimate("matmul", (m * k + k * n + m * n) * itemsize,
                        2 * m * k * n, launches=1,
                        grid_steps=tiles * _cdiv(k, MM_BK),
                        feasible=feasible, waves=tiles / SMS,
                        peak_ops=BF16_OPS_PER_S if itemsize == 2
                        else FP32_OPS_PER_S)


def rmsnorm_warps(m: int, nv: int) -> int:
    """``rmsnorm_2d``'s own warps a row for rows of ``nv`` 16-byte
    vectors (``csrc/rmsnorm.cu``'s ``warps_for``): the least power of two
    whose lanes hold the row at MAX_VEC a lane; for fewer rows than SMs,
    enough for one vector a lane (at most MAX_WARPS)."""
    from repro_torch.kernels.rmsnorm import rmsnorm as K   # late: one-way
    w = 1
    while 32 * w * K.MAX_VEC < nv:
        w *= 2
    if m < SMS:
        while w < K.MAX_WARPS and 32 * w < nv:
            w *= 2
    return w


def rmsnorm_cost(m: int, n: int, config: KernelConfig | None = None, *,
                 itemsize: int = 4) -> CostEstimate:
    """Fused rmsnorm: one read + one write of (M, N) plus the (N,) float32
    gain.  The 16-byte kernel takes a row a group of W warps (four rows a
    block at W = 1), so M rows make M / 4 or M blocks of 32 W (128 at
    W = 1) threads; infeasible where W warps cannot hold the row."""
    from repro_torch.kernels.rmsnorm import rmsnorm as K   # late: one-way
    cfg = _cfg("rmsnorm", config)
    nv = n * itemsize // 16
    w = cfg.row_warps or rmsnorm_warps(m, nv)
    threads = 128 if w == 1 else 32 * w
    blocks = _cdiv(m, 4) if w == 1 else m
    return CostEstimate("rmsnorm", 2 * m * n * itemsize + n * 4, 4 * m * n,
                        launches=1, grid_steps=blocks,
                        feasible=n * itemsize % 16 == 0
                        and K.row_warps_ok(w, nv),
                        waves=blocks / resident_blocks(threads))


# -- serving size grid --------------------------------------------------------

def grid_cost(requests: typing.Sequence[tuple[typing.Hashable, str, int, int]],
              min_len: int, waste_cap: float, *,
              itemsize: int = 4) -> CostEstimate:
    """Analytic cost of serving one workload under a candidate size grid.

    ``requests`` is ``(structure_key, kind, d, n_points)`` per request --
    the shape of the workload, no point data needed.  The model replays
    the engine's bucketing ((structure, padded length) -> one launch) and
    charges each bucket its packed byte volume plus the per-bucket cost:
    exactly the trade the grid knobs steer (a coarser grid means fewer
    launches but more padded bytes).
    """
    from repro_torch.kernels import opcount
    from repro_torch.serving import bucketing
    buckets: dict[tuple, list[tuple[str, int, int]]] = {}
    for skey, kind, d, n in requests:
        if n <= 0:
            continue
        lpad = bucketing.padded_length(n, min_len=min_len,
                                       waste_cap=waste_cap)
        buckets.setdefault((skey, lpad), []).append((kind, d, n))
    nbytes = 0
    flops = 0
    for (_skey, lpad), reqs in buckets.items():
        kind, d, _ = reqs[0]
        nbytes += opcount.packed_chain_bytes(len(reqs), lpad, d,
                                             itemsize=itemsize, kind=kind)
        flops += len(reqs) * lpad * _chain_flops_per_point(d, kind)
    return CostEstimate("serving_grid", nbytes, flops,
                        launches=len(buckets), grid_steps=len(buckets),
                        bucket_launches=True)


def workload_shape(reqs) -> list[tuple[typing.Hashable, str, int, int]]:
    """Project a ``[(chain, points), ...]`` workload to the shape tuples
    ``grid_cost`` consumes (structure key, plan kind, dim, point count)."""
    out = []
    for chain, pts in reqs:
        n = int(pts.size // chain.dim)
        out.append((chain.structure, chain.plan_kind, chain.dim, n))
    return out


# -- paper cross-check: MorphoSys cycle model ---------------------------------

def morphosys_cycles(routine: str, n: int) -> int:
    """Closed-form cycle count for the paper's TinyRISC listings.

    Program structure (Tables 1-2, generalised to n a multiple of 8):
    frame-buffer loads of 2 + dma_wait(n) slots each, a 5-slot context
    load, the per-column compute/writeback instructions, and the 2-slot
    store; cycles = instructions - 1.  Reproduces the published Table 5
    numbers (96/21 translation, 55/14 scaling) and the emulator exactly.
    """
    if n % RC_N or n <= 0:
        raise ValueError(f"n must be a positive multiple of {RC_N}, got {n}")
    ncols = n // RC_N
    if routine == "translation":       # two operand loads; ldli+dbcdc+wfbi
        length = 2 * (2 + dma_wait(n)) + 5 + 3 * ncols + 2
    elif routine == "scaling":         # one operand load; sbcb+wfbi
        length = (2 + dma_wait(n)) + 5 + 2 * ncols + 2
    else:
        raise ValueError(f"no closed form for routine {routine!r}")
    return length - 1


def m1_chain_cycles(kind: str, n_points: int, d: int) -> int:
    """Projected M1 cycle count for one packed chain launch: the
    Tables 1-2 program skeleton generalised beyond the paper's two
    routines.  The element stream (``n_points * d`` words, padded to a
    multiple of the RC-array width) loads through the frame buffer in
    ``chain_passes(kind)`` operand passes of ``2 + dma_wait`` slots
    each, a 5-slot context load configures the array, each 8-element
    column spends one instruction slot per MAC-pair of the kind's
    per-point schedule plus the writeback, and the 2-slot store drains;
    cycles = instructions - 1, exactly the ``morphosys_cycles``
    accounting.  This is a PROJECTION (the paper only published the
    translation/scaling listings, which ``morphosys_cycles`` reproduces
    exactly) -- deterministic, monotone in the launch shape, and used
    for attribution, never for gating against the emulator."""
    base = _base_kind(kind)
    if base not in ("diag", "matrix", "projective"):
        raise ValueError(f"no M1 projection for plan kind {kind!r}")
    n = max(RC_N, _cdiv(max(1, n_points) * d, RC_N) * RC_N)
    ncols = n // RC_N
    per_col = _chain_flops_per_point(d, base) // (2 * d) + 1
    length = (_chain_passes(base) * (2 + dma_wait(n)) + 5
              + per_col * ncols + 2)
    return length - 1


def perf_rows() -> list[analysis.PerfRow]:
    """The analytic predictions in the paper's table format (source
    ``model``), for the 8- and 64-element cases the paper publishes --
    directly comparable against the emulator's rows."""
    rows = []
    for routine in ("translation", "scaling"):
        for n in (8, 64):
            rows.append(analysis.derive(routine, "m1", n,
                                        morphosys_cycles(routine, n),
                                        source="model"))
    return rows


# -- pruning ------------------------------------------------------------------

def prune(candidates: typing.Sequence[KernelConfig],
          cost_fn: typing.Callable[[KernelConfig], CostEstimate],
          keep: int) -> list[KernelConfig]:
    """Top-``keep`` candidates by predicted cost.  Deterministic: ties
    break on the candidate's persisted field repr, and infeasible
    candidates never survive."""
    scored = [(cost_fn(c).predicted_us, repr(sorted(c.key_fields().items())),
               c) for c in candidates]
    scored = [s for s in scored if s[0] != math.inf]
    scored.sort(key=lambda s: (s[0], s[1]))
    return [c for _, _, c in scored[:max(1, keep)]]

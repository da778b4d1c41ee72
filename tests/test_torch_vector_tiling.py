"""The 16-byte kernels of ``chain_diag_batch_2d``, ``affine_2d``,
``chain_project_1d``, ``rope_3d``, ``chain_matrix_batch_2d_q``,
``chain_matrix_batch_2d``, ``chain_diag_batch_2d_q`` and
``chain_project_batch_2d``, held on the CPU.

Their CUDA kernels (``csrc/chain_diag.cu``, ``csrc/affine_2d.cu``,
``csrc/chain_project.cu``, ``csrc/rope.cu``, ``csrc/chain_fixedpoint.cu``,
``csrc/chain_matrix.cu``) run only on the card, so here each kernel's mapping from (block, thread,
unroll step, vector lane) to (request, element, column) is emulated in
eager torch, with the launch geometry of its C entry:

  * ``chain_diag_vec_kernel``: a block row per request (striding over B
    past 1024), chunks of 4 x 128 float4 vectors of the request's row,
    lane k of vector v on column (4v + k) mod d -- for d = 3 the phase
    v % 3 picks one of three patterns;
  * ``affine_flat_kernel`` (N divides the width W): the same chunks over
    the flat buffer, lane k on column k mod N, the last total % W
    elements by the scalar kernel;
  * ``affine_col_kernel`` (N a multiple of W): a thread a column vector,
    stepping over rows, lane k of column vector cv on column cv W + k;
  * ``affine_2d_kernel`` (everything else): one element a thread a grid-
    stride step, its column j mod N taken once and stepped by the stride
    mod N;
  * ``chain_project_vec_kernel`` (aligned buffers of 2**19 points or
    more): the same chunks of 4 x 128 groups of four points, a warp's 32
    groups read lane by lane into shared memory (slot k 32 + lane holds
    vector k 32 + lane of the warp's 32 d), lane l taking slots l d ..
    l d + d - 1 -- its group's four points -- and writing the results
    back there and its four mask bytes as word q; the last N mod 4 points
    one a thread of the first block.  The mapping does not depend on N,
    so it is emulated at small N as well;
  * ``rope_vec_kernel`` (a half row of a multiple of 16 bytes on aligned
    buffers): thread (tx, ty, tz) of block (bx, by) on vector tx of the
    half row at position bx py + ty (py positions a tile), in heads by hz
    + tz, + gy hz, ... (hz heads a block: one in prefill, up to 64 for a
    decode step); x1, x2, cos and sin read as vectors at one column;
  * ``chain_matrix_batch_q_vec_kernel`` (rows of a multiple of 8 int16
    words on aligned buffers): a block row per request, chunks of groups
    of whole points -- one vector, 4 points, at d = 2; three vectors, 8
    points, at d = 3, a warp's 32 groups staged as the project kernel
    stages them;
  * ``chain_matrix_batch_vec_kernel`` (rows of whole groups on aligned
    buffers: L even at d = 2, a multiple of 4 at d = 3): the same, on
    float4 vectors -- one vector, 2 points, at d = 2; three, 4 points, at
    d = 3;
  * ``chain_diag_batch_q_vec_kernel`` (rows of a multiple of 8 int16
    words on aligned buffers): ``chain_diag_vec_kernel``'s map on vectors
    of 8 words, word k of vector v on column (8v + k) mod d -- for d = 3
    the phase v % 3 picks one of three patterns -- and the kernel's
    uint32 arithmetic, the rounding constant folded into t << n and a
    logical final shift;
  * ``chain_project_batch_vec_kernel`` (rows of whole groups of four
    points on aligned buffers): ``chain_matrix_batch_vec_kernel``'s walk
    on ``chain_project_vec_kernel``'s groups -- four points in d float4
    vectors, staged at d = 2 and d = 3 alike -- each lane also writing
    its group's mask word b L/4 + g.

Each emulation must cover every element exactly once, pick the regime the
C entry picks, and, computing each element with the same rounded ops
(``x * s``, then ``+ t``; ``ref.chain_project``'s sequence on the
gathered points; ``ref.rope``'s and ``ref.chain_matrix_batch_q``'s on the
gathered vectors), equal ``ref.chain_diag_batch`` / ``ref.affine`` /
``ref.chain_project`` / ``ref.rope`` / ``ref.chain_matrix_batch_q`` /
``ref.chain_matrix_batch`` / ``ref.chain_diag_batch_q`` /
``ref.chain_project_batch`` bit for bit, masks included.  A planted fault
-- a d = 3 phase off by one, a column pattern shifted by one, a column
step left unreduced, a chunk stride one step short, a chunk stride one
group short, staged slots read at a stride of 1, a position tile one
short, x2 read one vector off, a request's row of mask words one group
short -- must be caught.  Each grid
is emulated at the card's size and at a tiny one, so every grid-stride
loop takes several steps.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro_torch.kernels.affine import ref as diag_ref
from repro_torch.kernels.fixedpoint import ref as q_ref
from repro_torch.kernels.matmul import ref as matrix_ref
from repro_torch.kernels.projective import ref as proj_ref
from repro_torch.serving import bucketing
from repro_torch.kernels.rope import ref as rope_ref

#: the launch constants of the C entries (csrc/launch.cuh and the two
#: sources): the vector kernels' unroll and block, the scalar kernels'
#: block and grid caps
UNROLL, VEC_THREADS = 4, 128
SCALAR_THREADS, MAX_BLOCKS_X, MAX_BLOCKS_Y, MAX_GRID_Y = 256, 4096, 1024, 65535
#: (resident blocks of a vector kernel, the scalar kernel's block cap): an
#: H100's 132 SMs x 16 blocks of 128 threads, and a tiny grid
GRIDS = {"card": (132 * 16, MAX_BLOCKS_X), "tiny": (3, 3)}
CHUNK = UNROLL * VEC_THREADS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ar(n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64)


def _covered_once(elems: torch.Tensor, total: int) -> bool:
    return elems.numel() == total and bool(
        (torch.bincount(elems, minlength=total) == 1).all())


def _chunked(nvec: int, grid: int, stride_short: int = 0) -> torch.Tensor:
    """The vectors the chunked grid-stride loop of ``vecadd_vec_kernel``'s
    layout visits: block bx, thread tid, step i, unroll u take vector
    bx*CHUNK + tid + i*grid*CHUNK + u*VEC_THREADS while it is < nvec
    (``stride_short`` shortens the stride: a planted fault)."""
    stride = grid * CHUNK - stride_short
    steps = _cdiv(nvec, stride) + 1
    v = (_ar(grid)[:, None, None, None] * CHUNK
         + _ar(steps)[None, :, None, None] * stride
         + _ar(UNROLL)[None, None, :, None] * VEC_THREADS
         + _ar(VEC_THREADS)[None, None, None, :]).reshape(-1)
    return v[v < nvec]


# -- chain_diag_batch_2d -------------------------------------------------------

def diag_vector_path(row: int, aligned: bool) -> bool:
    """``chain_diag_batch_2d``'s choice: the vector kernel for a row of a
    multiple of 4 floats under 2**31 vectors on 16-byte-aligned x and y."""
    return aligned and row % 4 == 0 and row // 4 < 2 ** 31


def diag_vec_grid(bsz: int, nv: int, resident: int) -> tuple[int, int]:
    """``launch_diag_vec``'s (grid x, grid y)."""
    gy = min(bsz, MAX_BLOCKS_Y)
    return min(_cdiv(nv, CHUNK), max(resident // gy, 1)), gy


def emulate_diag_vec(x, s, t, resident, *, phase_shift=0, stride_short=0):
    """``chain_diag_vec_kernel`` on x (B, L, d), s, t (B, d): the output
    and the flat element index of every lane it wrote."""
    bsz, length, d = x.shape
    row = length * d
    nv = row // 4
    gx, gy = diag_vec_grid(bsz, nv, resident)
    b = (_ar(gy)[:, None] + _ar(_cdiv(bsz, gy))[None, :] * gy).reshape(-1)
    b = b[b < bsz]                                  # blockIdx.y, striding
    v = _chunked(nv, gx, stride_short)              # vectors of a row
    k = _ar(4)
    if d == 2:
        col = torch.tensor([0, 1, 0, 1])[None, :].expand(v.numel(), 4)
    else:
        c0 = (v + phase_shift) % 3                  # 4v = v (mod 3)
        c1 = torch.where(c0 == 2, 0, c0 + 1)
        c2 = torch.where(c0 == 0, 2, c0 - 1)
        col = torch.stack([c0, c1, c2, c0], dim=1)
    elem = b[:, None, None] * row + 4 * v[None, :, None] + k[None, None, :]
    req = b[:, None, None].expand_as(elem)
    col = col[None].expand_as(elem)
    y = torch.full((bsz * row,), float("nan"))
    y[elem.reshape(-1)] = x.reshape(-1)[elem.reshape(-1)] \
        * s[req.reshape(-1), col.reshape(-1)] + t[req.reshape(-1),
                                                  col.reshape(-1)]
    return y.reshape(x.shape), elem.reshape(-1)


def _diag_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    bsz, _, d = shape
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.uniform(0.2, 2, (bsz, d)).astype(np.float32)
    t = rng.uniform(-3, 3, (bsz, d)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, s, t))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    else:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


#: (B, L, d) buckets with rows of a multiple of 4 floats: d = 3 rows of
#: 3, 6 and 9 vectors (each phase starts and ends a row), power-of-two
#: serving lengths, B > 1024
DIAG_SHAPES = [(7, 4, 3), (3, 8, 3), (2, 12, 3), (4, 4096, 3),
               (2, 40_000, 3), (1, 4, 2), (48, 4096, 2), (1500, 16, 2)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", DIAG_SHAPES, ids=str)
def test_diag_vector_mapping_covers_once_and_equals_plain(shape, grid):
    x, s, t = _diag_inputs(shape, [1, *shape])
    assert diag_vector_path(shape[1] * shape[2], aligned=True)
    y, elems = emulate_diag_vec(x, s, t, GRIDS[grid][0])
    assert _covered_once(elems, x.numel())
    assert _same_bits(y, diag_ref.chain_diag_batch(x, s, t))


@pytest.mark.parametrize("row, aligned, vector", [
    (8, True, True), (12, True, True), (39, True, False), (26, True, False),
    (65536, True, True), (65536, False, False), (4 * 2 ** 31, True, False)])
def test_diag_regime_follows_row_and_alignment(row, aligned, vector):
    """The vector kernel needs whole vectors in a row (any power-of-two
    serving length L >= 4 gives them) and aligned bases; a custom grid's
    L = 13 (rows of 26 or 39 floats) or an off-aligned view does not."""
    assert diag_vector_path(row, aligned) is vector


@pytest.mark.parametrize("shape", [s for s in DIAG_SHAPES if s[2] == 3],
                         ids=str)
def test_diag_plant_phase_off_by_one_is_caught(shape):
    x, s, t = _diag_inputs(shape, [2, *shape])
    y, elems = emulate_diag_vec(x, s, t, GRIDS["card"][0], phase_shift=1)
    assert _covered_once(elems, x.numel())
    assert not _same_bits(y, diag_ref.chain_diag_batch(x, s, t))


@pytest.mark.parametrize("shape", [(4, 4096, 3), (48, 4096, 2)], ids=str)
def test_diag_plant_short_chunk_stride_is_caught(shape):
    x, s, t = _diag_inputs(shape, [3, *shape])
    _, elems = emulate_diag_vec(x, s, t, GRIDS["tiny"][0],
                                stride_short=VEC_THREADS)
    assert not _covered_once(elems, x.numel())


# -- affine_2d ---------------------------------------------------------------

def affine_regime(m: int, n: int, width: int, xy_aligned: bool,
                  st_aligned: bool) -> str:
    """``launch_affine``'s choice (``csrc/affine_2d.cu``): ``width`` values
    a 16-byte vector (4 float32, 8 bfloat16)."""
    if xy_aligned and width % n == 0 and m * n >= width:
        return "flat"
    if xy_aligned and n % width == 0 and st_aligned:
        return "column"
    return "scalar"


def emulate_affine_scalar(total, n, max_blocks, *, step_unreduced=False):
    """``affine_2d_kernel`` over ``total`` elements of rows of ``n``: the
    (element, column) of every step of every thread."""
    blocks = min(max(_cdiv(total, SCALAR_THREADS), 1), max_blocks)
    stride = blocks * SCALAR_THREADS
    j = _ar(stride)
    j = j[j < total]
    c = j % n                                       # once a thread
    step = stride % n
    elems, cols = [j[:0]], [c[:0]]
    while j.numel():
        elems.append(j)
        cols.append(c)
        c = c + step
        if not step_unreduced:
            c = torch.where(c >= n, c - n, c)
        keep = j + stride < total
        j, c = (j + stride)[keep], c[keep]
    return torch.cat(elems), torch.cat(cols)


def emulate_affine(x, s, t, grid, *, shift=0, step_unreduced=False,
                   xy_aligned=True, st_aligned=True):
    """``affine_2d`` on x (M, N), s, t (N,) through the regime its C entry
    picks: (the output, the regime, the flat index of every element
    written).  ``shift`` moves the vector kernels' column pattern by one
    (a planted fault)."""
    m, n = x.shape
    total = m * n
    width = 16 // x.element_size()
    resident, max_blocks = GRIDS[grid]
    regime = affine_regime(m, n, width, xy_aligned, st_aligned)
    lane = _ar(width)               # bfloat16: lane 2w + h is half h of word w
    if regime == "flat":
        nvec = total // width
        gx = min(_cdiv(nvec, CHUNK), resident)
        v = _chunked(nvec, gx)
        elem = (v[:, None] * width + lane).reshape(-1)
        col = ((lane + shift) & (n - 1)).repeat(v.numel())
        done = nvec * width                         # a multiple of n
        tail_e, tail_c = emulate_affine_scalar(total - done, n, max_blocks,
                                               step_unreduced=step_unreduced)
        elem, col = torch.cat([elem, tail_e + done]), torch.cat([col, tail_c])
    elif regime == "column":
        nvc = n // width
        tile_c = min(nvc, VEC_THREADS)
        rows = VEC_THREADS // tile_c
        chunk = UNROLL * rows
        gx = _cdiv(nvc, tile_c)
        gy = min(_cdiv(m, chunk), max(resident // gx, 1), MAX_GRID_Y)
        tid = _ar(VEC_THREADS)
        r_in = tid // tile_c
        cv = _ar(gx)[:, None] * tile_c + (tid - r_in * tile_c)[None, :]
        r_in = r_in[None, :].expand_as(cv)
        live = (r_in < rows) & (cv < nvc)
        cv, r_in = cv[live], r_in[live]             # each thread's column
        steps = _cdiv(m, gy * chunk) + 1
        r = (_ar(gy)[:, None, None] * chunk
             + _ar(steps)[None, :, None] * (gy * chunk)
             + _ar(UNROLL)[None, None, :] * rows).reshape(-1)
        r = r[:, None] + r_in[None, :]
        cvs = cv[None, :].expand_as(r)
        live = r < m
        r, cvs = r[live], cvs[live]
        elem = ((r * nvc + cvs)[:, None] * width + lane).reshape(-1)
        col = ((cvs[:, None] * width + lane + shift) % n).reshape(-1)
    else:
        elem, col = emulate_affine_scalar(total, n, max_blocks,
                                          step_unreduced=step_unreduced)
    y = torch.full((total,), float("nan"), dtype=x.dtype)
    y[elem] = x.reshape(-1)[elem] * s[col] + t[col]
    return y.reshape(x.shape), regime, elem


def _affine_inputs(m, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    s = rng.uniform(-2, 2, n).astype(np.float32)
    t = rng.uniform(-3, 3, n).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dtype) for a in (x, s, t))


F32, BF16 = torch.float32, torch.bfloat16
#: (M, N, dtype, the regime at aligned bases)
AFFINE_CASES = [(4097, 1, F32, "flat"), (5000, 2, F32, "flat"),
                (7, 2, F32, "flat"), (1001, 4, F32, "flat"),
                (3001, 8, BF16, "flat"), (70_001, 2, BF16, "flat"),
                (1, 2, F32, "scalar"), (1024, 1024, F32, "column"),
                (1024, 1024, BF16, "column"), (4097, 8, F32, "column"),
                (999, 12, F32, "column"), (33, 520, BF16, "column"),
                (300, 1600, BF16, "column"), (1, 65536, F32, "column"),
                (5, 3, F32, "scalar"), (3001, 3, F32, "scalar"),
                (17, 100, BF16, "scalar"), (4097, 100, F32, "column"),
                (4097, 102, F32, "scalar")]


def _case_id(case):
    m, n, dtype, regime = case
    return f"{m}x{n}-{str(dtype).removeprefix('torch.')}-{regime}"


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("case", AFFINE_CASES, ids=_case_id)
def test_affine_mapping_covers_once_and_equals_plain(case, grid):
    m, n, dtype, regime = case
    x, s, t = _affine_inputs(m, n, dtype, [4, m, n])
    y, got_regime, elems = emulate_affine(x, s, t, grid)
    assert got_regime == regime
    assert _covered_once(elems, m * n)
    assert _same_bits(y, diag_ref.affine(x, s, t))


@pytest.mark.parametrize("m, n, width, xy, st, regime", [
    (1 << 20, 2, 4, True, True, "flat"), (1 << 20, 2, 4, True, False, "flat"),
    (1 << 20, 2, 4, False, True, "scalar"), (7, 4, 8, True, True, "flat"),
    (4, 2, 8, True, True, "flat"), (1, 2, 8, True, True, "scalar"),
    (1, 1, 8, True, True, "scalar"),
    (1024, 1024, 4, True, True, "column"),
    (1024, 1024, 4, True, False, "scalar"),
    (1024, 1024, 8, False, True, "scalar"), (8192, 1600, 8, True, True,
                                             "column"),
    (4097, 8, 4, True, True, "column"), (4097, 3, 4, True, True, "scalar"),
    (4097, 100, 8, True, True, "scalar")], ids=str)
def test_affine_regime_follows_width_and_alignment(m, n, width, xy, st,
                                                   regime):
    """Flat vectors where N divides the width and x, y are aligned (s and
    t are read as scalars), column vectors where N is a multiple of it
    and all four bases are aligned, else the scalar kernel."""
    assert affine_regime(m, n, width, xy, st) == regime


@pytest.mark.parametrize("case", [c for c in AFFINE_CASES
                                  if c[3] != "scalar" and c[1] > 1],
                         ids=_case_id)
def test_affine_plant_pattern_shifted_by_one_is_caught(case):
    m, n, dtype, _ = case
    x, s, t = _affine_inputs(m, n, dtype, [5, m, n])
    y, _, elems = emulate_affine(x, s, t, "card", shift=1)
    assert _covered_once(elems, m * n)
    assert not _same_bits(y, diag_ref.affine(x, s, t))


@pytest.mark.parametrize("m, n", [(3001, 5), (4097, 100), (1001, 7)])
def test_affine_scalar_column_stepping(m, n):
    """The scalar kernel's column, stepped by the stride mod N, equals
    j mod N at every step of a tiny grid (and of the card's, one step a
    thread at these sizes); left unreduced it runs past N."""
    for grid in GRIDS:
        elems, cols = emulate_affine_scalar(m * n, n, GRIDS[grid][1])
        assert _covered_once(elems, m * n)
        assert torch.equal(cols, elems % n)
    elems, cols = emulate_affine_scalar(m * n, n, GRIDS["tiny"][1],
                                        step_unreduced=True)
    assert not torch.equal(cols, elems % n)


# -- chain_project_1d ------------------------------------------------------------

#: csrc/chain_project.cu's kVecPoints
VEC_POINTS = 1 << 19


def project_regime(n: int, d: int, xy_aligned: bool,
                   mask_aligned: bool) -> str:
    """``launch_project_1d``'s choice (``csrc/chain_project.cu``): the
    16-byte kernel for aligned buffers of 2**19 points or more under 2**31
    vectors, the scalar kernel for the rest."""
    if n >= VEC_POINTS and (n // 4) * d < 2 ** 31 and xy_aligned \
            and mask_aligned:
        return "vector"
    return "scalar"


def emulate_project_vec(x, h, lo, hi, resident, *, stride_short=0,
                        read_stride=None):
    """``chain_project_vec_kernel`` on (N, d) points: (output (N, d), mask
    (N,), the flat float index of every element a thread read).
    ``stride_short`` shortens the chunk stride by that many groups and
    ``read_stride`` replaces the staged slots' stride d (planted
    faults)."""
    n, d = x.shape
    rs = d if read_stride is None else read_stride
    nq = n // 4
    nv = nq * d
    out = torch.full((n, d), float("nan"))
    mask = torch.zeros(n, dtype=torch.bool)
    reads = [_ar(0)]
    grid = max(min(_cdiv(nq, CHUNK), resident), 1)
    stride = grid * CHUNK - stride_short
    steps = _cdiv(nq, stride) + 1
    c = (_ar(grid)[:, None] * CHUNK + _ar(steps)[None, :] * stride).reshape(-1)
    c = c[c < nq]                                     # the chunks run
    g0 = (c[:, None, None] + _ar(UNROLL)[None, :, None] * VEC_THREADS
          + _ar(VEC_THREADS // 32)[None, None, :] * 32)   # a warp's 32
    lane = _ar(32)
    q = g0[..., None] + lane                          # each lane's group
    # the staged slot lane * rs + k holds vector g0 d + lane * rs + k
    vec = (g0[..., None, None] * d + lane[:, None] * rs
           + _ar(d)[None, :])                         # (..., 32, d)
    live = (q < nq) & (vec < nv).all(-1)
    q, vec = q[live], vec[live]
    if q.numel():
        xv = x.reshape(-1)[:4 * nv].view(-1, 4)       # the float4 vectors
        pts = xv[vec].reshape(-1, 4, d)               # a lane's four points
        got, inside = proj_ref.chain_project(pts, h, lo, hi)
        out.view(-1)[:4 * nv].view(-1, 4)[vec.reshape(-1)] = \
            got.reshape(-1, 4)
        mask[:4 * nq].view(-1, 4)[q] = inside
        reads.append((vec[..., None] * 4 + _ar(4)).reshape(-1))
    # the tail: thread t < N mod 4 of block 0 takes point 4 nq + t
    tail = 4 * nq + _ar(n - 4 * nq)
    out[tail], mask[tail] = proj_ref.chain_project(x[tail], h, lo, hi)
    reads.append((tail[:, None] * d + _ar(d)).reshape(-1))
    return out, mask, torch.cat(reads)


def _project_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((n, d))).astype(np.float32)
    hm = np.eye(d + 1, dtype=np.float32)
    hm[:d, :d] += rng.uniform(-0.4, 0.4, (d, d)).astype(np.float32)
    hm[d, :d] = rng.uniform(-1, 1, d)
    hm[:d, d] = rng.uniform(-0.5, 0.5, d)             # some w <= 0
    lo = np.full(d, -2.5, np.float32)
    hi = np.full(d, 2.5, np.float32)
    return tuple(torch.from_numpy(a) for a in (x, hm, lo, hi))


#: (N, d): whole groups, tails of 1-3 points, one group, no group, past
#: one tiny grid's chunk many times, 2**16 + 3 points, and the smallest
#: launch the C entry sends to the kernel plus a tail
PROJECT_SHAPES = [(n, d) for d in (2, 3)
                  for n in (3, 4, 7, 1001, 4096, 12290, 70_001, 65539,
                            VEC_POINTS + 3)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", PROJECT_SHAPES, ids=str)
def test_project_vector_mapping_covers_once_and_equals_plain(shape, grid):
    n, d = shape
    x, hm, lo, hi = _project_inputs(n, d, [6, n, d])
    out, mask, reads = emulate_project_vec(x, hm, lo, hi, GRIDS[grid][0])
    assert _covered_once(reads, n * d)
    want, wmask = proj_ref.chain_project(x, hm, lo, hi)
    assert _same_bits(out, want)
    assert torch.equal(mask, wmask)
    if n > 1000:                    # both mask values occur
        assert bool((~wmask).any()) and bool(wmask.any())


@pytest.mark.parametrize("n, d, xy, m4, regime", [
    (1 << 24, 3, True, True, "vector"), (1 << 24, 2, True, True, "vector"),
    ((1 << 20) + 3, 3, True, True, "vector"),
    (VEC_POINTS, 2, True, True, "vector"),
    (VEC_POINTS - 1, 3, True, True, "scalar"), (3, 2, True, True, "scalar"),
    (262_144, 3, True, True, "scalar"), (1 << 20, 3, False, True, "scalar"),
    (1 << 20, 2, True, False, "scalar"),
    (4 * 2 ** 31 // 3 + 4, 3, True, True, "scalar"),
    (4 * (2 ** 30 - 1), 2, True, True, "vector")], ids=str)
def test_project_regime_follows_size_and_alignment(n, d, xy, m4, regime):
    """The 16-byte kernel takes aligned buffers of 2**19 points or more
    (the graphics cloud; a served request is at most 2**18) under 2**31
    vectors; the scalar kernel smaller launches, buffers off alignment
    and anything larger."""
    assert project_regime(n, d, xy, m4) == regime


@pytest.mark.parametrize("d", [2, 3])
def test_project_plant_short_chunk_stride_is_caught(d):
    n = 12290
    x, hm, lo, hi = _project_inputs(n, d, [7, d])
    _, _, reads = emulate_project_vec(x, hm, lo, hi, GRIDS["tiny"][0],
                                      stride_short=1)
    assert not _covered_once(reads, n * d)


@pytest.mark.parametrize("d", [2, 3])
def test_project_plant_staging_stride_is_caught(d):
    """Lane l reading slots l .. l + d - 1 in place of l d .. l d + d - 1
    takes another lane's vectors: the mapping no longer covers every
    float once, nor equals the plain version."""
    n = 4096
    x, hm, lo, hi = _project_inputs(n, d, [8, d])
    out, mask, reads = emulate_project_vec(x, hm, lo, hi, GRIDS["card"][0],
                                           read_stride=1)
    want, wmask = proj_ref.chain_project(x, hm, lo, hi)
    assert not _covered_once(reads, n * d)
    assert not (_same_bits(out, want) and torch.equal(mask, wmask))


# -- rope_3d -------------------------------------------------------------------

#: csrc/rope.cu's block of the 16-byte kernel and its cap on grid y; the
#: tiny grid caps y at 3 so that block rows stride over the heads
ROPE_THREADS = 128
ROPE_GRID_Y = {"card": 65535, "tiny": 3}


def rope_regime(d: int, itemsize: int, s: int, aligned: bool) -> str:
    """``rope_3d``'s choice (``csrc/rope.cu``): the 16-byte kernel for a
    half row of a multiple of 16 bytes (at most 128 vectors), heads under
    2**31 elements and 16-byte-aligned x, y, cos and sin; the scalar
    kernel for the rest."""
    half = d // 2
    if aligned and half * itemsize % 16 == 0 \
            and half * itemsize // 16 <= ROPE_THREADS and s * d < 2 ** 31:
        return "vector"
    return "scalar"


def rope_vec_grid(bh: int, s: int, hv: int, max_gy: int):
    """``launch_vec``'s (grid x, grid y, positions a tile, heads a
    block)."""
    py = min(ROPE_THREADS // hv, s)
    hz = min(ROPE_THREADS // (hv * py), 64, bh)
    return _cdiv(s, py), min(_cdiv(bh, hz), max_gy), py, hz


def emulate_rope_vec(x, cos, sin, max_gy, *, tile_short=0, x2_shift=0):
    """``rope_vec_kernel`` on x (BH, S, D), cos, sin (S, D/2): the output
    and the flat index of every element written.  Thread (tx, ty, tz) of
    block (bx, by) takes vector tx of the half row at position bx py + ty,
    in heads by hz + tz, + gy hz, ...  ``tile_short`` starts each tile that
    many
    positions early and ``x2_shift`` reads x2 that many vectors off
    (planted faults; a read past the buffer wraps)."""
    bh, s, d = x.shape
    half = d // 2
    width = 16 // x.element_size()
    hv = half // width
    gx, gy, py, hz = rope_vec_grid(bh, s, hv, max_gy)
    pos = (_ar(gx)[:, None] * (py - tile_short) + _ar(py)[None, :]).reshape(-1)
    pos = pos[pos < s]                                # threads that run
    h = (_ar(gy)[:, None, None] * hz + _ar(hz)[None, :, None]
         + _ar(_cdiv(bh, gy * hz))[None, None, :] * gy * hz).reshape(-1)
    h = h[h < bh]                                     # striding over heads
    col = (_ar(hv)[:, None] * width + _ar(width)[None, :]).reshape(-1)
    # (head, position, column of the half row)
    o1 = (h[:, None, None] * (s * d) + pos[None, :, None] * d
          + col[None, None, :]).reshape(-1)
    tab = (pos[:, None] * half + col[None, :])[None].expand(
        h.numel(), -1, -1).reshape(-1)
    flat = x.reshape(-1)
    x1 = flat[o1]
    x2 = flat[(o1 + half + x2_shift * width) % flat.numel()]
    c, sn = cos.reshape(-1)[tab], sin.reshape(-1)[tab]
    y = torch.full_like(flat, float("nan"))
    y[o1] = x1 * c - x2 * sn
    y[o1 + half] = x2 * c + x1 * sn
    return y.reshape(x.shape), torch.cat([o1, o1 + half])


def _rope_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    pos = torch.arange(2000, 2000 + shape[1])
    cos, sin = (t.to(dtype) for t in rope_ref.rope_tables(pos, shape[2]))
    return x, cos, sin


#: (BH, S, D): every RoPE head width of the configs (64, 80, 96, 128) at
#: a decode step (S = 1) and at a prefill's 2048 positions, and the
#: reduced models' 16
ROPE_SHAPES = [(bh, s, d) for d in (64, 80, 96, 128)
               for bh, s in ((100, 1), (5, 2048))] + [(130, 7, 16),
                                                      (200, 1, 16),
                                                      (3, 2, 64)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", ROPE_SHAPES, ids=str)
def test_rope_vector_mapping_covers_once_and_equals_plain(shape, grid,
                                                          dtype):
    x, cos, sin = _rope_inputs(shape, dtype, [9, *shape])
    assert rope_regime(shape[2], x.element_size(), shape[1],
                       aligned=True) == "vector"
    y, elems = emulate_rope_vec(x, cos, sin, ROPE_GRID_Y[grid])
    assert _covered_once(elems, x.numel())
    assert _same_bits(y, rope_ref.rope(x, cos, sin))


@pytest.mark.parametrize("d, itemsize, s, aligned, regime", [
    (64, 2, 2048, True, "vector"), (64, 2, 2048, False, "scalar"),
    (80, 2, 1, True, "vector"), (96, 4, 1, True, "vector"),
    (128, 4, 2048, True, "vector"), (16, 2, 7, True, "vector"),
    (20, 2, 200, True, "scalar"), (20, 4, 200, True, "scalar"),
    (8, 4, 3, True, "vector"), (2, 2, 1, True, "scalar"),
    (40, 2, 48, True, "scalar"), (2048, 2, 1, True, "vector"),
    (4096, 2, 1, True, "scalar"), (64, 2, 2 ** 25, True, "scalar")],
    ids=str)
def test_rope_regime_follows_width_and_alignment(d, itemsize, s, aligned,
                                                 regime):
    """Half rows of a multiple of 16 bytes and at most 128 vectors on
    aligned buffers take the 16-byte kernel; D = 20 (bfloat16 or float32),
    D = 2, 40 in bfloat16, wider than 2048 bfloat16 values, heads of 2**31
    elements or an off-aligned base, the scalar one."""
    assert rope_regime(d, itemsize, s, aligned) == regime


def test_rope_every_config_width_takes_the_vector_kernel():
    """Every RoPE model of ``repro_torch.configs`` (and its reduced form)
    has a head width the 16-byte kernel takes, in bfloat16 and float32."""
    from repro_torch import configs

    widths = set()
    for arch in configs.list_archs():
        for cfg in (configs.get(arch), configs.get(arch).reduced()):
            if cfg.n_heads and cfg.pos_embed == "rope":
                widths.add(cfg.head_dim)
    assert {64, 80, 96, 128} <= widths
    for d in widths:
        for itemsize in (2, 4):
            assert rope_regime(d, itemsize, 2048, aligned=True) == "vector"


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 2048, 64), (3, 300, 128)], ids=str)
def test_rope_plant_position_off_by_one_across_a_tile_is_caught(shape,
                                                                dtype):
    x, cos, sin = _rope_inputs(shape, dtype, [10, *shape])
    _, elems = emulate_rope_vec(x, cos, sin, ROPE_GRID_Y["card"],
                                tile_short=1)
    assert not _covered_once(elems, x.numel())


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 2048, 64), (100, 1, 80)], ids=str)
def test_rope_plant_x2_one_vector_off_is_caught(shape, dtype):
    x, cos, sin = _rope_inputs(shape, dtype, [11, *shape])
    y, elems = emulate_rope_vec(x, cos, sin, ROPE_GRID_Y["card"],
                                x2_shift=1)
    assert _covered_once(elems, x.numel())
    assert not _same_bits(y, rope_ref.rope(x, cos, sin))


# -- the whole-point kernels: chain_matrix_batch_2d_q, chain_matrix_batch_2d --

#: csrc/chain_fixedpoint.cu's and csrc/chain_matrix.cu's kUnroll<D>: groups
#: a thread takes a chunk
Q_UNROLL = {2: 4, 3: 1}
MATRIX_UNROLL = {2: 4, 3: 1}


def _requests(bsz: int) -> tuple[int, torch.Tensor]:
    """A batch kernel's grid y and the requests its block rows take,
    striding over B past 1024."""
    gy = min(bsz, MAX_BLOCKS_Y)
    b = (_ar(gy)[:, None] + _ar(_cdiv(bsz, gy))[None, :] * gy).reshape(-1)
    return gy, b[b < bsz]


def _group_vectors(ng, v_per, unroll, grid, *, stride_short=0,
                   read_stride=None, with_groups=False):
    """The vectors of a row each lane of a whole-point kernel takes, one
    group a row: (groups, V), and with ``with_groups`` each one's group
    index g as well.  V = 1: ``_chunked``'s loop.  V > 1: chunks of
    ``unroll`` x 128 groups, a warp's 32 groups staged (slot k 32 + lane
    holds vector g0 V + k 32 + lane) and lane l, on group g0 + l, taking
    slots l rs .. l rs + V - 1, rs = V unless ``read_stride`` plants a
    fault; ``stride_short`` shortens the chunk stride by that many
    groups."""
    if v_per == 1:
        assert unroll == UNROLL
        g = _chunked(ng, grid, stride_short)
        return (g[:, None], g) if with_groups else g[:, None]
    chunk = unroll * VEC_THREADS
    rs = v_per if read_stride is None else read_stride
    stride = grid * chunk - stride_short
    steps = _cdiv(ng, stride) + 1
    c = (_ar(grid)[:, None] * chunk + _ar(steps)[None, :] * stride).reshape(-1)
    c = c[c < ng]
    g0 = (c[:, None, None] + _ar(unroll)[None, :, None] * VEC_THREADS
          + _ar(VEC_THREADS // 32)[None, None, :] * 32).reshape(-1)
    lane = _ar(32)
    g = (g0[:, None] + lane).reshape(-1)
    vec = (g0[:, None, None] * v_per + lane[None, :, None] * rs
           + _ar(v_per)[None, None, :]).reshape(-1, v_per)
    live = (g < ng) & (vec < ng * v_per).all(-1)
    return (vec[live], g[live]) if with_groups else vec[live]


def _apply_groups(x, b, vec, width, fn):
    """Each lane's whole points, gathered from its vectors ``vec`` of
    ``width`` values in the row of every request of ``b``, through
    ``fn(points, requests)`` and put back: (output, the flat index of
    every value a lane took)."""
    _, length, d = x.shape
    row = length * d
    vals = (vec[:, :, None] * width + _ar(width)).reshape(vec.shape[0], -1)
    vals = (b[:, None, None] * row + vals[None]).reshape(-1, vals.shape[1])
    req = b[:, None].expand(-1, vec.shape[0]).reshape(-1)
    flat = x.reshape(-1)
    got = fn(flat[vals].reshape(vals.shape[0], -1, d), req)
    y = torch.zeros_like(flat)
    y[vals.reshape(-1)] = got.reshape(-1)
    return y.reshape(x.shape), vals.reshape(-1)


def q_regime(length: int, d: int, aligned: bool) -> str:
    """The choice of ``chain_matrix_batch_2d_q`` and of
    ``chain_diag_batch_2d_q`` (``csrc/chain_fixedpoint.cu``): the 16-byte
    kernel for a row of a multiple of 8 int16 words under 2**31 vectors on
    16-byte-aligned x and y, the scalar kernel for the rest."""
    row = length * d
    return "vector" if aligned and row % 8 == 0 and row // 8 < 2 ** 31 \
        else "scalar"


def matrix_regime(length: int, d: int, aligned: bool) -> str:
    """``chain_matrix_batch_2d``'s choice (``csrc/chain_matrix.cu``): the
    16-byte kernel for a row of whole groups (L even at d = 2, a multiple
    of 4 at d = 3) under 2**31 float4 vectors on 16-byte-aligned x and y,
    the scalar kernel for the rest."""
    whole = length % (2 if d == 2 else 4) == 0
    return "vector" if aligned and whole and length * d // 4 < 2 ** 31 \
        else "scalar"


def emulate_matrix_q_vec(x, a, t, n_frac, resident, *, read_stride=None):
    """``chain_matrix_batch_q_vec_kernel`` on x (B, L, d) int16 words, a
    (B, d, d), t (B, d): (output, the flat index of every word a lane
    took).  A group is V = 1 (d = 2) or 3 (d = 3) vectors of 8 words, its
    8 V / d whole points."""
    bsz, length, d = x.shape
    v_per = 1 if d == 2 else 3
    ng = length * d // (8 * v_per)
    gy, b = _requests(bsz)
    gx = min(_cdiv(ng, Q_UNROLL[d] * VEC_THREADS), max(resident // gy, 1))
    vec = _group_vectors(ng, v_per, Q_UNROLL[d], gx, read_stride=read_stride)
    return _apply_groups(x, b, vec, 8, lambda pts, req:
                         q_ref.chain_matrix_batch_q(pts, a[req], t[req],
                                                    n_frac))


def emulate_matrix_vec(x, a, t, resident, *, stride_short=0,
                       read_stride=None):
    """``chain_matrix_batch_vec_kernel`` on x (B, L, d) float32, a (B, d,
    d), t (B, d): (output, the flat index of every float a lane took).  A
    group is V = 1 (d = 2) or 3 (d = 3) float4 vectors, its 4 V / d whole
    points, computed with ``ref.chain_matrix_batch``'s rounded ops."""
    bsz, length, d = x.shape
    v_per = 1 if d == 2 else 3
    ng = length * d // (4 * v_per)
    gy, b = _requests(bsz)
    gx = min(_cdiv(ng, MATRIX_UNROLL[d] * VEC_THREADS),
             max(resident // gy, 1))
    vec = _group_vectors(ng, v_per, MATRIX_UNROLL[d], gx,
                         stride_short=stride_short, read_stride=read_stride)
    return _apply_groups(x, b, vec, 4, lambda pts, req:
                         matrix_ref.chain_matrix_batch(pts, a[req], t[req]))


def _q_inputs(shape, seed, kind="matrix"):
    rng = np.random.default_rng(seed)
    bsz, _, d = shape

    def words(s):
        return torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, s)
                                .astype(np.int16))
    return words(shape), words((bsz, d, d) if kind == "matrix"
                               else (bsz, d)), words((bsz, d))


#: (B, L, d) buckets with rows of a multiple of 8 words: one vector or
#: group a row and several, power-of-two serving lengths, the largest q
#: bucket's (15, 65536, 2), B > 1024
MATRIX_Q_SHAPES = [(3, 4, 2), (2, 12, 2), (4, 4096, 2), (15, 65536, 2),
                   (1500, 16, 2), (3, 8, 3), (2, 24, 3), (4, 4096, 3),
                   (2, 40_000, 3), (1100, 8, 3)]


@pytest.mark.parametrize("n_frac", [0, 7, 15])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", MATRIX_Q_SHAPES, ids=str)
def test_matrix_q_vector_mapping_covers_once_and_equals_plain(shape, grid,
                                                              n_frac):
    x, a, t = _q_inputs(shape, [12, *shape, n_frac])
    assert q_regime(shape[1], shape[2], aligned=True) == "vector"
    y, words = emulate_matrix_q_vec(x, a, t, n_frac, GRIDS[grid][0])
    assert _covered_once(words, x.numel())
    assert torch.equal(y, q_ref.chain_matrix_batch_q(x, a, t, n_frac))


@pytest.mark.parametrize("length, d, aligned, regime", [
    (65536, 2, True, "vector"), (65536, 3, True, "vector"),
    (4, 2, True, "vector"), (8, 3, True, "vector"), (12, 3, False, "scalar"),
    (1001, 3, True, "scalar"), (1001, 2, True, "scalar"),
    (13, 2, True, "scalar"), (6, 2, True, "scalar"),
    (4, 3, True, "scalar"), (65536, 2, False, "scalar"),
    (2 ** 34, 2, True, "scalar")], ids=str)
def test_matrix_q_regime_follows_row_and_alignment(length, d, aligned,
                                                   regime):
    """Rows of a multiple of 8 words (every power-of-two serving length
    from 4 points at d = 2, from 8 at d = 3) on aligned buffers take the
    16-byte kernel; a custom grid's L = 13 or 1001, an off-aligned view or
    a row of 2**31 vectors, the scalar one."""
    assert q_regime(length, d, aligned) == regime


def test_matrix_q_plant_staging_stride_is_caught():
    """Lane l reading slots l .. l + 2 in place of 3l .. 3l + 2 takes
    another lane's vectors: the mapping no longer covers every word once,
    nor equals the plain version."""
    shape = (4, 4096, 3)
    x, a, t = _q_inputs(shape, [13])
    y, words = emulate_matrix_q_vec(x, a, t, 7, GRIDS["card"][0],
                                    read_stride=1)
    assert not _covered_once(words, x.numel())
    assert not torch.equal(y, q_ref.chain_matrix_batch_q(x, a, t, 7))


def _matrix_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    bsz, _, d = shape
    x = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(-1.5, 1.5, (bsz, d, d)).astype(np.float32)
    t = rng.uniform(-3, 3, (bsz, d)).astype(np.float32)
    return tuple(torch.from_numpy(v) for v in (x, a, t))


#: (B, L, d) float buckets of whole groups: one group a row and several,
#: power-of-two serving lengths, the largest served matrix bucket (47,
#: 32768, 2), rows past one chunk many times, B > 1024
MATRIX_SHAPES = [(3, 2, 2), (2, 6, 2), (4, 4096, 2), (47, 32768, 2),
                 (1500, 16, 2), (3, 4, 3), (2, 12, 3), (5, 8, 3),
                 (4, 4096, 3), (2, 40_000, 3), (1100, 8, 3)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", MATRIX_SHAPES, ids=str)
def test_matrix_vector_mapping_covers_once_and_equals_plain(shape, grid):
    x, a, t = _matrix_inputs(shape, [14, *shape])
    assert matrix_regime(shape[1], shape[2], aligned=True) == "vector"
    y, elems = emulate_matrix_vec(x, a, t, GRIDS[grid][0])
    assert _covered_once(elems, x.numel())
    assert _same_bits(y, matrix_ref.chain_matrix_batch(x, a, t))


@pytest.mark.parametrize("length, d, aligned, regime", [
    (32768, 2, True, "vector"), (32768, 3, True, "vector"),
    (2, 2, True, "vector"), (4, 3, True, "vector"), (8, 3, True, "vector"),
    (6, 2, True, "vector"), (12, 3, True, "vector"),
    (13, 2, True, "scalar"), (1001, 2, True, "scalar"),
    (6, 3, True, "scalar"), (1001, 3, True, "scalar"),
    (32768, 2, False, "scalar"), (32768, 3, False, "scalar"),
    (2 ** 32, 2, True, "scalar"), (2 ** 32 // 3 * 4, 3, True, "scalar")],
    ids=str)
def test_matrix_regime_follows_row_and_alignment(length, d, aligned, regime):
    """Rows of whole groups -- L even at d = 2 (2 points a vector), a
    multiple of 4 at d = 3 (4 points in 3 vectors) -- on aligned buffers
    take the 16-byte kernel; a custom grid's L = 13 or 1001, L = 6 at d =
    3, an off-aligned view or a row of 2**31 vectors, the scalar one."""
    assert matrix_regime(length, d, aligned) == regime


@pytest.mark.parametrize("d", [2, 3])
def test_matrix_plant_short_chunk_stride_is_caught(d):
    shape = (3, 4096, d)
    x, a, t = _matrix_inputs(shape, [15, d])
    _, elems = emulate_matrix_vec(x, a, t, GRIDS["tiny"][0], stride_short=1)
    assert not _covered_once(elems, x.numel())


def test_matrix_plant_staging_stride_is_caught():
    """Lane l reading slots l .. l + 2 in place of 3l .. 3l + 2 takes
    another lane's float4 vectors: the mapping no longer covers every
    float once, nor equals the plain version."""
    shape = (4, 4096, 3)
    x, a, t = _matrix_inputs(shape, [16])
    y, elems = emulate_matrix_vec(x, a, t, GRIDS["card"][0], read_stride=1)
    assert not _covered_once(elems, x.numel())
    assert not _same_bits(y, matrix_ref.chain_matrix_batch(x, a, t))


# -- chain_diag_batch_2d_q -----------------------------------------------------

def emulate_diag_q_vec(x, s, t, n_frac, resident, *, phase_shift=0,
                       stride_short=0):
    """``chain_diag_batch_q_vec_kernel`` on x (B, L, d) int16 words, s, t
    (B, d): the output and the flat index of every word it wrote.
    ``chain_diag_vec_kernel``'s map on vectors of 8 words: word k of
    vector v on column (8v + k) mod d, for d = 3 from the phase r = v % 3
    (column 0, 2, 1 for r = 0, 1, 2; ``phase_shift`` moves r, a planted
    fault).  Each word is the kernel's uint32 arithmetic, in int64 masked
    to 32 bits: x s + ((t << n) + round), a logical shift by n, the low
    16 bits."""
    bsz, length, d = x.shape
    row = length * d
    nv = row // 8
    gx, _ = diag_vec_grid(bsz, nv, resident)
    _, b = _requests(bsz)
    v = _chunked(nv, gx, stride_short)
    k = _ar(8)
    if d == 2:
        col = (k % 2)[None, :].expand(v.numel(), 8)
    else:
        r = (v + phase_shift) % 3
        col = (torch.where(r == 0, 0, 3 - r)[:, None] + k) % 3
    elem = (b[:, None, None] * row + 8 * v[None, :, None] + k).reshape(-1)
    req = b[:, None, None].expand(-1, v.numel(), 8).reshape(-1)
    col = col[None].expand(b.numel(), -1, -1).reshape(-1)
    mask = 0xFFFFFFFF
    tr = ((t[req, col].long() << n_frac)
          + ((1 << (n_frac - 1)) if n_frac else 0)) & mask
    acc = (x.reshape(-1)[elem].long() * s[req, col].long() + tr) & mask
    word = (acc >> n_frac) & 0xFFFF
    y = torch.zeros(bsz * row, dtype=torch.int16)
    y[elem] = torch.where(word >= 0x8000, word - 0x10000, word).to(
        torch.int16)
    return y.reshape(x.shape), elem


#: (B, L, d) q buckets with rows of a multiple of 8 words: d = 3 rows of
#: 3, 6 and 9 vectors (each phase starts and ends a row), power-of-two
#: serving lengths, the largest q diag bucket (36, 32768, 2), B > 1024
DIAG_Q_SHAPES = [(1, 8, 3), (3, 16, 3), (5, 24, 3), (4, 4096, 3),
                 (2, 40_000, 3), (1100, 8, 3), (1, 4, 2), (3, 12, 2),
                 (36, 32768, 2), (1500, 16, 2)]


@pytest.mark.parametrize("n_frac", [0, 7, 15])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", DIAG_Q_SHAPES, ids=str)
def test_diag_q_vector_mapping_covers_once_and_equals_plain(shape, grid,
                                                            n_frac):
    x, s, t = _q_inputs(shape, [17, *shape, n_frac], kind="diag")
    assert q_regime(shape[1], shape[2], aligned=True) == "vector"
    y, elems = emulate_diag_q_vec(x, s, t, n_frac, GRIDS[grid][0])
    assert _covered_once(elems, x.numel())
    assert torch.equal(y, q_ref.chain_diag_batch_q(x, s, t, n_frac))


@pytest.mark.parametrize("shape", [sh for sh in DIAG_Q_SHAPES
                                   if sh[2] == 3], ids=str)
def test_diag_q_plant_phase_off_by_one_is_caught(shape):
    x, s, t = _q_inputs(shape, [18, *shape], kind="diag")
    y, elems = emulate_diag_q_vec(x, s, t, 7, GRIDS["card"][0],
                                  phase_shift=1)
    assert _covered_once(elems, x.numel())
    assert not torch.equal(y, q_ref.chain_diag_batch_q(x, s, t, 7))


@pytest.mark.parametrize("shape", [(4, 4096, 3), (36, 32768, 2)], ids=str)
def test_diag_q_plant_short_chunk_stride_is_caught(shape):
    x, s, t = _q_inputs(shape, [19, *shape], kind="diag")
    _, elems = emulate_diag_q_vec(x, s, t, 7, GRIDS["tiny"][0],
                                  stride_short=VEC_THREADS)
    assert not _covered_once(elems, x.numel())


# -- chain_project_batch_2d ---------------------------------------------------

#: csrc/chain_project.cu's kBatchUnroll: groups a thread takes a chunk
PROJECT_BATCH_UNROLL = 1


def project_batch_regime(bsz: int, length: int, d: int, xy_aligned: bool,
                         mask_aligned: bool) -> str:
    """``chain_project_batch_2d``'s choice (``csrc/chain_project.cu``): the
    16-byte kernel for rows of whole groups of four points (L a multiple
    of 4) under 2**31 float4 vectors on 16-byte-aligned x and y and a
    4-byte-aligned mask, the scalar kernel for the rest."""
    if xy_aligned and mask_aligned and length % 4 == 0 \
            and length * d // 4 < 2 ** 31:
        return "vector"
    return "scalar"


def emulate_project_batch_vec(x, h, lo, hi, resident, *, stride_short=0,
                              read_stride=None, words_short=0):
    """``chain_project_batch_vec_kernel`` on x (B, L, d) float32, h (B, d+1,
    d+1), lo, hi (B, d): (output, mask (B, L), the flat index of every
    float a lane took, the mask word each lane wrote).  A group is four
    whole points in d float4 vectors, staged at d = 2 and d = 3 alike,
    computed with ``ref.chain_project_batch``'s rounded ops; group g of
    request b writes mask word b L/4 + g (``words_short`` shortens a
    request's row of words by that many: a planted fault)."""
    bsz, length, d = x.shape
    ng = length // 4
    gy, b = _requests(bsz)
    unroll = PROJECT_BATCH_UNROLL
    gx = min(_cdiv(ng, unroll * VEC_THREADS), max(resident // gy, 1))
    vec, g = _group_vectors(ng, d, unroll, gx, stride_short=stride_short,
                            read_stride=read_stride, with_groups=True)
    inside = []

    def project(pts, req):
        got, m = proj_ref.chain_project_batch(pts, h[req], lo[req], hi[req])
        inside.append(m)
        return got
    y, elems = _apply_groups(x, b, vec, 4, project)
    words = (b[:, None] * (ng - words_short) + g[None, :]).reshape(-1)
    mask = torch.zeros(bsz * ng, 4, dtype=torch.bool)
    mask[words] = inside[0]
    return y, mask.reshape(bsz, length), elems, words


def _project_batch_inputs(shape, seed):
    """Points and per-request H, lo, hi with a perspective column, so that
    some points have w <= 0 and some fall outside [lo, hi]."""
    rng = np.random.default_rng(seed)
    bsz, _, d = shape
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    hm = np.tile(np.eye(d + 1, dtype=np.float32), (bsz, 1, 1))
    hm[:, :d, :d] += rng.uniform(-0.4, 0.4, (bsz, d, d)).astype(np.float32)
    hm[:, d, :d] = rng.uniform(-1, 1, (bsz, d))
    hm[:, :d, d] = rng.uniform(-0.5, 0.5, (bsz, d))     # some w <= 0
    lo = rng.uniform(-3, -2, (bsz, d)).astype(np.float32)
    hi = rng.uniform(2, 3, (bsz, d)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, hm, lo, hi))


#: (B, L, d) buckets of whole groups: one group a row and several, power-
#: of-two serving lengths, the mixed serve's largest and median buckets,
#: (20, 65536, 2) and (8, 32768, 3), rows past one chunk many times, B >
#: 1024
PROJECT_BATCH_SHAPES = [(3, 4, 2), (2, 12, 2), (4, 4096, 2), (20, 65536, 2),
                        (1500, 16, 2), (1, 4, 3), (2, 12, 3), (5, 8, 3),
                        (8, 32768, 3), (2, 40_000, 3), (1100, 8, 3)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("shape", PROJECT_BATCH_SHAPES, ids=str)
def test_project_batch_vector_mapping_covers_once_and_equals_plain(shape,
                                                                   grid):
    bsz, length, d = shape
    x, hm, lo, hi = _project_batch_inputs(shape, [20, *shape])
    assert project_batch_regime(bsz, length, d, True, True) == "vector"
    y, mask, elems, words = emulate_project_batch_vec(x, hm, lo, hi,
                                                      GRIDS[grid][0])
    assert _covered_once(elems, x.numel())
    assert _covered_once(words, bsz * length // 4)
    want, wmask = proj_ref.chain_project_batch(x, hm, lo, hi)
    assert _same_bits(y, want)
    assert torch.equal(mask, wmask)
    if wmask.numel() > 1000:        # both mask values occur
        assert bool(wmask.any()) and not bool(wmask.all())


@pytest.mark.parametrize("bsz, length, d, xy, m4, regime", [
    (20, 65536, 2, True, True, "vector"), (64, 65536, 3, True, True,
                                           "vector"),
    (1, 4096, 3, True, True, "vector"), (1, 4, 2, True, True, "vector"),
    (1100, 8, 3, True, True, "vector"), (3, 6, 3, True, True, "scalar"),
    (2, 39, 2, True, True, "scalar"), (1100, 13, 3, True, True, "scalar"),
    (20, 65536, 2, False, True, "scalar"),
    (20, 65536, 2, True, False, "scalar"),
    (1, 2 ** 32, 2, True, True, "scalar"),
    (1, 2 ** 32 // 3 * 4, 3, True, True, "scalar"),
    (1, 2 ** 32 - 4, 2, True, True, "vector")], ids=str)
def test_project_batch_regime_follows_row_and_alignment(bsz, length, d, xy,
                                                        m4, regime):
    """Rows of whole groups of four points on aligned x, y and mask take
    the 16-byte kernel, whatever the bucket's size; a custom grid's L = 6,
    39 or 13, an off-aligned view of the points or the mask, or a row of
    2**31 vectors, the scalar one."""
    assert project_batch_regime(bsz, length, d, xy, m4) == regime


@pytest.mark.parametrize("d", [2, 3])
def test_project_batch_plant_short_chunk_stride_is_caught(d):
    shape = (3, 4096, d)
    x, hm, lo, hi = _project_batch_inputs(shape, [21, d])
    _, _, elems, words = emulate_project_batch_vec(x, hm, lo, hi,
                                                   GRIDS["tiny"][0],
                                                   stride_short=1)
    assert not _covered_once(elems, x.numel())
    assert not _covered_once(words, 3 * 4096 // 4)


def test_project_batch_plant_staging_stride_is_caught():
    """Lane l reading slots l .. l + 2 in place of 3l .. 3l + 2 at d = 3
    takes another lane's vectors: the mapping no longer covers every
    float once, nor equals the plain version."""
    shape = (4, 4096, 3)
    x, hm, lo, hi = _project_batch_inputs(shape, [22])
    y, mask, elems, _ = emulate_project_batch_vec(x, hm, lo, hi,
                                                  GRIDS["card"][0],
                                                  read_stride=1)
    want, wmask = proj_ref.chain_project_batch(x, hm, lo, hi)
    assert not _covered_once(elems, x.numel())
    assert not (_same_bits(y, want) and torch.equal(mask, wmask))


@pytest.mark.parametrize("shape", [(3, 4096, 2), (20, 65536, 2),
                                   (4, 4096, 3)], ids=str)
def test_project_batch_plant_mask_row_one_group_short_is_caught(shape):
    """Request b's mask words at b (L/4 - 1) + g in place of b L/4 + g:
    each request but the first writes over its neighbour's last word, and
    the last request's words at the end stay unwritten."""
    x, hm, lo, hi = _project_batch_inputs(shape, [23, *shape])
    y, mask, _, words = emulate_project_batch_vec(x, hm, lo, hi,
                                                  GRIDS["card"][0],
                                                  words_short=1)
    want, wmask = proj_ref.chain_project_batch(x, hm, lo, hi)
    assert _same_bits(y, want)
    assert not _covered_once(words, shape[0] * shape[1] // 4)
    assert not torch.equal(mask, wmask)


@pytest.mark.parametrize("d", [2, 3])
def test_every_default_serving_length_takes_the_vector_kernels(d):
    """Each padded length of the default serving grid (powers of two from
    MIN_LEN) gives rows that the 16-byte kernels of
    ``chain_matrix_batch_2d``, ``chain_project_batch_2d``,
    ``chain_diag_batch_2d_q`` and ``chain_matrix_batch_2d_q`` take on
    aligned buffers (fresh allocations, as ``GeometryServer`` packs)."""
    lengths = {bucketing.padded_length(n) for n in range(1, (1 << 18) + 1,
                                                         97)}
    assert min(lengths) == bucketing.MIN_LEN and max(lengths) >= 1 << 18
    for length in lengths:
        assert matrix_regime(length, d, aligned=True) == "vector"
        assert project_batch_regime(1, length, d, True, True) == "vector"
        assert q_regime(length, d, aligned=True) == "vector"

"""The 16-byte kernels of ``chain_diag_batch_2d``, ``affine_2d`` and
``chain_project_1d``, held on the CPU.

Their CUDA kernels (``csrc/chain_diag.cu``, ``csrc/affine_2d.cu``,
``csrc/chain_project.cu``) run
only on the card, so here each kernel's mapping from (block, thread,
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
    so it is emulated at small N as well.

Each emulation must cover every element exactly once, pick the regime the
C entry picks, and, computing each element with the same rounded ops
(``x * s``, then ``+ t``; ``ref.chain_project``'s sequence on the
gathered points), equal ``ref.chain_diag_batch`` / ``ref.affine`` /
``ref.chain_project`` bit for bit, masks included.  A planted fault -- a
d = 3 phase off by one, a column pattern shifted by one, a column step
left unreduced, a chunk stride one step short, a chunk stride one group
short, staged slots read at a stride of 1 -- must be caught.  Each grid
is emulated at the card's size and at a tiny one, so every grid-stride
loop takes several steps.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro_torch.kernels.affine import ref as diag_ref
from repro_torch.kernels.projective import ref as proj_ref

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

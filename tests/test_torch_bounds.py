"""The tensor-core contracts of ``tests/torch_bounds.py``, held on the CPU.

The wgmma paths of ``matmul_2d`` and ``flash_attention_3d`` (bfloat16
inputs) run only on the card, so their arithmetic is emulated here in
eager torch and held to the bounds the card checks use:

  * ``matmul_2d``: a reversed-k float32 sum and a tile-blocked one (64-deep
    panels, each summed in its own order, added in turn), against the
    plain k-ascending version, within ``matmul_bound``; a planted fault
    (the ragged last K step left out) lies outside it;
  * ``flash_attention_3d``: the kernel's walk -- 128-row query blocks,
    128-key tiles for D <= 64 and 64-key tiles above, the TPU kernel's
    tile liveness, zero-padded ragged tiles, the -1e30 sentinel, the
    online max and sum in float32 and P rounded to bfloat16 before P V --
    within ``flash_bound`` of the plain version, as bfloat16 and before
    the output rounding; P one bfloat16 ulp too large at a row's dominant
    key in a 128-key tile lies outside it;
  * ``rmsnorm_2d``'s 16-byte kernel: W warps a row (``warps_for`` of
    ``csrc/rmsnorm.cu``), each lane's float32 sum of squares over its
    vectors in order, the butterfly of shuffles across the warp, the
    warps' sums added in order, then ``x * inv * gain`` -- within
    ``rmsnorm_bound`` of the plain version at N = 64, 1600 and 3200, few
    rows and many; one lane's partial sum dropped lies outside it;
  * ``ssd_intra``'s wgmma kernel (bfloat16): query and key tiles of 64
    rows, G = C B^T from the bfloat16 C and B in float32, att = G
    exp(cum_i - cum_j) masked before exp on the diagonal tile and rounded
    to bfloat16, y summed over the key tiles in order in float32; S_c
    from w = xdt exp(cum_last - cum) rounded to bfloat16, summed over the
    key tiles in order -- within ``ssd_bounds(..., tensor_cores=True)``
    of the plain version and of the JAX package's ``ssd_intra`` run in
    interpret mode, at (p, n) = (16, 16), (64, 16), (64, 128) and lc =
    16, 100, 256; a dropped key tile, and the mask applied after exp,
    lie outside it; and the states' A fragments, read by transposed
    ldmatrix from the 128-byte-swizzled xdt tile, hold xdt^T.

The shapes are the card tests' (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

import torch_bounds as bounds
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.matmul import matmul as matrix_k
from repro_torch.kernels.matmul import ref as matrix_ref
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.ssd import ref as ssd_ref

#: the wgmma regime's shapes in test_matmul_kernel_equals_plain (K > 8 or
#: N > 8): staged loads (K or N no multiple of 8) and TMA loads
MATMUL_SHAPES = [(17, 100, 33), (65, 17, 63), (130, 1024, 70),
                 (256, 512, 384), (1024, 1024, 1024)]
#: test_flash_kernel_within_bound_of_plain's cases: (BHkv, group, S, T, D,
#: causal, window, q_offset)
FLASH_CASES = [(2, 1, 37, 37, 64, True, None, 0),
               (2, 5, 300, 300, 64, True, 128, 0),
               (2, 5, 300, 300, 64, True, 100, 0),
               (1, 5, 200, 200, 16, True, 32, 0),
               (3, 2, 5, 261, 64, True, 64, 256),
               (1, 4, 1, 77, 80, True, None, 76),
               (2, 1, 50, 70, 96, False, None, 0),
               (4, 5, 129, 129, 128, True, 1024, 0),
               (2, 2, 200, 333, 80, True, 100, 133),
               (2, 3, 157, 157, 96, True, None, 0),
               (1, 2, 300, 300, 128, False, None, 0),
               (2, 1, 77, 200, 128, True, 50, 123)]
BQ = 128


def _bf16(rng, shape, low=None, high=None):
    a = rng.uniform(low, high, shape) if low is not None \
        else rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).bfloat16()


# -- matmul_2d ----------------------------------------------------------------

def _reversed_k(x, y):
    acc = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32)
    for k in reversed(range(x.shape[1])):
        acc = acc + x[:, k:k + 1].float() * y[k:k + 1, :].float()
    return acc


def _panels(x, y, depth=64, drop_last=False):
    """64-deep panels, each summed by one float32 product (its own order;
    bfloat16 products are exact in float32, so a fused multiply-add
    rounds as a multiply and an add), added in turn from 0.  With
    ``drop_last`` the last K step is left out (the planted fault)."""
    kk = x.shape[1] - (1 if drop_last else 0)
    acc = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32)
    for k0 in range(0, kk, depth):
        k1 = min(kk, k0 + depth)
        acc = acc + torch.matmul(x[:, k0:k1].float(), y[k0:k1].float())
    return acc


@pytest.mark.parametrize("shape", MATMUL_SHAPES,
                         ids=["x".join(map(str, s)) for s in MATMUL_SHAPES])
def test_matmul_emulations_within_bound(shape):
    m, k, n = shape
    assert matrix_k.tensor_cores(torch.bfloat16, k, n)
    assert not matrix_k.tensor_cores(torch.float32, k, n)
    rng = np.random.default_rng([71, m, k, n])
    x, y = _bf16(rng, (m, k)), _bf16(rng, (k, n))
    plain32 = matrix_ref.matmul(x, y, torch.float32)
    emus = (_reversed_k(x, y), _panels(x, y))
    for emu in emus:
        for out in (torch.float32, torch.bfloat16):
            want = plain32.to(out)
            err = (emu.to(out).float() - want.float()).abs()
            assert bool((err <= bounds.matmul_bound(x, y, want)).all()), out
    # another order does round otherwise: the bound is exercised
    assert any(not torch.equal(emu, plain32) for emu in emus)


def test_matmul_bound_catches_a_dropped_k_step():
    m, k, n = 130, 1024, 70
    rng = np.random.default_rng(72)
    x, y = _bf16(rng, (m, k)), _bf16(rng, (k, n))
    want = matrix_ref.matmul(x, y, torch.bfloat16)
    bound = bounds.matmul_bound(x, y, want)
    good = (_panels(x, y).bfloat16().float() - want.float()).abs()
    bad = (_panels(x, y, drop_last=True).bfloat16().float()
           - want.float()).abs()
    assert bool((good <= bound).all())
    assert not bool((bad <= bound).all())


# -- flash_attention_3d ---------------------------------------------------------

def _emulate_flash(q, k, v, scale, causal, window, q_offset, plant=None):
    """The wgmma kernel's arithmetic on bfloat16 q (BHq, S, D), k/v (BHkv,
    T, D), in float32 (the output before its bfloat16 rounding).
    ``plant`` = (bh, row, key): P of that pair one bfloat16 ulp larger."""
    bhq, s, d = q.shape
    bhkv, t, _ = k.shape
    bk = 128 if d <= 64 else 64
    heads = torch.arange(bhq) // (bhq // bhkv)
    pad = (t + bk - 1) // bk * bk - t
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))[heads]
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))[heads]
    qf = q.float()
    out = torch.empty((bhq, s, d), dtype=torch.float32)
    for r0 in range(0, s, BQ):
        r1 = min(s, r0 + BQ)
        q_lo = q_offset + r0
        q_hi = q_lo + BQ - 1
        qpos = q_offset + torch.arange(r0, r1)
        m = torch.full((bhq, r1 - r0), -1e30)
        l = torch.zeros((bhq, r1 - r0))
        acc = torch.zeros((bhq, r1 - r0, d))
        for k_lo in range(0, t, bk):
            if causal and k_lo > q_hi:
                break
            if window is not None and not k_lo + bk - 1 > q_lo - window:
                continue
            kpos = torch.arange(k_lo, k_lo + bk)
            sc = torch.matmul(qf[:, r0:r1], kf[:, k_lo:k_lo + bk]
                              .transpose(1, 2)) * scale
            ok = (kpos < t)[None, :].expand(r1 - r0, bk)
            if causal:
                ok = ok & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                ok = ok & (kpos[None, :] > qpos[:, None] - window)
            sc = torch.where(ok, sc, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = corr * l + p.sum(dim=-1)
            pb = p.bfloat16()
            if plant is not None and k_lo <= plant[2] < k_lo + bk \
                    and r0 <= plant[1] < r1:
                bits = pb.view(torch.int16)
                bits[plant[0], plant[1] - r0, plant[2] - k_lo] += 1
            acc = acc * corr[..., None] + torch.matmul(
                pb.float(), vf[:, k_lo:k_lo + bk])
            m = m_new
        out[:, r0:r1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out


def _flash_inputs(case, seed):
    bhkv, group, s, t, d, causal, window, q_off = case
    rng = np.random.default_rng(seed)
    q = _bf16(rng, (bhkv * group, s, d))
    k, v = _bf16(rng, (bhkv, t, d)), _bf16(rng, (bhkv, t, d))
    return q, k, v, dict(scale=d ** -0.5, causal=causal, window=window,
                         q_offset=q_off)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=["-".join(map(str, c)) for c in FLASH_CASES])
def test_flash_emulation_within_bound(case):
    q, k, v, kw = _flash_inputs(case, [73, *case[:5]])
    emu = _emulate_flash(q, k, v, **kw)
    want = fa_ref.flash_attention(q, k, v, **kw)
    want32 = fa_ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    scale = kw["scale"]
    err = (emu.bfloat16().float() - want.float()).abs()
    assert bool((err <= bounds.flash_bound(q, k, v, scale, want)).all())
    err32 = (emu - want32).abs()
    assert bool((err32 <= bounds.flash_bound(q, k, v, scale, want32)).all())
    # P's rounding shows: the emulation is not the plain version
    assert float(err32.max()) > 0


def test_flash_bound_catches_one_p_ulp_too_many():
    """One query row with a dominant key in a 128-key tile (score 32 above
    the rest, so l ~ 1 and its P is exactly 1) and v of that key at
    max|v|: P one bfloat16 ulp too large moves the output by 2**-7
    max|v|, past the bound's 2**-8 max|v| for P's rounding."""
    rng = np.random.default_rng(74)
    s = t = 256
    d, row, key = 64, 200, 150
    q = rng.standard_normal((1, s, d)).astype(np.float32)
    k = rng.standard_normal((1, t, d)).astype(np.float32)
    v = rng.uniform(-1, 1, (1, t, d)).astype(np.float32)
    q[0, row] = 0.0
    q[0, row, 0] = 16.0
    k[0, :, 0] = 0.0
    k[0, key, 0] = 16.0
    v[0, key] = 1.0
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    kw = dict(scale=d ** -0.5, causal=True, window=None, q_offset=0)
    want32 = fa_ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    bound = bounds.flash_bound(q, k, v, kw["scale"], want32)
    good = (_emulate_flash(q, k, v, **kw) - want32).abs()
    bad = (_emulate_flash(q, k, v, **kw, plant=(0, row, key)) - want32).abs()
    assert bool((good <= bound).all())
    assert not bool((bad[0, row] <= bound[0, row]).all())
    assert float(bad[0, row].max()) >= 2.0 ** -7 * 0.99


# -- rmsnorm_2d -------------------------------------------------------------------

#: csrc/rmsnorm.cu's kMaxVec and kMaxWarps, and the SM count below which
#: warps_for spreads a row over more warps
RMS_MAX_VEC, RMS_MAX_WARPS, SMS = 8, 32, 132
RMS_CASES = [(m, n, dt) for n in (64, 1600, 3200) for m in (4, 200)
             for dt in ("float32", "bfloat16")]


def _rms_warps(m, nv):
    """csrc/rmsnorm.cu's ``warps_for``: the warps that take a row."""
    w = 1
    while 32 * w * RMS_MAX_VEC < nv:
        w *= 2
    if m < SMS:
        while w < RMS_MAX_WARPS and 32 * w < nv:
            w *= 2
    return w


def _emulate_rmsnorm(x, g, eps, drop_lane=None):
    """The 16-byte kernel's arithmetic in float32, before the output
    rounding: vector j of a row (16 bytes of x) goes to lane j mod 32 W
    of its group; each lane sums x*x over its vectors in order (a fused
    multiply-add, emulated in float64 and rounded once to float32 -- the
    product is exact there, so this is fmaf but for a rare double
    rounding); a butterfly (xor 16, 8, 4, 2, 1) adds the lanes of each
    warp; the W warps' sums are added in order.  ``drop_lane`` zeroes one
    lane's partial sum (the planted fault)."""
    m, n = x.shape
    vec = 16 // x.element_size()
    nv = n // vec
    w = _rms_warps(m, nv)
    group = 32 * w
    k = -(-nv // group)
    flat = torch.zeros(m, k * group * vec, dtype=torch.float64)
    flat[:, :n] = x.double()
    v = flat.view(m, k, group, vec)
    ss = torch.zeros(m, group, dtype=torch.float32)
    for kk in range(k):
        for e in range(vec):
            a = v[:, kk, :, e]
            ss = (a * a + ss.double()).float()
    if drop_lane is not None:
        ss[:, drop_lane] = 0.0
    ss = ss.view(m, w, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, :, lane ^ o]
    total = ss[:, 0, 0]
    for i in range(1, w):
        total = total + ss[:, i, 0]
    inv = torch.rsqrt(total / n + eps)
    return (x.float() * inv[:, None]) * g


def _rms_inputs(m, n, dt, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        3 * rng.standard_normal((m, n)).astype(np.float32)).to(getattr(torch, dt))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    return x, g


@pytest.mark.parametrize("case", RMS_CASES,
                         ids=["-".join(map(str, c)) for c in RMS_CASES])
def test_rmsnorm_emulation_within_bound(case):
    m, n, dt = case
    x, g = _rms_inputs(m, n, dt, [75, m, n, dt == "bfloat16"])
    want = rms_ref.rmsnorm(x, g, 1e-5)
    emu = _emulate_rmsnorm(x, g, 1e-5)
    err = (emu.to(x.dtype).float() - want.float()).abs()
    assert bool((err <= bounds.rmsnorm_bound(want, n)).all())
    want32 = rms_ref.rmsnorm(x.float(), g, 1e-5)
    err32 = (emu - want32).abs()
    assert bool((err32 <= bounds.rmsnorm_bound(want32, n)).all())
    if m * n >= 200 * 1600:   # another order does round otherwise
        assert float(err32.max()) > 0


@pytest.mark.parametrize("case", RMS_CASES,
                         ids=["-".join(map(str, c)) for c in RMS_CASES])
def test_rmsnorm_bound_catches_a_dropped_lane(case):
    """Lane 0's partial sum left out (lane 0 holds a vector of every row)
    moves inv by about 1 / (lanes holding the row) relative, past the
    bound's (n / 2 + 4) eps32 on the float32 output.  (A bfloat16
    output's ulp, 2**-8 relative and more, hides it where a row spreads
    over more than ~256 lanes, as at (4, 3200): there the float32 values
    before the rounding are what shows the fault.)"""
    m, n, dt = case
    x, g = _rms_inputs(m, n, dt, [76, m, n, dt == "bfloat16"])
    want32 = rms_ref.rmsnorm(x.float(), g, 1e-5)
    bound = bounds.rmsnorm_bound(want32, n)
    good = (_emulate_rmsnorm(x, g, 1e-5) - want32).abs()
    bad = (_emulate_rmsnorm(x, g, 1e-5, drop_lane=0) - want32).abs()
    assert bool((good <= bound).all())
    assert not bool((bad <= bound).all())


# -- ssd_intra -----------------------------------------------------------------

#: (p, n, lc): the three instances at a short, a ragged and a full chunk
SSD_CASES = [(p, n, lc) for p, n in ((16, 16), (64, 16), (64, 128))
             for lc in (16, 100, 256)]
SSD_TILE = 64


def _emulate_ssd(xdt, b, c, cum, drop=None, mask_after_exp=False):
    """The wgmma kernel's arithmetic on bfloat16 xdt (BC, lc, h, p), B, C
    (BC, lc, n) and float32 cum (BC, lc, h): (y, S_c) in float32.
    ``drop`` = (query tile, key tile) left out of y (a planted fault);
    ``mask_after_exp`` multiplies exp(cum_i - cum_j) by the mask instead
    of masking the exponent (the other)."""
    bc, lc, h, p = xdt.shape
    cf, bf, xf = c.float(), b.float(), xdt.float()
    y = torch.zeros((bc, lc, h, p))
    for q0 in range(0, lc, SSD_TILE):
        q1 = min(lc, q0 + SSD_TILE)
        qi = torch.arange(q0, q1)
        acc = torch.zeros((bc, q1 - q0, h, p))
        for k0 in range(0, q1, SSD_TILE):
            if drop == (q0 // SSD_TILE, k0 // SSD_TILE):
                continue
            k1 = min(lc, k0 + SSD_TILE)
            kj = torch.arange(k0, k1)
            g = torch.einsum("cin,cjn->cij", cf[:, q0:q1], bf[:, k0:k1])
            diff = cum[:, q0:q1, None, :] - cum[:, None, k0:k1, :]
            ok = (kj[None, :] <= qi[:, None])[None, :, :, None]
            if mask_after_exp:
                decay = torch.exp(diff) * ok
            else:
                decay = torch.exp(torch.where(ok, diff, -torch.inf))
            att = (g[..., None] * decay).bfloat16().float()
            acc = acc + torch.einsum("cijh,cjhp->cihp", att, xf[:, k0:k1])
        y[:, q0:q1] = acc
    w = (xf * torch.exp(cum[:, -1:, :] - cum)[..., None]).bfloat16().float()
    s_c = torch.zeros((bc, h, p, b.shape[-1]))
    for k0 in range(0, lc, SSD_TILE):
        k1 = min(lc, k0 + SSD_TILE)
        s_c = s_c + torch.einsum("cjhp,cjn->chpn", w[:, k0:k1], bf[:, k0:k1])
    return y, s_c


def _ssd_inputs(p, n, lc, seed, decay=2.0, bc=2, h=3):
    """numpy inputs from a seed: xdt, B, C standard normal (bfloat16 on
    the torch side), cum the running sum of -U(decay / 200, decay)."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((bc, lc, h, p)).astype(np.float32)
    bb = rng.standard_normal((bc, lc, n)).astype(np.float32)
    cc = rng.standard_normal((bc, lc, n)).astype(np.float32)
    cum = np.cumsum(-rng.uniform(decay / 200, decay, (bc, lc, h)),
                    axis=1).astype(np.float32)
    return xdt, bb, cc, cum


def _ssd_torch(xdt, bb, cc, cum):
    return (*(torch.from_numpy(a).bfloat16() for a in (xdt, bb, cc)),
            torch.from_numpy(cum))


def _within(got, want, bound) -> bool:
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=["-".join(map(str, c)) for c in SSD_CASES])
def test_ssd_emulation_within_bound(case):
    p, n, lc = case
    for decay in (4.0, 0.01):
        x, b, c, cum = _ssd_torch(*_ssd_inputs(p, n, lc, [77, *case],
                                               decay))
        wy, ws = ssd_ref.ssd_intra(x, b, c, cum)
        by, bs = bounds.ssd_bounds(x, b, c, cum, ssd_ref.ssd_intra,
                                   tensor_cores=True)
        ey, es = _emulate_ssd(x, b, c, cum)
        assert _within(ey, wy, by) and _within(es, ws, bs), decay
        # att's and w's rounding shows: the float32 bound is too tight
        fy, fs = bounds.ssd_bounds(x, b, c, cum, ssd_ref.ssd_intra)
        assert not (_within(ey, wy, fy) and _within(es, ws, fs))


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=["-".join(map(str, c)) for c in SSD_CASES])
def test_ssd_emulation_within_bound_of_jax(case):
    """The emulation against the JAX package's Pallas ``ssd_intra`` body
    (interpret mode, float32 sums of the bfloat16 inputs), within the
    same bound."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd.ssd import ssd_intra as jax_ssd_intra
    p, n, lc = case
    xdt, bb, cc, cum = _ssd_inputs(p, n, lc, [78, *case], 0.5, bc=1, h=2)
    x, b, c, tcum = _ssd_torch(xdt, bb, cc, cum)
    jy, js = jax_ssd_intra(*(jnp.asarray(a, jnp.bfloat16)
                             for a in (xdt, bb, cc)), jnp.asarray(cum),
                           interpret=True)
    jy, js = (torch.from_numpy(np.array(a, np.float32)) for a in (jy, js))
    by, bs = bounds.ssd_bounds(x, b, c, tcum, ssd_ref.ssd_intra,
                               tensor_cores=True)
    ey, es = _emulate_ssd(x, b, c, tcum)
    assert _within(ey, jy, by) and _within(es, js, bs)


@pytest.mark.parametrize("p, n", [(64, 16), (64, 128)])
def test_ssd_bound_catches_a_dropped_key_tile(p, n):
    """Key tile 0 left out of the last query tile's rows (a decay mild
    enough that it still weighs there) lies outside the bound."""
    x, b, c, cum = _ssd_torch(*_ssd_inputs(p, n, 256, [79, p, n], 0.01))
    wy, _ = ssd_ref.ssd_intra(x, b, c, cum)
    by, _ = bounds.ssd_bounds(x, b, c, cum, ssd_ref.ssd_intra,
                              tensor_cores=True)
    good, _ = _emulate_ssd(x, b, c, cum)
    bad, _ = _emulate_ssd(x, b, c, cum, drop=(3, 0))
    assert _within(good, wy, by)
    assert not _within(bad[:, 192:], wy[:, 192:], by[:, 192:])
    assert _within(bad[:, :192], wy[:, :192], by[:, :192])


@pytest.mark.parametrize("p, n", [(64, 16), (64, 128)])
def test_ssd_bound_catches_the_mask_after_exp(p, n):
    """A cum that falls by 2 a row on average makes exp(cum_i - cum_j)
    overflow for j > i inside a 64-key diagonal tile (past 88 = ln of
    float32's largest): masked after exp it gives inf * 0 = NaN,
    outside the bound; masked before exp (the kernel) it stays within."""
    x, b, c, cum = _ssd_torch(*_ssd_inputs(p, n, 256, [80, p, n], 4.0))
    wy, _ = ssd_ref.ssd_intra(x, b, c, cum)
    by, _ = bounds.ssd_bounds(x, b, c, cum, ssd_ref.ssd_intra,
                              tensor_cores=True)
    good, _ = _emulate_ssd(x, b, c, cum)
    bad, _ = _emulate_ssd(x, b, c, cum, mask_after_exp=True)
    assert _within(good, wy, by)
    assert not _within(bad, wy, by)


def _swizzled_tile(xdt_tile: torch.Tensor) -> torch.Tensor:
    """An xdt tile (64 keys, p <= 64 columns, bfloat16) as TMA writes it
    with the 128-byte swizzle: 64 rows of 128 bytes, 16-byte chunk k of
    row j at chunk k ^ (j % 8), columns past p zero."""
    keys, p = xdt_tile.shape
    rows = torch.zeros((keys, 64), dtype=torch.bfloat16)
    rows[:, :p] = xdt_tile
    chunks = rows.view(keys, 8, 8)
    out = torch.empty_like(chunks)
    for j in range(keys):
        for k in range(8):
            out[j, k ^ (j % 8)] = chunks[j, k]
    return out.reshape(-1)


def _ldmatrix_x4_trans(tile_flat: torch.Tensor, rows: list) -> list:
    """``hopper::ldmatrix_x4_trans`` on a flat bfloat16 tile: ``rows[l]``
    is lane l's address (in bfloat16 elements) of row l % 8 of matrix
    l / 8; returns, for each thread t, its four words as value pairs:
    matrix m's (row 2 (t % 4), column t / 4) and (row 2 (t % 4) + 1,
    column t / 4)."""
    mats = [[tile_flat[rows[8 * m + r]:rows[8 * m + r] + 8] for r in range(8)]
            for m in range(4)]
    return [[[float(mats[m][2 * (t % 4) + e][t // 4]) for e in range(2)]
             for m in range(4)] for t in range(32)]


@pytest.mark.parametrize("p", [16, 64])
def test_ssd_state_fragments_hold_w_transposed(p):
    """The states blocks' A fragments of xdt^T, one transposed ldmatrix a
    k16 step from the swizzled tile (lane l: key 16 kk + 8 (l / 16) +
    l % 8, 16-byte chunk 2 warp + (l / 8) % 2), assemble to xdt^T in the
    register A layout of csrc/hopper.cuh: a[0] (row, c), a[1] (row + 8,
    c), a[2] (row, c + 8), a[3] (row + 8, c + 8), rows 16 warp + t / 4,
    c = 16 kk + 2 (t % 4)."""
    rng = np.random.default_rng([81, p])
    tile = torch.from_numpy(rng.standard_normal((64, p))
                            .astype(np.float32)).bfloat16()
    flat = _swizzled_tile(tile)
    got = torch.full((64, 64), float("nan"))       # (rows p, keys j)
    for warp in range(4):
        for kk in range(4):
            rows = []
            for lane in range(32):
                key = kk * 16 + 8 * (lane // 16) + lane % 8
                chunk = 2 * warp + (lane // 8) % 2
                rows.append((key * 128 + ((chunk ^ (key & 7)) << 4)) // 2)
            words = _ldmatrix_x4_trans(flat, rows)
            for t in range(32):
                r0, c0 = warp * 16 + t // 4, kk * 16 + 2 * (t % 4)
                for m, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8),
                                              (8, 8))):
                    got[r0 + dr, c0 + dc:c0 + dc + 2] = torch.tensor(words[t][m])
    want = torch.zeros((64, 64))
    want[:p] = tile.float().T
    assert torch.equal(got, want)

"""The plain versions of the model stack's four kernels against the JAX
package: ``rmsnorm_2d``, ``rope_3d``, ``flash_attention_3d`` and
``ssd_intra``, each run in the JAX package through ``backend="interpret"``
(the Pallas kernel body) and ``backend="ref"`` (its jnp oracle), on the
same numpy inputs from a seed, in float32 and bfloat16.

Tolerances, per element (``torch_bounds.py`` derives the
sums' bounds; the same bounds hold the CUDA kernels to these plain
versions in ``test_torch_cuda.py``):

  * rmsnorm: ``rmsnorm_bound`` -- the mean of n squares summed in
    another order, (n/2 + 4) eps32 |y|, plus one bfloat16 ulp;
  * rope: bitwise against ``ref`` and in bfloat16 (every op rounds once
    on both sides); float32 against ``interpret`` within
    2 eps32 (|x1 cos| + |x2 sin|) for y1 (y2 alike), since XLA:CPU
    contracts the Pallas body's multiply and add into an FMA;
  * attention: ``flash_bound`` (scores summed in another order, the
    softmax over all keys against an online one); against the bfloat16
    ``ref`` backend and between the two full-softmax oracles also
    2**-8 max|v|, because they round the probabilities to bfloat16
    before the value sum;
  * SSD: ``ssd_bounds`` -- sums of n and lc terms in another order;
  * rope tables: torch's and XLA's float32 pow and cos/sin may differ
    by an ulp, which an angle of up to ~2000 rad carries into cos/sin:
    4 eps32 (|angle| + 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro.kernels import attention as jax_attention
from repro.kernels.flash_attention import attention_reference as jax_oracle
from repro.kernels import rmsnorm as jax_rmsnorm
from repro.kernels import rope as jax_rope
from repro.kernels import rope_tables as jax_rope_tables
from repro.kernels import ssd_intra as jax_ssd_intra
from repro_torch.kernels import attention
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.rope import ref as rope_ref
from repro_torch.kernels.ssd import ref as ssd_ref

import torch_bounds as bounds

EPS32 = bounds.EPS32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BACKENDS = ("interpret", "ref")


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [64, 1600, 3200])
def test_rmsnorm_plain_matches_jax(n, dtype):
    rng = np.random.default_rng([71, n])
    x = (rng.standard_normal((9, n)) * 3).astype(np.float32)
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    jx, px = _pair(x, dtype)
    want = rms_ref.rmsnorm(px, torch.from_numpy(g), 1e-5)
    assert want.dtype == DTYPES[dtype][1]
    bound = bounds.rmsnorm_bound(want, n).numpy()
    for be in BACKENDS:
        got = jax_rmsnorm(jx, jnp.asarray(g), eps=1e-5, backend=be)
        assert np.all(np.abs(_np(got) - _np(want)) <= bound), be


def _tables(positions: np.ndarray, d: int):
    """cos/sin (S, d/2) in float32 from float64 angles: one table that
    both packages take, so the kernels are compared alone."""
    inv = 1.0 / (10000.0 ** (np.arange(d // 2) / (d // 2)))
    ang = positions.astype(np.float64)[:, None] * inv[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(6, 37, 64), (4, 48, 16)])
def test_rope_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng([72, shape[1]])
    x = rng.standard_normal(shape).astype(np.float32)
    cos, sin = _tables(np.arange(2000, 2000 + shape[1]), shape[-1])
    jx, px = _pair(x, dtype)
    want = _np(rope_ref.rope(px, torch.from_numpy(cos), torch.from_numpy(sin)))
    d2 = shape[-1] // 2
    xc = _np(px)
    x1, x2 = xc[..., :d2], xc[..., d2:]
    mag = np.concatenate([np.abs(x1 * cos) + np.abs(x2 * sin),
                          np.abs(x2 * cos) + np.abs(x1 * sin)], axis=-1)
    for be in BACKENDS:
        got = _np(jax_rope(jx, jnp.asarray(cos), jnp.asarray(sin), backend=be))
        if be == "interpret" and dtype == "float32":
            assert np.all(np.abs(got - want) <= 2 * EPS32 * mag)
        else:
            assert np.array_equal(got, want), be


def test_rope_tables_match_jax():
    """The tables of positions 0..2063 (a 2048-token prompt and 16 decode
    steps) at head dims 16 and 64, from the same numpy positions."""
    positions = np.arange(2064)
    for d in (16, 64):
        jc, js = jax_rope_tables(jnp.asarray(positions), d)
        pc, ps = rope_ref.rope_tables(torch.from_numpy(positions), d)
        inv = 1.0 / (10000.0 ** (np.arange(d // 2) / (d // 2)))
        tol = 4 * EPS32 * (positions[:, None] * inv[None, :] + 1)
        assert np.all(np.abs(_np(jc) - _np(pc)) <= tol)
        assert np.all(np.abs(_np(js) - _np(ps)) <= tol)


FLASH_CASES = [
    # (B, Hkv, group, S, T, D, causal, window, q_offset)
    (1, 2, 1, 37, 37, 64, True, None, 0),
    (1, 2, 5, 200, 200, 64, True, 32, 0),
    (1, 1, 5, 130, 130, 16, True, 128, 0),     # the ref's banded path
    (1, 2, 5, 5, 261, 64, True, 64, 256),      # q_offset, S < T
    (2, 1, 1, 50, 70, 16, False, None, 0),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_plain_matches_jax(case, dtype):
    b, hkv, group, s, t, d, causal, window, q_off = case
    rng = np.random.default_rng([73, s, t, d])
    q = rng.standard_normal((b, hkv * group, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    (jq, pq), (jk, pk), (jv, pv) = (_pair(a, dtype) for a in (q, k, v))
    want = attention(pq, pk, pv, causal=causal, window=window, q_offset=q_off)
    assert want.dtype == DTYPES[dtype][1] and want.shape == pq.shape
    bound = bounds.flash_bound(pq, pk, pv, d ** -0.5, want).numpy()
    for be in BACKENDS:
        got = jax_attention(jq, jk, jv, causal=causal, window=window,
                            q_offset=q_off, backend=be)
        extra = 2.0 ** -8 * np.abs(v).max() \
            if (be == "ref" and dtype == "bfloat16") else 0.0
        assert np.all(np.abs(_np(got) - _np(want)) <= bound + extra), be


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_oracle_matches_jax(dtype):
    """The full-softmax oracle (``ref.attention``, with ``_expand_kv``)
    against the JAX package's: GQA group 5, a window, ``q_offset`` and
    ``t_actual``; the same bound as the attention op (the bfloat16
    probabilities may round apart by 2**-8 max|v|)."""
    rng = np.random.default_rng([76, dtype == "bfloat16"])
    q = rng.standard_normal((2, 10, 7, 64)).astype(np.float32)
    k = rng.standard_normal((2, 2, 40, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, 40, 64)).astype(np.float32)
    (jq, pq), (jk, pk), (jv, pv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(scale=0.125, causal=True, window=16, q_offset=30, t_actual=35)
    want = fa_ref.attention(pq, pk, pv, **kw)
    got = jax_oracle(jq, jk, jv, **kw)
    bound = bounds.flash_bound(pq, pk, pv, 0.125, want).numpy()
    extra = 2.0 ** -8 * np.abs(v).max() if dtype == "bfloat16" else 0.0
    assert want.dtype == DTYPES[dtype][1]
    assert np.all(np.abs(_np(got) - _np(want)) <= bound + extra)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 16, 4, 16, 16), (1, 256, 2, 64, 16)],
                         ids=["lc16", "lc256"])
def test_ssd_intra_plain_matches_jax(shape, dtype):
    bc, lc, h, p, n = shape
    rng = np.random.default_rng([74, lc])
    xdt = rng.standard_normal((bc, lc, h, p)).astype(np.float32)
    bb = rng.standard_normal((bc, lc, n)).astype(np.float32)
    cc = rng.standard_normal((bc, lc, n)).astype(np.float32)
    cum = np.cumsum(-rng.uniform(0.01, 0.5, (bc, lc, h)), axis=1) \
        .astype(np.float32)
    (jx, px), (jb, pb), (jc, pc) = (_pair(a, dtype) for a in (xdt, bb, cc))
    pcum = torch.from_numpy(cum)
    wy, ws = ssd_ref.ssd_intra(px, pb, pc, pcum)
    by, bs = bounds.ssd_bounds(px, pb, pc, pcum, ssd_ref.ssd_intra)
    for be in BACKENDS:
        gy, gs = jax_ssd_intra(jx, jb, jc, jnp.asarray(cum), backend=be)
        assert np.all(np.abs(_np(gy) - _np(wy)) <= by.numpy()), be
        assert np.all(np.abs(_np(gs) - _np(ws)) <= bs.numpy()), be

"""The port's Qm.n formats and fold quantisation against the JAX package's.

Every comparison here is BITWISE: the converters round a float32 product
by a power of two half-to-even and saturate, and the fold quantisation
and its bounds are the same numpy code in both packages, so there is no
rounding freedom for a tolerance to cover.  Inputs come from numpy seeds
and, for folds, through both packages' ``chain_for``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import quantize as jquantize
from repro.errors import QRangeError as JQRangeError
from repro.serving import workload as jworkload
from repro_torch import errors, quantize
from repro_torch.serving import workload

FORMATS = ("q8.7", "q15.0", "q4.11")


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def test_formats_match_reference():
    for name in FORMATS:
        fmt, ref = quantize.as_qformat(name), jquantize.as_qformat(name)
        assert (fmt.m, fmt.n, fmt.name, fmt.scale, fmt.lo, fmt.hi, fmt.eps) \
            == (ref.m, ref.n, ref.name, ref.scale, ref.lo, ref.hi, ref.eps)
        assert quantize.as_qformat(fmt) is fmt
    assert quantize.Q8_7 == quantize.QFormat(8, 7)
    assert quantize.Q15_0.name == jquantize.Q15_0.name == "q15.0"
    assert quantize.QUANTIZABLE_KINDS == jquantize.QUANTIZABLE_KINDS


@pytest.mark.parametrize("bad", ["q8.8", "q9.7", "float32", "q-1.16", "8.7",
                                 87, None, "Q8.7"])
def test_as_qformat_errors_match_reference(bad):
    assert not quantize.is_qformat(bad)
    assert jquantize.is_qformat(bad) is False
    with pytest.raises(ValueError) as got:
        quantize.as_qformat(bad)
    with pytest.raises(ValueError) as want:
        jquantize.as_qformat(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="m \\+ n = 15"):
        quantize.QFormat(8, 8)


@pytest.mark.parametrize("name", FORMATS)
def test_quantize_torch_matches_numpy_and_jax(name):
    """Ties (x * scale exactly at .5, rounding to even), the saturation
    edges and values far beyond them, random values, -0.0: the tensor
    quantiser, the numpy quantiser and the JAX twin give the same words."""
    fmt, ref = quantize.as_qformat(name), jquantize.as_qformat(name)
    rng = np.random.default_rng(len(name))
    k = np.arange(-40, 40, dtype=np.float32)
    ties = (k + np.float32(0.5)) / np.float32(fmt.scale)
    edges = np.array([fmt.hi, fmt.hi + fmt.eps / 2, fmt.hi + fmt.eps, fmt.lo,
                      fmt.lo - fmt.eps / 2, fmt.lo - fmt.eps, 1e6, -1e6, 3e38,
                      -3e38, np.inf, -np.inf, 0.0, -0.0], np.float32)
    rand = rng.uniform(fmt.lo * 1.2, fmt.hi * 1.2, 500).astype(np.float32)
    x = np.concatenate([ties, edges, rand])
    got = fmt.quantize_torch(torch.from_numpy(x))
    assert got.dtype == torch.int16
    want = fmt.quantize(x)
    assert _same_bits(got.numpy(), want)
    assert _same_bits(want, ref.quantize(x))
    assert _same_bits(want, np.asarray(ref.quantize_jnp(jnp.asarray(x))))
    assert int(got[np.flatnonzero(x == 1e6)[0]]) == 32767
    assert int(got[np.flatnonzero(x == -1e6)[0]]) == -32768
    # half-to-even at the ties: every quantised tie is an even word
    assert (got[:len(ties)].numpy() % 2 == 0).all()
    # float16 points quantise through float32, as numpy's asarray does
    half = rand.astype(np.float16)
    assert _same_bits(fmt.quantize_torch(torch.from_numpy(half)).numpy(),
                      ref.quantize(half))


@pytest.mark.parametrize("name", FORMATS)
def test_dequantize_torch_matches_numpy_and_jax(name):
    fmt, ref = quantize.as_qformat(name), jquantize.as_qformat(name)
    words = np.random.default_rng(7).integers(
        -(1 << 15), 1 << 15, 1000).astype(np.int16)
    got = fmt.dequantize_torch(torch.from_numpy(words))
    assert got.dtype == torch.float32
    assert _same_bits(got.numpy(), fmt.dequantize(words))
    assert _same_bits(got.numpy(), ref.dequantize(words))
    assert _same_bits(got.numpy(),
                      np.asarray(ref.dequantize_jnp(jnp.asarray(words))))
    # words on the grid survive a round trip
    assert _same_bits(fmt.quantize_torch(got).numpy(), words)


def _folds(seed, n_each=4):
    """(kind, port fold, reference fold) over every affine template, drawn
    from one seed through both packages' ``chain_for``."""
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    out = []
    for dim, kinds in workload.AFFINE_TEMPLATES:
        for _ in range(n_each):
            port = workload.chain_for(rng, dim, kinds)
            ref = jworkload.chain_for(jrng, dim, kinds)
            out.append((port.plan_kind, port.fold(), ref.fold()))
    return out


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("seed", [0, 1904])
def test_fold_quantisation_and_bounds_match_reference(seed, name):
    """``quantize_fold`` words, ``error_bound`` arrays and ``fits``
    verdicts equal the reference's for random folds over a range of
    x_max, and ``ensure_fits`` raises exactly when the reference does,
    with the same code and message."""
    n_fit = n_wrap = 0
    for kind, fold, jfold in _folds(seed):
        assert all(_same_bits(a, b) for a, b in zip(fold, jfold))
        words = quantize.quantize_fold(fold, kind, name)
        want = jquantize.quantize_fold(jfold, kind, name)
        assert len(words) == 2
        assert all(_same_bits(a, b) for a, b in zip(words, want))
        for x_max in (0.5, 4.0, 30.0, 200.0, 1e4):
            assert _same_bits(quantize.error_bound(fold, kind, name, x_max),
                              jquantize.error_bound(jfold, kind, name, x_max))
            fits = quantize.fits(fold, kind, name, x_max)
            assert fits == jquantize.fits(jfold, kind, name, x_max)
            n_fit += fits
            n_wrap += not fits
            if fits:
                quantize.ensure_fits(fold, kind, name, x_max, ticket=3)
                continue
            with pytest.raises(errors.QRangeError) as got:
                quantize.ensure_fits(fold, kind, name, x_max, ticket=3)
            with pytest.raises(JQRangeError) as ref:
                jquantize.ensure_fits(jfold, kind, name, x_max, ticket=3)
            assert (got.value.code, got.value.ticket, str(got.value)) \
                == (ref.value.code, ref.value.ticket, str(ref.value))
    assert n_fit and n_wrap          # both verdicts are exercised


def test_intake_rules_match_reference():
    for dt in (np.float32, np.float16, np.int16):
        assert quantize.points_need_quantize(dt) \
            == jquantize.points_need_quantize(dt)
    for dt in (np.int32, np.uint16, np.bool_):
        with pytest.raises(TypeError) as got:
            quantize.points_need_quantize(dt)
        with pytest.raises(TypeError) as want:
            jquantize.points_need_quantize(dt)
        assert str(got.value) == str(want.value)
    quantize.reject_projective(False)
    with pytest.raises(ValueError, match="fixed-point"):
        quantize.reject_projective(True)
    fold = workload.chain_for(np.random.default_rng(1), 2, "MPC").fold()
    with pytest.raises(ValueError, match="affine-only"):
        quantize.quantize_fold(fold, "projective", "q8.7")
    assert not quantize.fits(fold, "projective", "q8.7", 1.0)

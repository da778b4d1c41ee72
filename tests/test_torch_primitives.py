"""The port's eager primitives against the JAX package's.

The same numpy inputs from a seed go through the port's ops on CPU
tensors (the plain PyTorch versions a CPU tensor takes) and through the
JAX package's ops on its ``ref`` backend and on its Pallas kernels in
interpret mode.  Tolerances, per element:

  * ``affine``/``scale``/``translate``, float32: within
    4 eps32 (|x*s| + |t|) -- the interpret backend contracts the multiply
    and add into an FMA on XLA:CPU, the port never does;
  * ``vecadd``, float32: bitwise (one add rounds once on both sides);
  * bfloat16 (both): within one bfloat16 ulp of the JAX result;
  * ``matmul``, float32 out: within 2 K eps32 sum_k |x_ik y_kj|; bfloat16
    out: that plus one bfloat16 ulp of the result;
  * ``rotate2d``: within 4 eps32 (|p0| + |p1|) per coordinate (XLA's
    float32 cos/sin and the port's float64 ones rounded to float32 may
    differ by an ulp), plus one bfloat16 ulp for bfloat16 points.

Signed zeros from ``scale`` and the ``opcount`` records are held equal
to the JAX package's.  The CUDA kernels themselves are held bitwise
against the plain versions in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import kernels as jax_kernels
from repro.kernels import opcount as jax_opcount
from repro_torch import kernels as port_kernels
from repro_torch.kernels import opcount
from repro_torch.kernels.affine import ref as affine_ref
from repro_torch.kernels.matmul import ref as matmul_ref

EPS32 = float(np.finfo(np.float32).eps)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(8, 128), (7, 130), (3, 5, 100), (1, 1), (300, 2), (17, 3)]
MATMUL_SHAPES = [(17, 100, 33), (128, 128, 128), (1, 8, 1)]


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each |v| (8 significand bits; normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(v.astype(np.float64)),
                                    2.0 ** -126)))
    return 2.0 ** (e - 7)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(td)
    return j, t


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _operands(rng, shape, dtype):
    n = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.uniform(-2, 2, n).astype(np.float32)
    t = rng.uniform(-3, 3, n).astype(np.float32)
    return _pair(x, dtype), _pair(s, dtype), _pair(t, dtype)


def _affine_case(op, jx, js, jt, px, ps, pt, backend):
    if op == "affine":
        return (jax_kernels.affine(jx, js, jt, backend=backend),
                port_kernels.affine(px, ps, pt), _f64(js), _f64(jt))
    if op == "scale":
        return (jax_kernels.scale(jx, js, backend=backend),
                port_kernels.scale(px, ps), _f64(js), 0.0)
    return (jax_kernels.translate(jx, jt, backend=backend),
            port_kernels.translate(px, pt), 1.0, _f64(jt))


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["affine", "scale", "translate"])
def test_affine_ops_match_reference(op, dtype, backend):
    rng = np.random.default_rng([21, len(op), dtype == "bfloat16"])
    for shape in SHAPES:
        (jx, px), (js, ps), (jt, pt) = _operands(rng, shape, dtype)
        jout, pout, s64, t64 = _affine_case(op, jx, js, jt, px, ps, pt,
                                            backend)
        assert pout.dtype == px.dtype and pout.shape == px.shape
        got, want = _f64(pout), _f64(jout)
        if dtype == "float32":
            bound = 4 * EPS32 * (np.abs(_f64(jx) * s64) + np.abs(t64))
        else:
            bound = bf16_ulp(want)
        assert np.all(np.abs(got - want) <= bound), shape


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vecadd_matches_reference(dtype, backend):
    rng = np.random.default_rng([22, dtype == "bfloat16"])
    for shape in [(64, 128), (33, 257), (300, 2), (2, 5, 3)]:
        jx, px = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        jz, pz = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        jout = jax_kernels.vecadd(jx, jz, backend=backend)
        pout = port_kernels.vecadd(px, pz)
        got, want = _f64(pout), _f64(jout)
        if dtype == "float32":
            assert got.tobytes() == want.tobytes(), shape
        else:
            assert np.all(np.abs(got - want) <= bf16_ulp(want)), shape


def test_vecadd_casts_z_to_x_dtype_and_checks_shapes():
    x = torch.ones(4, 3, dtype=torch.bfloat16)
    z = torch.full((4, 3), 1.0 + 2 ** -10, dtype=torch.float32)
    out = port_kernels.vecadd(x, z)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, x + z.to(torch.bfloat16))
    with pytest.raises(ValueError, match="one shape"):
        port_kernels.vecadd(x, z[:2])


def test_scale_keeps_the_reference_signed_zeros():
    """``scale`` is x*s + 0, never a shortcut: x*s = -0.0 comes out +0.0
    on both packages, and ``translate``'s x*1 keeps -0.0 + t's sign
    rules."""
    x = np.array([[-1.0, 2.0, -0.0, 0.0], [3.0, -4.0, 5.0, -0.0]],
                 np.float32)
    s = np.array([0.0, -0.0, 1.0, -1.0], np.float32)
    t = np.array([0.0, -0.0, -0.0, 0.0], np.float32)
    for backend in ("ref", "interpret"):
        jout = np.asarray(jax_kernels.scale(jnp.asarray(x), jnp.asarray(s),
                                            backend=backend))
        pout = port_kernels.scale(torch.from_numpy(x),
                                  torch.from_numpy(s)).numpy()
        assert pout.tobytes() == jout.tobytes()
        assert not np.signbit(pout).any()
        jt = np.asarray(jax_kernels.translate(jnp.asarray(x), jnp.asarray(t),
                                              backend=backend))
        pt = port_kernels.translate(torch.from_numpy(x),
                                    torch.from_numpy(t)).numpy()
        assert pt.tobytes() == jt.tobytes()
    assert affine_ref.scale(torch.from_numpy(x), torch.from_numpy(s)) \
        .numpy().tobytes() == pout.tobytes()
    assert affine_ref.translate(torch.from_numpy(x), torch.from_numpy(t)) \
        .numpy().tobytes() == pt.tobytes()


def _matmul_bound(x64, y64, k, want, out_bf16):
    bound = 2 * k * EPS32 * (np.abs(x64) @ np.abs(y64))
    return bound + bf16_ulp(want) if out_bf16 else bound


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("out", ["float32", "input"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_reference(dtype, out, backend):
    rng = np.random.default_rng([23, dtype == "bfloat16", out == "input"])
    for m, k, n in MATMUL_SHAPES:
        jx, px = _pair(rng.standard_normal((m, k)).astype(np.float32), dtype)
        jy, py = _pair(rng.standard_normal((k, n)).astype(np.float32), dtype)
        jod, tod = (jnp.float32, torch.float32) if out == "float32" \
            else (None, None)
        jout = jax_kernels.matmul(jx, jy, backend=backend, out_dtype=jod)
        pout = port_kernels.matmul(px, py, out_dtype=tod)
        assert pout.dtype == (tod or px.dtype) and pout.shape == (m, n)
        want = _f64(jout)
        bound = _matmul_bound(_f64(jx), _f64(jy), k, want,
                              pout.dtype == torch.bfloat16)
        assert np.all(np.abs(_f64(pout) - want) <= bound), (m, k, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_long_contraction_and_batched_lead(dtype):
    """K = 1024 against the JAX ``ref`` backend, and leading dims batched
    by reshape (rank-3 x)."""
    rng = np.random.default_rng([24, dtype == "bfloat16"])
    for xshape, k, n in [((8, 1024), 1024, 16), ((2, 5, 7), 7, 3)]:
        jx, px = _pair(rng.standard_normal(xshape).astype(np.float32), dtype)
        jy, py = _pair(rng.standard_normal((k, n)).astype(np.float32), dtype)
        jout = jax_kernels.matmul(jx, jy, backend="ref")
        pout = port_kernels.matmul(px, py)
        assert pout.shape == (*xshape[:-1], n) and pout.dtype == px.dtype
        want = _f64(jout).reshape(-1, n)
        bound = _matmul_bound(_f64(jx).reshape(-1, k), _f64(jy), k, want,
                              dtype == "bfloat16")
        assert np.all(np.abs(_f64(pout).reshape(-1, n) - want) <= bound)


def test_matmul_plain_version_accumulates_k_ascending():
    """The plain version's order, spelled out: products added one at a
    time, k ascending from 0, in float32 -- so it equals a float32 numpy
    loop in the same order bit for bit."""
    rng = np.random.default_rng(25)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    y = rng.standard_normal((9, 4)).astype(np.float32)
    acc = np.zeros((6, 4), np.float32)
    for k in range(9):
        acc = acc + x[:, k:k + 1] * y[k:k + 1, :]
    got = matmul_ref.matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert got.numpy().tobytes() == acc.tobytes()
    mixed = port_kernels.matmul(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(y), out_dtype=torch.float32)
    assert mixed.dtype == torch.float32


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate2d_matches_reference(dtype, backend):
    rng = np.random.default_rng([26, dtype == "bfloat16"])
    for theta in (0.3, -1.1, 2.4, 1e-3):
        jp, pp = _pair((rng.standard_normal((500, 2)) * 3)
                       .astype(np.float32), dtype)
        jout = jax_kernels.rotate2d(jp, theta, backend=backend)
        pout = port_kernels.rotate2d(pp, theta)
        assert pout.dtype == pp.dtype and pout.shape == pp.shape
        want = _f64(jout)
        p64 = _f64(jp)
        bound = 4 * EPS32 * np.abs(p64).sum(axis=-1, keepdims=True)
        if dtype == "bfloat16":
            bound = bound + bf16_ulp(want)
        assert np.all(np.abs(_f64(pout) - want) <= bound), theta


def test_opcount_records_equal_the_reference():
    """Each eager op records the JAX package's op name and byte count for
    the same call (float32 and bfloat16, any rank)."""
    rng = np.random.default_rng(27)
    for dtype in ("float32", "bfloat16"):
        jx, px = _pair(rng.standard_normal((3, 5, 7)).astype(np.float32),
                       dtype)
        jz, pz = _pair(rng.standard_normal((3, 5, 7)).astype(np.float32),
                       dtype)
        jy, py = _pair(rng.standard_normal((7, 4)).astype(np.float32), dtype)
        jp, pp = _pair(rng.standard_normal((11, 2)).astype(np.float32),
                       dtype)
        with jax_opcount.counting() as jrec:
            jax_kernels.affine(jx, 2.0, 1.0, backend="ref")
            jax_kernels.scale(jx, 2.0, backend="ref")
            jax_kernels.translate(jx, 1.0, backend="ref")
            jax_kernels.vecadd(jx, jz, backend="ref")
            jax_kernels.matmul(jx, jy, backend="ref")
            jax_kernels.matmul(jx, jy, backend="ref", out_dtype=jnp.float32)
            jax_kernels.rotate2d(jp, 0.3, backend="ref")
        with opcount.counting() as prec:
            port_kernels.affine(px, 2.0, 1.0)
            port_kernels.scale(px, 2.0)
            port_kernels.translate(px, 1.0)
            port_kernels.vecadd(px, pz)
            port_kernels.matmul(px, py)
            port_kernels.matmul(px, py, out_dtype=torch.float32)
            port_kernels.rotate2d(pp, 0.3)
        assert prec == jrec and len(prec) == 7


def test_primitive_wrappers_raise_on_cpu_tensors_and_bad_dtypes():
    """A kernel wrapper never runs its plain version in its place: a CPU
    tensor raises, as does ``backend="cuda"`` on one; float16 and float64
    are not kernel dtypes."""
    from repro_torch.kernels.affine import affine as affine_k
    from repro_torch.kernels.matmul import matmul as matmul_k
    x = torch.ones(4, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        affine_k.affine_2d(x, torch.ones(3), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA device"):
        affine_k.vecadd_2d(x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        matmul_k.matmul_2d(x, torch.ones(3, 2))
    for op, args in ((port_kernels.affine, (x, 1.0, 0.0)),
                     (port_kernels.vecadd, (x, x)),
                     (port_kernels.matmul, (x, torch.ones(3, 2))),
                     (port_kernels.rotate2d, (torch.ones(4, 2), 0.3))):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            op(*args, backend="cuda")

"""The port's chain kernels against the JAX package's.

The same numpy inputs go through the port's plain PyTorch versions (the
path a CPU tensor takes) and through the JAX package's Pallas kernels in
interpret mode and its jnp oracles.  Tolerance, elementwise:

    |port - jax| <= 4 eps32 (sum_m |p_m A_mc| + |t_c|),  A = diag(s) for diag

because XLA:CPU contracts some multiply-adds into FMAs and the port never
does.  Within the port the batched form equals the per-request form
bitwise.  The CUDA kernels themselves are held against the plain versions
in ``test_torch_cuda.py``, which runs on a GPU machine without jax.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import kernels as jax_kernels
from repro_torch.kernels import chain_apply, chain_apply_batch, chain_diag, \
    chain_diag_batch
from repro_torch.kernels.affine import ref as diag_ref
from repro_torch.kernels.matmul import ref as matrix_ref

EPS32 = float(np.finfo(np.float32).eps)
FLAT_N = (1, 37, 300)
BATCH_BL = ((1, 8), (5, 13), (12, 24))


def _inputs(rng, lead, d, kind):
    """Points (*lead, d) and folded params for ``kind``, batched over
    lead[0] when len(lead) == 2."""
    pts = rng.standard_normal((*lead, d)).astype(np.float32)
    plead = lead[:1] if len(lead) == 2 else ()
    t = rng.uniform(-3, 3, (*plead, d)).astype(np.float32)
    if kind == "diag":
        p = rng.uniform(0.2, 2.0, (*plead, d)).astype(np.float32)
    else:
        p = rng.uniform(-1.5, 1.5, (*plead, d, d)).astype(np.float32)
    return pts, p, t


def _bound(pts, p, t, kind):
    """4 eps32 (sum_m |p_m A_mc| + |t_c|) for every output element."""
    x = np.abs(pts.astype(np.float64))
    a, tt = np.abs(p.astype(np.float64)), np.abs(t.astype(np.float64))
    if kind == "diag":
        mag = x * (a[:, None, :] if pts.ndim == 3 else a)
    elif pts.ndim == 3:
        mag = np.einsum("blm,bmc->blc", x, a)
    else:
        mag = x @ a
    return 4 * EPS32 * (mag + (tt[:, None, :] if pts.ndim == 3 else tt))


def _port(kind, batched, pts, p, t):
    fn = {("diag", False): chain_diag, ("diag", True): chain_diag_batch,
          ("matrix", False): chain_apply,
          ("matrix", True): chain_apply_batch}[kind, batched]
    out = fn(torch.from_numpy(pts), torch.from_numpy(p), torch.from_numpy(t))
    assert out.dtype == torch.float32 and out.shape == pts.shape
    return out.numpy()


def _jax(kind, batched, pts, p, t, backend):
    fn = {("diag", False): jax_kernels.chain_diag,
          ("diag", True): jax_kernels.chain_diag_batch,
          ("matrix", False): jax_kernels.chain_apply,
          ("matrix", True): jax_kernels.chain_apply_batch}[kind, batched]
    return np.asarray(fn(jnp.asarray(pts), jnp.asarray(p), jnp.asarray(t),
                         backend=backend))


@pytest.mark.parametrize("backend", ["interpret", "ref"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_flat_matches_reference(kind, d, backend):
    rng = np.random.default_rng([11, d, kind == "diag"])
    for n in FLAT_N:
        pts, p, t = _inputs(rng, (n,), d, kind)
        got = _port(kind, False, pts, p, t)
        want = _jax(kind, False, pts, p, t, backend)
        assert np.all(np.abs(got.astype(np.float64) - want)
                      <= _bound(pts, p, t, kind)), (n, backend)


@pytest.mark.parametrize("backend", ["interpret", "ref"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_batch_matches_reference(kind, d, backend):
    rng = np.random.default_rng([12, d, kind == "diag"])
    for bsz, length in BATCH_BL:
        pts, p, t = _inputs(rng, (bsz, length), d, kind)
        got = _port(kind, True, pts, p, t)
        want = _jax(kind, True, pts, p, t, backend)
        assert np.all(np.abs(got.astype(np.float64) - want)
                      <= _bound(pts, p, t, kind)), (bsz, length, backend)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_batch_equals_per_request_bitwise(kind, d):
    rng = np.random.default_rng([13, d])
    for bsz, length in BATCH_BL:
        pts, p, t = _inputs(rng, (bsz, length), d, kind)
        batched = _port(kind, True, pts, p, t)
        for b in range(bsz):
            single = _port(kind, False, pts[b], p[b], t[b])
            assert batched[b].tobytes() == single.tobytes()


def test_plain_versions_round_each_op():
    """The plain diag version is a rounded multiply then a rounded add,
    never a fused multiply-add: on an input where the two differ, it
    gives the two-rounding answer."""
    x = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    s = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    t = torch.tensor([-1.0], dtype=torch.float32)
    two_roundings = np.float32(np.float32(x.item() * s.item()) + np.float32(-1.0))
    fused = np.float32((1.0 + 2.0 ** -12) ** 2 - 1.0)
    assert two_roundings != fused
    assert diag_ref.chain_diag(x, s, t).item() == two_roundings
    a = torch.tensor([[1.0 + 2.0 ** -12]], dtype=torch.float32)
    assert matrix_ref.chain_matrix(x[:, None], a, t).item() == two_roundings


def test_scalar_params_broadcast():
    pts = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (10, 3)).astype(np.float32))
    got = chain_diag(pts, 2.0, -1.0)
    assert torch.equal(got, pts * 2.0 - 1.0)

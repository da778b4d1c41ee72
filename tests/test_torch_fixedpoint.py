"""The port's fixed-point chain kernels' plain versions against the JAX
package's.

The same full-range int16 words (made from numpy seeds: products reach
2**30 and sums of them wrap the int32 accumulator) at n_frac 0, 7 and 15
go through the port's plain PyTorch versions (the path a CPU tensor
takes) and through the JAX package's ``repro.kernels.fixedpoint`` on its
``ref`` backend and its Pallas kernels in interpret mode.  Every
comparison is BITWISE: the arithmetic is integer, exact and wraps the
same way everywhere.  The CUDA kernels are held against the plain
versions in ``test_torch_cuda.py``; here their uint32 arithmetic is
replayed in numpy against the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import kernels as jkernels
from repro.kernels.fixedpoint import ref as jref
from repro_torch.kernels import (chain_apply_batch_q, chain_apply_q,
                                 chain_diag_batch_q, chain_diag_q)
from repro_torch.kernels.fixedpoint import fixedpoint as q_k
from repro_torch.kernels.fixedpoint import ref

FRACS = (0, 7, 15)
OPS = {"diag": (chain_diag_q, jkernels.chain_diag_q, ref.np_chain_diag_q),
       "matrix": (chain_apply_q, jkernels.chain_apply_q,
                  ref.np_chain_matrix_q)}
BATCH_OPS = {"diag": (chain_diag_batch_q, jkernels.chain_diag_batch_q),
             "matrix": (chain_apply_batch_q, jkernels.chain_apply_batch_q)}


def _words(rng, shape):
    return rng.integers(-(1 << 15), 1 << 15, shape).astype(np.int16)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _params(rng, kind, lead, d):
    shape = (*lead, d) if kind == "diag" else (*lead, d, d)
    return _words(rng, shape), _words(rng, (*lead, d))


@pytest.mark.parametrize("n_frac", FRACS)
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_plain_version_matches_reference(kind, d, n_frac):
    op, jop, oracle = OPS[kind]
    rng = np.random.default_rng([40, d, n_frac, len(kind)])
    for n in (1, 37, 300):
        p = _words(rng, (n, d))
        par, t = _params(rng, kind, (), d)
        got = op(torch.from_numpy(p), torch.from_numpy(par),
                 torch.from_numpy(t), n_frac=n_frac)
        assert got.dtype == torch.int16 and got.shape == p.shape
        want = oracle(p, par, t, n_frac)
        assert _same_bits(want, (jref.np_chain_diag_q if kind == "diag"
                                 else jref.np_chain_matrix_q)(p, par, t,
                                                              n_frac))
        assert _same_bits(got.numpy(), want)
        for backend in ("ref", "interpret"):
            jout = jop(jnp.asarray(p), par, t, n_frac=n_frac,
                       backend=backend)
            assert _same_bits(got.numpy(), np.asarray(jout)), backend


@pytest.mark.parametrize("n_frac", FRACS)
@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_batch_matches_reference_and_per_request(kind, n_frac):
    op, jop = BATCH_OPS[kind]
    single, _, oracle = OPS[kind]
    rng = np.random.default_rng([41, n_frac, len(kind)])
    for b, lpad, d in ((5, 24, 3), (3, 40, 2), (1, 8, 3)):
        pts3 = _words(rng, (b, lpad, d))
        par, t = _params(rng, kind, (b,), d)
        got = op(torch.from_numpy(pts3), torch.from_numpy(par),
                 torch.from_numpy(t), n_frac=n_frac).numpy()
        for backend in ("ref", "interpret"):
            jout = jop(jnp.asarray(pts3), par, t, n_frac=n_frac,
                       backend=backend)
            assert _same_bits(got, np.asarray(jout)), backend
        for i in range(b):
            assert _same_bits(got[i], oracle(pts3[i], par[i], t[i], n_frac))
            row = single(torch.from_numpy(pts3[i]), torch.from_numpy(par[i]),
                         torch.from_numpy(t[i]), n_frac=n_frac)
            assert _same_bits(got[i], row.numpy())


@pytest.mark.parametrize("n_frac", range(16))
def test_kernel_integer_arithmetic_equals_oracle(n_frac):
    """The CUDA kernels multiply, add and shift in uint32 and shift right
    LOGICALLY before keeping the low 16 bits (no signed overflow, no
    shift of a negative value).  Replayed here in numpy over full-range
    words, that arithmetic gives the oracle's words at every n_frac."""
    rng = np.random.default_rng([42, n_frac])
    for d in (2, 3):
        p, a, t = _words(rng, (500, d)), _words(rng, (d, d)), _words(rng, d)
        pu, au, tu = (x.astype(np.int32).view(np.uint32) for x in (p, a, t))
        rnd = np.uint32((1 << (n_frac - 1)) if n_frac else 0)
        with np.errstate(over="ignore"):
            acc = np.stack([(tu[c] << np.uint32(n_frac))
                            + sum(pu[:, m] * au[m, c] for m in range(d))
                            for c in range(d)], axis=-1).astype(np.uint32)
            words = ((acc + rnd) >> np.uint32(n_frac)).astype(np.uint16)
        assert _same_bits(words.view(np.int16),
                          ref.np_chain_matrix_q(p, a, t, n_frac))
        s = _words(rng, d)
        su = s.astype(np.int32).view(np.uint32)
        with np.errstate(over="ignore"):
            acc = (pu * su + (tu << np.uint32(n_frac))).astype(np.uint32)
            words = ((acc + rnd) >> np.uint32(n_frac)).astype(np.uint16)
        assert _same_bits(words.view(np.int16),
                          ref.np_chain_diag_q(p, s, t, n_frac))


def test_operands_must_be_int16_words():
    """As the reference's ``_as_q``: a non-int16 operand raises TypeError
    and is never cast into the lane; points too."""
    p = torch.ones(4, 2, dtype=torch.int16)
    s = torch.ones(2, dtype=torch.int16)
    t = torch.zeros(2, dtype=torch.int16)
    chain_diag_q(p, s, t, n_frac=7)
    with pytest.raises(TypeError, match="int16"):
        chain_diag_q(p, s.float(), t, n_frac=7)
    with pytest.raises(TypeError, match="int16"):
        chain_diag_q(p, 1, t, n_frac=7)
    with pytest.raises(TypeError, match="int16"):
        chain_diag_q(p.float(), s, t, n_frac=7)
    with pytest.raises(TypeError, match="int16"):
        chain_apply_q(p, torch.eye(2), t, n_frac=7)
    with pytest.raises(TypeError, match="int16"):
        chain_apply_batch_q(p[None], torch.eye(2, dtype=torch.int16)[None],
                            t[None].int(), n_frac=7)
    # numpy int16 words are accepted and broadcast like the reference's
    out = chain_diag_q(p, np.int16(3), np.zeros(2, np.int16), n_frac=0)
    assert out.tolist() == [[3, 3]] * 4


def test_cuda_backend_and_wrappers_refuse_cpu_tensors():
    p = torch.ones(4, 3, dtype=torch.int16)
    s = torch.ones(3, dtype=torch.int16)
    t = torch.zeros(3, dtype=torch.int16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_diag_q(p, s, t, n_frac=7, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_apply_batch_q(p[None], s.diag()[None], t[None], n_frac=7,
                            backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        q_k.chain_diag_1d_q(p.reshape(-1), s, t, d=3, n_frac=7)
    with pytest.raises(ValueError, match="CUDA device"):
        q_k.chain_matrix_batch_2d_q(p[None], s.diag()[None], t[None],
                                    n_frac=7)
    with pytest.raises(ValueError, match="backend must be"):
        chain_diag_q(p, s, t, n_frac=7, backend="interpret")

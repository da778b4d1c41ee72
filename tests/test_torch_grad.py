"""The model kernels under autograd (``repro_torch.kernels.grad``) on the
CPU, where no kernel runs: each of the five Functions is applied with
the kernel's plain version in the kernel's place, and its output and the
gradients of every input must equal direct autograd of the plain version
bit for bit (the Function's backward is that plain version's vjp,
recomputed from the saved inputs).  Also: the plain backwards are
counted; the wrappers raise on an input that requires grad; the ops on a
CPU tensor stay differentiable (no detached output); the training path's
attention is the JAX ``ref`` backend's choice (banded or blockwise); and
a checkpointed layer recomputes the Functions, whose saved tensors are
its inputs.  The CUDA halves of these checks are in
``tests/test_torch_cuda.py``.  Tolerance: none, every comparison is
bitwise.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.kernels import _build, attention, grad  # noqa: E402
from repro_torch.kernels.affine import ref as affine_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402
from repro_torch.kernels.rope import ref as rope_ref  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402


def _t(rng, *shape, dtype=torch.float32, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(dtype)


def _cases(rng):
    """name -> (Function, plain, inputs, which inputs require grad)."""
    cos, sin = rope_ref.rope_tables(torch.arange(40), 16)
    cum = torch.cumsum(-torch.from_numpy(
        rng.uniform(0.01, 0.2, (3, 16, 2)).astype(np.float32)), dim=1)
    flash = lambda q, k, v: fa_ref.autodiff_attention(   # noqa: E731
        q, k, v, scale=0.25, causal=True, window=None, block_kv=16)
    return {
        "vecadd_2d": (grad.VecAdd, affine_ref.vecadd,
                      (_t(rng, 6, 8), _t(rng, 6, 8)), (True, True)),
        "rmsnorm_2d": (grad.RMSNorm,
                       lambda x, g: rms_ref.rmsnorm(x, g, 1e-5),
                       (_t(rng, 6, 8, dtype=torch.bfloat16, scale=3.0),
                        1.0 + _t(rng, 8, scale=0.1)), (True, True)),
        "rope_3d": (grad.Rope, rope_ref.rope,
                    (_t(rng, 4, 40, 16), cos, sin), (True, False, False)),
        "flash_attention_3d": (grad.FlashAttention, flash,
                               (_t(rng, 2, 4, 40, 16), _t(rng, 2, 2, 40, 16),
                                _t(rng, 2, 2, 40, 16)), (True, True, True)),
        "ssd_intra": (grad.SSDIntra, ssd_ref.ssd_intra,
                      (_t(rng, 3, 16, 2, 16), _t(rng, 3, 16, 16),
                       _t(rng, 3, 16, 16), cum), (True, True, True, True)),
    }


@pytest.mark.parametrize("name", ["vecadd_2d", "rmsnorm_2d", "rope_3d",
                                  "flash_attention_3d", "ssd_intra"])
def test_function_gradients_equal_plain_autograd(name):
    rng = np.random.default_rng([27, len(name)])
    fn, plain, inputs, needs = _cases(rng)[name]
    grad.reset_backward_counts()

    def leaves():
        return [x.clone().requires_grad_(n) for x, n in zip(inputs, needs)]
    xs, ys = leaves(), leaves()
    got = fn.apply(name, plain, plain, *xs)
    want = plain(*ys)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert type(got[0].grad_fn).__name__ == fn.__name__ + "Backward"
    cots = [_t(rng, *w.shape, dtype=w.dtype) for w in want]
    torch.autograd.backward(got, cots)
    torch.autograd.backward(want, cots)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for x, y, n in zip(xs, ys, needs):
        assert (x.grad is None) == (not n)
        if n:
            assert x.grad.dtype == y.grad.dtype
            assert torch.equal(x.grad, y.grad), name
    assert grad.backward_counts() == {name: 1}


def test_wrappers_raise_on_inputs_that_require_grad():
    """A wrapper called directly on an input autograd records raises
    before it could return a detached output; under no_grad it gets as
    far as its device check."""
    x = torch.ones(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.check_dense(x)
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.check_operands(x.reshape(-1), torch.ones(2), torch.ones(2),
                              d=2)
    from repro_torch.kernels.affine import affine
    from repro_torch.kernels.matmul import matmul
    with pytest.raises(RuntimeError, match="requires grad"):
        matmul.matmul_2d(x, torch.ones(8, 2))
    with pytest.raises(RuntimeError, match="requires grad"):
        affine.chain_diag_1d(x.reshape(-1), torch.ones(2), torch.zeros(2),
                             d=2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA device"):
            matmul.matmul_2d(x, torch.ones(8, 2))


def test_cpu_ops_stay_differentiable():
    """On CPU tensors the ops run their plain versions, whose outputs
    carry a grad_fn; the geometry and eager ops too."""
    from repro_torch.kernels import chain_diag, matmul, rmsnorm, vecadd
    x = torch.ones(4, 2, requires_grad=True)
    for out in (chain_diag(x, 2.0, 1.0), matmul(x, torch.eye(2)),
                rmsnorm(x, torch.ones(2)), vecadd(x, x)):
        assert out.grad_fn is not None


@pytest.mark.parametrize("s,window,banded", [(256, 128, True),
                                             (300, 128, True),
                                             (256, 100, False),
                                             (256, 256, False),
                                             (256, None, False)])
def test_training_attention_picks_the_reference_rule(s, window, banded):
    """A CPU call takes the JAX ``ref`` backend's rule, recorded by
    autograd or not: banded for causal sliding-window self-attention from
    position 0 with window < S and a multiple of 128, else blockwise with
    ``block_kv``; the kernel's own function, ``flash_attention``, agrees
    with it to float32 rounding."""
    rng = np.random.default_rng([27, s])
    q, k, v = _t(rng, 1, 2, s, 16), _t(rng, 1, 1, s, 16), _t(rng, 1, 1, s, 16)
    qr = q.clone().requires_grad_(True)
    got = attention(qr, k, v, window=window, block_kv=64)
    if banded:
        want = fa_ref.banded_swa_attention(q, k, v, scale=0.25,
                                           window=window)
    else:
        want = fa_ref.blockwise_attention(q, k, v, scale=0.25, window=window,
                                          block_kv=64)
    assert torch.equal(got, want)
    serve = attention(q, k, v, window=window, block_kv=64)
    assert torch.equal(serve, want)
    kernel_fn = fa_ref.flash_attention(
        q.reshape(2, s, 16), k.reshape(1, s, 16), v.reshape(1, s, 16),
        scale=0.25, window=window).reshape(1, 2, s, 16)
    assert torch.allclose(serve, kernel_fn, rtol=0, atol=1e-5)


def test_checkpoint_recomputes_the_functions_from_their_inputs():
    """Non-reentrant checkpointing of a layer of Functions (plain
    versions in the kernels' place): the forward runs again in the
    backward pass, each Function's plain backward once, and the
    gradients equal the unchecked layer's bit for bit."""
    rng = np.random.default_rng(27)
    calls = []

    def counted(fn):
        def run(*a):
            calls.append(fn.__name__)
            return fn(*a)
        return run
    norm = lambda x, g: rms_ref.rmsnorm(x, g, 1e-5)   # noqa: E731
    norm.__name__ = "rmsnorm"

    def layer(x, g):
        h = grad.RMSNorm.apply("rmsnorm_2d", counted(norm), norm, x, g)
        return grad.VecAdd.apply("vecadd_2d", counted(affine_ref.vecadd),
                                 affine_ref.vecadd, x, torch.tanh(h))
    x0, g0 = _t(rng, 6, 8), 1.0 + _t(rng, 8, scale=0.1)
    grads = []
    for remat in (False, True):
        calls.clear()
        grad.reset_backward_counts()
        x, g = x0.clone().requires_grad_(True), g0.clone().requires_grad_(True)
        out = checkpoint(layer, x, g, use_reentrant=False) if remat \
            else layer(x, g)
        out.square().sum().backward()
        grads.append((x.grad, g.grad))
        assert calls == ["rmsnorm", "vecadd"] * (2 if remat else 1)
        assert grad.backward_counts() == {"rmsnorm_2d": 1, "vecadd_2d": 1}
    assert all(torch.equal(a, b) for a, b in zip(*grads))

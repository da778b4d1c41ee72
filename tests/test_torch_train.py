"""The port's training path against the JAX package's, on the CPU: the
loss (``layers.cross_entropy``), the training path's attention
(``blockwise_attention``, ``banded_swa_attention``, also from a query
offset as on a rank of the sequence split), ``Model.loss`` and
the gradient of every parameter for each family at ``reduced()``
(yi-6b and h2o-danube-1.8b dense, the second with a sliding window;
granite-moe-3b-a800m MoE; mamba2-130m SSM; hymba-1.5b hybrid;
internvl2-76b VLM with patches; whisper-medium enc-dec with frames), the
three remat policies, and ``make_train_step`` with 1 and 2
micro-batches; then the card's launch and backward counts with the
kernels' plain versions standing in for the kernels, and the JAX
package's loss-decreases tests (``tests/test_system.py``) on the port's
``train_loop``.

The JAX model runs its ``ref`` backend (its autodiff path, as its own
training tests do); the weights come across by
``convert.model_params_from_reference``, the optimizer state by
``convert.opt_state_from_reference``; inputs come from a numpy seed.

Tolerances (the reduced configs are float32 end to end; the port sums in
other orders -- the matmuls, the sequential inter-chunk scan against
``associative_scan`` -- and its transcendental functions may differ by
an ulp): the loss within 1e-5 relative, each gradient and each attention
output within 1e-4 of the largest magnitude of its tensor (the
reference's own serving parity bound, ``tests/test_torch_models.py``);
the attention functions and cross entropy, one op deep, within 1e-5.
After one AdamW step the moments within 1e-4 of their largest
magnitude, and the parameters within ``lr * 2e-3`` (plus 1e-6) wherever
the reference's gradient stands 10 tolerances clear of zero: Adam's
first update is g / (|g| + eps), so where the gradient is itself within
the tolerance of zero its sign, and the update with it, may flip, and
there the bound is the flip, 2 lr.  The remat policies are held bit for
bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.distributed.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels.flash_attention import ref as jax_fa_ref  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models.layers import cross_entropy as jax_cross_entropy  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 opt_state_from_reference)
from repro_torch.distributed import elastic  # noqa: E402
from repro_torch.distributed.steps import make_train_step  # noqa: E402
from repro_torch.kernels import _build, dispatch, grad  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import cross_entropy  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import leaves, tree_map  # noqa: E402

ARCHS = ["yi-6b", "h2o-danube-1.8b", "granite-moe-3b-a800m", "mamba2-130m",
         "hymba-1.5b", "internvl2-76b", "whisper-medium"]
BATCH, SEQ = 2, 64
RTOL = 1e-4
_RUNS = {}


def _close(got: torch.Tensor, want, rtol: float = RTOL) -> bool:
    want = np.asarray(want, np.float64)
    tol = rtol * max(np.abs(want).max(), 1e-30)
    return got.shape == want.shape and bool(
        np.abs(got.detach().double().numpy() - want).max() <= tol)


def _batch(cfg, b=BATCH, s=SEQ, seed=0) -> dict:
    """numpy tokens, labels (the first five of row 0 masked) and the
    frontend's stubs."""
    rng = np.random.default_rng([27, seed])
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    out["labels"][0, :5] = -1
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _with_grad(params):
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _port_loss_and_grads(cfg, params, batch):
    ps = _with_grad(params)
    loss, metrics = build(cfg).loss(ps, _torch_batch(batch))
    return loss, metrics, torch.autograd.grad(loss, leaves(ps))


def _run(arch: str) -> dict:
    """The JAX package's loss and gradients on one arch, run once."""
    if arch in _RUNS:
        return _RUNS[arch]
    cfg = jax_configs.get(arch).reduced()
    pcfg = configs.get(arch).reduced()
    jm = jax_build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    with jax_dispatch.use_backend("ref"):
        (loss, metrics), g = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    run = {"cfg": pcfg, "batch": batch, "loss": float(loss),
           "aux": float(metrics["aux"]),
           "params": model_params_from_reference(
               pcfg, jax.tree.map(np.asarray, params), device="cpu"),
           "grads": leaves(model_params_from_reference(
               pcfg, jax.tree.map(np.asarray, g), device="cpu"))}
    _RUNS[arch] = run
    return run


# -- one op deep ---------------------------------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(27)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:] = -1
    jl, jg = jax.value_and_grad(jax_cross_entropy)(jnp.asarray(logits),
                                                   jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = cross_entropy(x, torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _close(x.grad, jg, 1e-5)
    # every label masked: the denominator is floored at 1, the loss is 0
    none = torch.full((3, 7), -1)
    assert float(cross_entropy(x.detach(), none)) == 0.0


def _attention_case(fn_port, fn_jax, shapes, seed):
    rng = np.random.default_rng([27, seed])
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    cot = rng.standard_normal(shapes[0]).astype(np.float32)
    want, vjp = jax.vjp(fn_jax, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(cot))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = fn_port(*xs)
    got.backward(torch.from_numpy(cot))
    assert _close(got, want, 1e-5)
    for x, g in zip(xs, want_g):
        assert _close(x.grad, g, 1e-5)


@pytest.mark.parametrize("s,window", [(256, 128), (300, 128), (384, 256)])
def test_banded_swa_attention_matches_reference(s, window):
    """Window 128 at S 256 (two whole blocks), a padded tail (S 300) and
    window 256 at S 384, GQA group 2: values and the vjp."""
    shapes = ((1, 4, s, 16), (1, 2, s, 16), (1, 2, s, 16))
    _attention_case(
        lambda q, k, v: fa_ref.banded_swa_attention(q, k, v, scale=0.25,
                                                    window=window),
        lambda q, k, v: jax_fa_ref.banded_swa_attention(q, k, v, scale=0.25,
                                                        window=window),
        shapes, s)


@pytest.mark.parametrize("s,window,q_offset", [
    (256, 128, 127), (300, 128, 100), (384, 256, 255), (200, 128, 5)])
def test_banded_attention_from_a_query_offset_matches_reference(
        s, window, q_offset):
    """A rank of the sequence split: queries from ``q_offset`` against the
    keys from position 0 (T = q_offset + S), banded through
    ``autodiff_attention`` as the reference's blockwise attention with
    the same offset: window - 1 keys before (127, 255), fewer (100, 5), a
    padded tail (300, 200); values and the vjp."""
    t = s + q_offset
    shapes = ((1, 4, s, 16), (1, 2, t, 16), (1, 2, t, 16))
    kw = dict(scale=0.25, causal=True, window=window, q_offset=q_offset)
    _attention_case(
        lambda q, k, v: fa_ref.autodiff_attention(q, k, v, **kw),
        lambda q, k, v: jax_fa_ref.blockwise_attention(q, k, v, block_kv=64,
                                                       **kw),
        shapes, s + 7 * q_offset)


@pytest.mark.parametrize("t,causal,window,q_offset", [
    (200, True, None, 0), (200, True, 48, 0), (150, False, None, 0),
    (200, True, None, 100), (40, True, None, 0)])
def test_blockwise_attention_matches_reference(t, causal, window, q_offset):
    """KV blocks of 64 over T = 200 (a padded last block) and 150, with a
    causal mask, a window, no mask, a query offset, and T below one block
    (the direct softmax): values and the vjp."""
    s = t - q_offset
    shapes = ((2, 4, s, 16), (2, 2, t, 16), (2, 2, t, 16))
    kw = dict(scale=0.25, causal=causal, window=window, q_offset=q_offset,
              block_kv=64)
    _attention_case(
        lambda q, k, v: fa_ref.blockwise_attention(q, k, v, **kw),
        lambda q, k, v: jax_fa_ref.blockwise_attention(q, k, v, **kw),
        shapes, t + q_offset)


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    run = _run(arch)
    loss, metrics, grads = _port_loss_and_grads(run["cfg"], run["params"],
                                                run["batch"])
    assert abs(float(loss) - run["loss"]) <= 1e-5 * abs(run["loss"])
    assert abs(float(metrics["aux"]) - run["aux"]) <= 1e-5 * max(
        abs(run["aux"]), 1.0)
    assert len(grads) == len(run["grads"])
    for i, (g, want) in enumerate(zip(grads, run["grads"])):
        assert g is not None and bool(torch.isfinite(g).all())
        assert g.dtype == want.dtype
        assert _close(g, want.numpy()), (arch, i)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-moe-3b-a800m",
                                  "whisper-medium"])
def test_remat_policies_give_bitwise_equal_gradients(arch):
    """"none", "dots" and "full" differ in what they save, not in what
    they compute: every gradient bit for bit (the MoE FFN's in-place
    dispatch and the encoder's layers included)."""
    run = _run(arch)
    got = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(run["cfg"], remat=remat)
        loss, _, got[remat] = _port_loss_and_grads(cfg, run["params"],
                                                   run["batch"])
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b)
                   for a, b in zip(got["none"], got[remat])), remat


def test_unknown_remat_raises():
    cfg = dataclasses.replace(configs.get("yi-6b").reduced(), remat="some")
    run = _run("yi-6b")
    with pytest.raises(ValueError, match="remat"):
        _port_loss_and_grads(cfg, run["params"], run["batch"])


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One ``make_train_step`` step of granite-moe (the MoE aux term in
    the loss) from the same params and AdamW state: the loss, the global
    gradient norm, the new params and moments."""
    arch = "granite-moe-3b-a800m"
    cfg, pcfg = jax_configs.get(arch).reduced(), configs.get(arch).reduced()
    jm = jax_build(cfg)
    params = jm.init(jax.random.PRNGKey(1))
    state = jax_adamw_init(params)
    ocfg = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    batch = _batch(cfg, b=4, seed=accum)
    micro = {k: v.reshape((accum, 4 // accum) + v.shape[1:])
             for k, v in batch.items()}
    with jax_dispatch.use_backend("ref"):
        step = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**ocfg), accum))
        jp, js, jmet = step(params, state, jax.tree.map(jnp.asarray, micro))
    pparams = model_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    pstate = opt_state_from_reference(
        pcfg, jax.tree.map(np.asarray, state), device="cpu")
    new_p, new_s, met = make_train_step(build(pcfg), AdamWConfig(**ocfg),
                                        accum)(pparams, pstate,
                                               _torch_batch(micro))
    assert abs(float(met["loss"]) - float(jmet["loss"])) \
        <= 1e-5 * abs(float(jmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) \
        <= 1e-4 * float(jmet["grad_norm"])
    assert new_s["step"] == 1

    def ref(tree):
        return leaves(model_params_from_reference(
            pcfg, jax.tree.map(np.asarray, tree), device="cpu"))
    lr = met["lr"]
    for a, b, m in zip(leaves(new_p), ref(jp), ref(js["m"])):
        assert a.dtype == b.dtype
        clear = m.abs() > 10 * RTOL * m.abs().max()
        bound = torch.where(clear, lr * 2e-3, 2 * lr) + 1e-6
        assert bool(((a - b).abs() <= bound).all())
    for key in ("m", "v"):
        for a, b in zip(leaves(new_s[key]), ref(js[key])):
            assert _close(a, b.numpy())


def test_replan_accum_keeps_the_global_batch():
    assert elastic.replan_accum(8, 2) == 4
    assert elastic.replan_accum(8, 2, data_width=2) == 2
    with pytest.raises(ValueError, match="not divisible"):
        elastic.replan_accum(8, 3)


# -- the card's counts, the kernels' plain versions standing in ------------------

@pytest.fixture
def kernels_as_plain(monkeypatch):
    """Route every op as on the card (``backend_for`` gives "cuda") with
    each model kernel's wrapper replaced by its plain version, so the ops
    take their kernel branch -- through ``kernels.grad`` under autograd
    -- and count their launches.  Returns the launch counter."""
    from repro_torch.kernels.affine import affine as affine_k
    from repro_torch.kernels.affine import ref as affine_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms_k
    from repro_torch.kernels.rope import ref as rope_ref
    from repro_torch.kernels.rope import rope as rope_k
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd import ssd as ssd_k
    launches = {}

    def counted(name, fn):
        def run(*a, **kw):
            _build.check_no_grad(*[x for x in a
                                   if isinstance(x, torch.Tensor)])
            launches[name] = launches.get(name, 0) + 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(dispatch, "backend_for",
                        lambda device, backend=None:
                        backend or dispatch._BACKEND or "cuda")
    monkeypatch.setattr(affine_k, "vecadd_2d",
                        counted("vecadd_2d", affine_ref.vecadd))
    monkeypatch.setattr(rms_k, "rmsnorm_2d", counted(
        "rmsnorm_2d", lambda x, g, eps, row_warps: rms_ref.rmsnorm(x, g,
                                                                   eps)))
    monkeypatch.setattr(rope_k, "rope_3d", counted("rope_3d", rope_ref.rope))
    monkeypatch.setattr(fa_k, "flash_attention_3d", counted(
        "flash_attention_3d", fa_ref.flash_attention))
    monkeypatch.setattr(ssd_k, "ssd_intra", counted("ssd_intra",
                                                    ssd_ref.ssd_intra))
    return launches


def expected_train_launches(cfg, accum: int) -> tuple[dict, dict]:
    """(launches, plain backwards) of one train step of a hybrid model of
    L layers under remat "dots" over ``accum`` micro-batches: a forward
    pass launches rmsnorm_2d 5L+1 times, rope_3d 2L, flash_attention_3d
    and ssd_intra L, vecadd_2d 2L; the backward recomputes every layer
    (not the final norm), so the launches are twice the layers' plus
    one, and each forward launch of the kept graph runs one plain
    backward."""
    L = cfg.n_layers
    fwd = {"rmsnorm_2d": 5 * L + 1, "rope_3d": 2 * L,
           "flash_attention_3d": L, "ssd_intra": L, "vecadd_2d": 2 * L}
    launches = {k: accum * (2 * v - (k == "rmsnorm_2d")) for k, v in fwd.items()}
    return launches, {k: accum * v for k, v in fwd.items()}


@pytest.mark.parametrize("remat", ["dots", "full", "none"])
def test_card_counts_with_plain_versions_for_kernels(kernels_as_plain, remat):
    """hymba's train step as the card runs it, 2 micro-batches: the
    launches and plain backwards of ``expected_train_launches`` ("none"
    recomputes nothing: one forward's launches), every parameter's
    gradient finite and within the tolerance of the plain path's."""
    run = _run("hymba-1.5b")
    cfg = dataclasses.replace(run["cfg"], remat=remat)
    micro = {k: v.reshape((2, 1) + v.shape[1:])
             for k, v in run["batch"].items()}
    state = adamw_init(run["params"])
    step = make_train_step(build(cfg), AdamWConfig(), 2)
    grad.reset_backward_counts()
    _, _, met = step(run["params"], state, _torch_batch(micro))
    want, want_bwd = expected_train_launches(cfg, 2)
    if remat == "none":
        want = want_bwd
    assert kernels_as_plain == want
    assert grad.backward_counts() == want_bwd
    assert bool(torch.isfinite(met["loss"]))


def test_kernel_path_gradients_match_plain_path(kernels_as_plain):
    """The Functions' gradients (kernel forward, plain vjp) against the
    plain path's on hymba, which serves its forward through the kernels'
    plain versions: within the tolerance."""
    run = _run("hymba-1.5b")
    loss, _, grads = _port_loss_and_grads(run["cfg"], run["params"],
                                          run["batch"])
    assert kernels_as_plain["ssd_intra"] == 2 * run["cfg"].n_layers
    with dispatch.use_backend("ref"):
        ref_loss, _, ref_grads = _port_loss_and_grads(
            run["cfg"], run["params"], run["batch"])
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for g, want in zip(grads, ref_grads):
        assert _close(g, want.numpy())


# -- the JAX package's training tests, on the port --------------------------------

def test_train_loss_decreases():
    """20 steps on a reduced mamba2 must show a real loss drop."""
    cfg = configs.get("mamba2-130m").reduced()
    _, history = train_loop(cfg, steps=20, global_batch=8, seq_len=64,
                            log_every=100, device="cpu")
    first, last = np.mean(history[:3]), np.mean(history[-3:])
    assert last < first - 0.2, (first, last)


def test_train_loss_decreases_dense_moe():
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    _, history = train_loop(cfg, steps=15, global_batch=8, seq_len=64,
                            log_every=100, device="cpu")
    assert np.mean(history[-3:]) < np.mean(history[:3]) - 0.1


def test_train_cli_on_the_cpu(capsys, tmp_path):
    train_cli.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                    "--steps", "2", "--global-batch", "4", "--seq-len", "32",
                    "--micro-per-shard", "2", "--ckpt-dir", str(tmp_path),
                    "--ckpt-interval", "1"])
    out = capsys.readouterr().out
    assert "[train] step     1 loss" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000001", "step_000000002"]

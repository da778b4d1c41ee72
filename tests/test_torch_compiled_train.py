"""The compiled train step's parts on the CPU: ``launch.train.CompiledTrain``
run op by op over its static buffers (what the card captures as one CUDA
graph and replays), the in-place AdamW, the capture accounting of the
plain backwards, and the compiled serve's shape key.

  * (a) ``CompiledTrain``'s step, run eagerly (no capture) for 3 steps
    with 1 and 2 micro-batches, gives the losses, gradient norms,
    parameters and ``m``/``v``/``master`` of ``make_train_step``'s
    functional steps bit for bit, for the reduced hymba (hybrid),
    granite-moe (MoE) and whisper (enc-dec).
  * (b) The same 3 steps of the reduced hymba against the JAX package's
    ``jax.jit(make_train_step(...), donate_argnums=(0, 1))`` under
    ``use_backend("ref")``, the weights and state carried across by
    ``convert``: after step 1 the moments within 1e-4 of their largest
    magnitude and the parameters within ``lr * 2e-3`` where the
    reference's gradient stands clear of zero (``test_torch_train.py``'s
    rule: Adam's first update is g / (|g| + eps)); the three losses
    within 1e-4 relative.
  * (c) Replay invariance: under a ``TorchDispatchMode`` steps 1 and 2
    (the warmup makes their learning rates differ) run the same op list
    -- names, non-tensor arguments, tensor shapes and dtypes -- with no
    host read (``aten._local_scalar_dense``) and no tensor made from
    Python data (``aten.lift_fresh``); the ops are routed as on the card
    with the kernels' plain versions standing in (``kernels_as_plain``),
    so the plain vjps of ``kernels.grad`` are in the list.  A learning
    rate passed as a Python float shows in the list.
  * (d) The parameters' and the optimizer state's tensors keep their
    ``data_ptr`` across steps (the reference's donation).
  * (e) The compiled serve keeps one ``CompiledServe`` a shape key:
    another parameter set of the same shapes releases it, the same
    tensors updated in place keep it.

Plus ``grad.record``: a captured span's plain backwards are not counted
until its replay adds them, and ``train_loop`` on the CPU runs the
functional step with or without ``eager``.  The on-card half (the graph
against ``eager=True``, counts at replay, the serve after training) is
in ``test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from test_torch_compiled_serve import _OpLog  # noqa: E402
from test_torch_train import expected_train_launches  # noqa: E402
from test_torch_train import kernels_as_plain  # noqa: E402,F401

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.distributed.steps import make_train_step  # noqa: E402
from repro_torch.kernels import grad  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import CompiledTrain, train_loop  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import leaves, tree_map  # noqa: E402

STEPS, BATCH, SEQ = 3, 2, 32
#: warmup over two steps: every step's learning rate differs
OPT = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=STEPS)


def _batches(cfg, accum: int, seed: int = 0) -> list:
    """``SyntheticLMData``'s first STEPS global batches as host tensors
    (accum, micro, ...)."""
    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=seed, frontend=cfg.frontend,
        n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model))
    return [{k: torch.from_numpy(v.reshape((accum, BATCH // accum)
                                           + v.shape[1:]))
             for k, v in data.global_batch(i).items()} for i in range(STEPS)]


def _compiled(cfg, params, accum: int) -> CompiledTrain:
    copy = tree_map(lambda p: p.clone(), params)
    return CompiledTrain(build(cfg), OPT, accum, copy, adamw_init(copy))


def _step(ct: CompiledTrain, batch: dict) -> dict:
    """One step over the static buffers, as ``train_loop``'s first."""
    lr = ct.load(batch)
    return {"lr": lr, **ct.run()}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-moe-3b-a800m",
                                  "whisper-medium"])
def test_in_place_step_is_bitwise_the_functional_step(arch, accum):
    cfg = configs.get(arch).reduced()
    params = build(cfg).init(torch.Generator().manual_seed(0))
    batches = _batches(cfg, accum)
    ct = _compiled(cfg, params, accum)
    state = adamw_init(params)
    step = make_train_step(build(cfg), OPT, accum)
    for batch in batches:
        params, state, want = step(params, state, batch)
        got = _step(ct, batch)
        assert got["lr"] == want["lr"]
        for key in ("loss", "grad_norm"):
            assert torch.equal(got[key], want[key]), key
        assert ct.opt_state["step"] == state["step"]
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(ct.params), leaves(params)))
        for key in ("m", "v", "master"):
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(ct.opt_state[key]), leaves(state[key])))


def test_hybrid_steps_match_the_jax_jitted_donated_step():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jax_configs
    from repro.distributed.steps import make_train_step as jax_step
    from repro.kernels import dispatch as jax_dispatch
    from repro.models import build as jax_build
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.optim import adamw_init as jax_adamw_init
    from repro_torch.convert import (model_params_from_reference,
                                     opt_state_from_reference)
    arch, accum = "hymba-1.5b", 2
    jcfg, cfg = jax_configs.get(arch).reduced(), configs.get(arch).reduced()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    js = jax_adamw_init(jp)
    params = model_params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")
    ct = CompiledTrain(build(cfg), OPT, accum, params,
                       opt_state_from_reference(
                           cfg, jax.tree.map(np.asarray, js), device="cpu"))

    def port(tree):
        return leaves(model_params_from_reference(
            cfg, jax.tree.map(np.asarray, tree), device="cpu"))
    jcfg_opt = JaxAdamWConfig(**dataclasses.asdict(OPT))
    with jax_dispatch.use_backend("ref"):
        jitted = jax.jit(jax_step(jm, jcfg_opt, accum),
                         donate_argnums=(0, 1))
        for i, batch in enumerate(_batches(cfg, accum)):
            got = _step(ct, batch)
            jp, js, jmet = jitted(jp, js, {k: jnp.asarray(v.numpy())
                                           for k, v in batch.items()})
            want = float(jmet["loss"])
            assert abs(float(got["loss"]) - want) <= 1e-4 * abs(want), i
            if i:
                continue
            lr = got["lr"]
            for a, b, m in zip(leaves(ct.params), port(jp), port(js["m"])):
                clear = m.abs() > 10 * 1e-4 * m.abs().max()
                bound = torch.where(clear, lr * 2e-3, 2 * lr) + 1e-6
                assert a.dtype == b.dtype and bool(
                    ((a - b).abs() <= bound).all())
            for key in ("m", "v"):
                for a, b in zip(leaves(ct.opt_state[key]), port(js[key])):
                    tol = 1e-4 * max(float(b.abs().max()), 1e-30)
                    assert float((a - b).abs().max()) <= tol, key


def test_step_ops_are_the_same_at_every_step(kernels_as_plain):
    cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(),
                              remat="dots")
    params = build(cfg).init(torch.Generator().manual_seed(1))
    batches = _batches(cfg, 2)
    ct = _compiled(cfg, params, 2)
    logs, lrs = [], []
    for batch in batches[:2]:
        lrs.append(ct.load(batch))
        with _OpLog() as log:
            ct.run()
        logs.append(log.ops)
    assert lrs[0] != lrs[1]
    assert logs[0] == logs[1]
    names = {op for op, _, _ in logs[0]}
    assert not any("_local_scalar_dense" in n or "lift_fresh" in n
                   for n in names), names
    assert kernels_as_plain["ssd_intra"] > 0    # the card's routing ran
    m = torch.ones(3)
    planted = []
    for lr in lrs:     # a Python float learning rate would be baked in
        with _OpLog() as log:
            m.sub(m * lr)
        planted.append(log.ops)
    assert planted[0] != planted[1]


def test_step_updates_the_donated_tensors_in_place():
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    params = build(cfg).init(torch.Generator().manual_seed(2))
    batches = _batches(cfg, 2)
    ct = _compiled(cfg, params, 2)

    def ptrs():
        return [t.data_ptr() for t in leaves(ct.params)] + [
            t.data_ptr() for k in ("m", "v", "master")
            for t in leaves(ct.opt_state[k])]
    before = ptrs()
    first = [t.clone() for t in leaves(ct.params)]
    for batch in batches:
        _step(ct, batch)
        assert ptrs() == before
    assert not all(torch.equal(a, b) for a, b in
                   zip(first, leaves(ct.params)))


def test_plain_backwards_of_a_capture_count_at_replay(kernels_as_plain):
    cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(),
                              remat="dots")
    params = build(cfg).init(torch.Generator().manual_seed(3))
    batches = _batches(cfg, 2)
    ct = _compiled(cfg, params, 2)
    ct.load(batches[0])
    grad.reset_backward_counts()
    with grad.record() as rec:
        ct.run()
    _, want = expected_train_launches(cfg, 2)
    assert grad.backward_counts() == {}
    assert dict(rec.backwards) == want
    for n in (1, 2):
        rec.replay()
        assert grad.backward_counts() == {k: n * v for k, v in want.items()}


def test_serve_keeps_one_compiled_step_a_shape_key():
    cfg = configs.get("hymba-1.5b").reduced()
    model = build(cfg)
    dev = torch.device("cpu")
    a = model.init(torch.Generator().manual_seed(4))
    b = model.init(torch.Generator().manual_seed(5))
    first = serve.compiled_serve(model, a, 2, 8, 12, dev)
    assert serve.compiled_serve(model, a, 2, 8, 12, dev) is first
    other = serve.compiled_serve(model, b, 2, 8, 12, dev)
    assert other is not first and other.holds(b)
    assert list(model.serve_graphs.values()) == [other]
    tree_map(lambda p: p.mul_(0.5), b)      # an in-place update keeps it
    assert serve.compiled_serve(model, b, 2, 8, 12, dev) is other
    serve.compiled_serve(model, b, 2, 8, 13, dev)   # another shape key
    assert len(model.serve_graphs) == 2


def test_train_loop_on_the_cpu_runs_the_functional_step():
    cfg = configs.get("mamba2-130m").reduced()
    runs = []
    for eager in (False, True):
        trace = {}
        params, history = train_loop(cfg, steps=2, global_batch=4,
                                     seq_len=16, micro_per_shard=2,
                                     device="cpu", log_every=100,
                                     eager=eager, trace=trace)
        assert trace == {"step": "eager", "capture_ms": None,
                         "replay_us": []}
        runs.append((params, history))
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(runs[0][0]), leaves(runs[1][0])))

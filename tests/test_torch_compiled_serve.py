"""The compiled serve step's parts on the CPU: ``Model.decode`` with its
position as a 0-d tensor (the JAX launcher's traced ``pos``, what the
port's CUDA graph replays), the caches written in place, the launch
accounting of a capture, and the static-buffer steps of
``launch.serve.CompiledServe``.

  * (a) For a dense model with a ring that wraps past its window
    (h2o-danube), an MoE (granite), an SSM (mamba2-130m), a hybrid
    (hymba), an enc-dec (whisper: sinusoidal positions), a VLM
    (internvl2) and an int8 linear cache (yi-6b), each reduced:
    ``Model.decode`` at a tensor ``pos`` gives logits and caches bit for
    bit equal to the same steps at an int ``pos``.
  * (b) The reduced hymba's tensor-``pos`` decode against the JAX
    package's ``jax.jit(model.decode)`` (``pos`` traced there), its
    weights carried across by ``convert.model_params_from_reference``,
    within |port - JAX| <= 1e-4 max|JAX| per tensor, the tolerance of
    ``test_torch_models.py``; the JAX model runs through its plain
    reference (``use_backend("ref")``).
  * (c) Replay invariance: under a ``TorchDispatchMode`` the decode
    step's ops at two positions are the same list (op names, non-tensor
    arguments, tensor shapes and dtypes), with no host read
    (``aten._local_scalar_dense``) and no tensor made from Python data
    (``aten.lift_fresh``); the recorder sees both when they are planted.
  * (d) ``ssm.decode_step`` and ``Model.prefill``/``decode`` write into
    the cache tensors they were given (``data_ptr`` unchanged).
  * (e) ``_build.record``: a captured span (stub kernels) adds nothing
    to the counts, and each replay adds it back.
  * (f) ``serve_batch(..., eager=True)`` on the CPU gives the default's
    tokens, and (g) ``CompiledServe``'s prefill and decode steps, run
    twice over one set of static buffers, give the eager serve's tokens
    and logits bit for bit.

The on-card half (graphs against the eager step, launches, a second
serve without a capture) is in ``test_torch_cuda.py``.
"""
import copy
import dataclasses

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build, ssm  # noqa: E402

BATCH, PROMPT, STEPS = 2, 40, 3
#: (arch, KV cache dtype): every family; danube's and hymba's window-32
#: ring wraps (a 40-token prompt); yi-6b's int8 cache is linear
CASES = [("h2o-danube-1.8b", "bfloat16"), ("granite-moe-3b-a800m", "bfloat16"),
         ("mamba2-130m", "bfloat16"), ("hymba-1.5b", "bfloat16"),
         ("whisper-medium", "bfloat16"), ("internvl2-76b", "bfloat16"),
         ("yi-6b", "int8")]


def _cfg(arch: str, kv: str = "bfloat16"):
    return dataclasses.replace(configs.get(arch).reduced(),
                               kv_cache_dtype=kv)


def _setup(arch: str, kv: str = "bfloat16", seed: int = 0):
    """(model, params, prompts, the prefilled cache, the serve's batch,
    its first decode position, the prefill's logits)."""
    cfg = _cfg(arch, kv)
    model = build(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(seed))
    prompts = np.random.default_rng([30, seed]).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    batch, pos, enc_len = serve.serve_inputs(
        cfg, torch.from_numpy(prompts).long())
    cache = model.init_cache(BATCH, PROMPT + STEPS + 1, enc_len, device="cpu")
    logits, cache = model.prefill(params, batch, cache)
    return model, params, prompts, cache, batch, pos, logits


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("arch, kv", CASES)
def test_tensor_pos_decode_is_bitwise_the_int_pos_decode(arch, kv):
    model, params, _, cache, _, pos, logits = _setup(arch, kv)
    twin = copy.deepcopy(cache)
    tok = torch.argmax(logits, -1)
    for i in range(STEPS):
        a, cache = model.decode(params, tok, pos + i, cache)
        b, twin = model.decode(params, tok, torch.tensor(pos + i), twin)
        assert torch.equal(a, b), (arch, i)
        for (name, x), (_, y) in zip(_leaves(cache), _leaves(twin)):
            assert x.dtype == y.dtype and torch.equal(x, y), (arch, i, name)
        tok = torch.argmax(a, -1)
    if model.cfg.window:     # every decode write landed past the window
        kpos = [x for name, x in _leaves(cache) if name.endswith("kpos")][0]
        assert kpos.shape == (model.cfg.window,) and pos > model.cfg.window
        assert int(kpos.max()) == pos + STEPS - 1


def _stacked(params: dict) -> dict:
    """Port parameters as the JAX package's pytree of numpy arrays: the
    per-layer list stacked on a leading axis."""
    def tree(v):
        return {k: tree(x) for k, x in v.items()} if isinstance(v, dict) \
            else v.numpy()

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lp[k] for lp in layers]) for k in layers[0]}
        return np.stack([t.numpy() for t in layers])
    return {k: stack(v) if isinstance(v, list) else tree(v)
            for k, v in params.items()}


def test_hybrid_tensor_pos_decode_matches_jax_jit_decode():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jax_configs
    from repro.kernels import dispatch as jax_dispatch
    from repro.models import build as jax_build
    from repro_torch.convert import model_params_from_reference
    jcfg = jax_configs.get("hymba-1.5b").reduced()
    cfg = configs.get("hymba-1.5b").reduced()
    jm, pm = jax_build(jcfg), build(cfg)
    # the port's seeded draw, stacked into the reference's layout (a
    # leading layer axis) and carried back across
    jparams = _stacked(pm.init(torch.Generator(device="cpu").manual_seed(0)))
    params = model_params_from_reference(cfg, jparams, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)
    prompts = np.random.default_rng(31).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    max_len = PROMPT + STEPS
    with jax_dispatch.use_backend("ref"):
        decode = jax.jit(jm.decode)       # pos traced: one program
        jl, jc = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(
            prompts)}, jm.init_cache(BATCH, max_len))
        steps = []
        for i in range(STEPS):
            tok = jnp.argmax(jl, -1).astype(jnp.int32)
            jl, jc = decode(jparams, tok, jnp.int32(PROMPT + i), jc)
            steps.append((np.asarray(tok), np.asarray(jl),
                          jax.tree.map(np.asarray, jc)))
    _, cache = pm.prefill(params, {"tokens": torch.from_numpy(prompts).long()},
                          pm.init_cache(BATCH, max_len, device="cpu"))
    pos = torch.tensor(PROMPT)
    for i, (tok, want, want_cache) in enumerate(steps):
        got, cache = pm.decode(params, torch.tensor(tok).long(), pos + i,
                               cache)
        for name, x, w in [("logits", got, want)] + [
                (f"{layer}/{branch}/{k}", cache[layer][branch][k],
                 want_cache[branch][k][layer])
                for layer in range(cfg.n_layers)
                for branch in ("attn", "ssm") for k in cache[layer][branch]]:
            w = np.asarray(w, dtype=np.float64)
            assert x.shape == w.shape, name
            tol = 1e-4 * max(np.abs(w).max(), 1e-30)
            assert np.abs(x.double().numpy() - w).max() <= tol, (i, name)


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _describe(v)) for k, v in sorted(x.items()))
    return repr(x)


class _OpLog(TorchDispatchMode):
    """Every aten op run inside: its name, non-tensor arguments, and its
    tensor arguments' shapes and dtypes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _describe(args), _describe(kwargs)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch, kv", [("hymba-1.5b", "bfloat16"),
                                      ("whisper-medium", "bfloat16"),
                                      ("granite-moe-3b-a800m", "bfloat16"),
                                      ("yi-6b", "int8")])
def test_decode_step_ops_are_the_same_at_every_position(arch, kv):
    model, params, _, cache, _, pos, logits = _setup(arch, kv)
    tok = torch.argmax(logits, -1)
    logs = []
    for p in (pos, pos + 3):
        p = torch.tensor(p)
        with _OpLog() as log:
            model.decode(params, tok, p, cache)
        logs.append(log.ops)
    assert logs[0] == logs[1]
    names = {op for op, _, _ in logs[0]}
    assert not any("_local_scalar_dense" in n or "lift_fresh" in n
                   for n in names), names
    with _OpLog() as planted:     # the recorder sees a host read and a
        torch.tensor([int(torch.tensor(pos) + 1)])   # tensor of Python data
    seen = " ".join(op for op, _, _ in planted.ops)
    assert "_local_scalar_dense" in seen and "lift_fresh" in seen


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b",
                                  "whisper-medium", "granite-moe-3b-a800m"])
def test_prefill_and_decode_write_the_cache_tensors_in_place(arch):
    cfg = _cfg(arch)
    model = build(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(1))
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (BATCH, 16)))
    batch, pos, enc_len = serve.serve_inputs(cfg, prompts)
    cache = model.init_cache(BATCH, 24, enc_len, device="cpu")
    before = [(name, t, t.data_ptr(), t.clone()) for name, t in _leaves(cache)]
    logits, out = model.prefill(params, batch, cache)
    for (name, t, ptr, _), (_, u) in zip(before, _leaves(out)):
        assert u is t and t.data_ptr() == ptr, name
    # every leaf the prefill fills changed in place (enc-dec: the cross
    # k/v; SSM: state and conv tail; attention: k, v, kpos)
    assert all(not torch.equal(t, old) for name, t, _, old in before), arch
    mid = [t.clone() for _, t in _leaves(cache)]
    _, out = model.decode(params, torch.argmax(logits, -1), torch.tensor(pos),
                          cache)
    for (name, t, ptr, _), (_, u) in zip(before, _leaves(out)):
        assert u is t and t.data_ptr() == ptr, name
    changed = {name for (name, t, _, _), old in zip(before, mid)
               if not torch.equal(t, old)}
    if cfg.family in ("ssm", "hybrid"):
        assert {n for n in changed if "state" in n or "conv" in n}
    layer = cache[0]["ssm"] if cfg.family == "hybrid" else cache[0]
    if cfg.family in ("ssm", "hybrid"):
        x = torch.randn(BATCH, 1, cfg.d_model)
        ptrs = {k: v.data_ptr() for k, v in layer.items()}
        lp = params["layers"][0]["ssm"]
        _, got = ssm.decode_step(lp, x, cfg, layer)
        assert got is layer
        assert {k: v.data_ptr() for k, v in got.items()} == ptrs


def test_capture_accounting_takes_a_recorded_span_out_and_replays_it(
        monkeypatch):
    monkeypatch.setattr(_build, "KERNELS", {})
    calls = []

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())

    class _Null:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    ka = _build.CudaKernel("stub", "stub_a", n_ptrs=1, n_sizes=2)
    kb = _build.CudaKernel("stub", "stub_b", n_ptrs=0, n_sizes=1)
    for k in (ka, kb):
        k._fn = lambda *args: calls.append(args) or 0
    dev = torch.device("cpu")
    ka(dev, 10, 3, 4)
    assert _build.launch_counts() == {"stub_a": 1, "stub_b": 0}
    with _build.record(counted=False) as rec:
        ka(dev, 11, 3, 4)
        ka(dev, 12, 5, 6)
        kb(dev, 7)
    assert len(calls) == 4     # a capture calls the C entry (it records)
    assert _build.launch_counts() == {"stub_a": 1, "stub_b": 0}
    assert _build.launch_sizes() == {"stub_a": {(3, 4)}, "stub_b": set()}
    assert rec.launches == {"stub_a": 2, "stub_b": 1}
    assert rec.sizes == {"stub_a": {(3, 4), (5, 6)}, "stub_b": {(7,)}}
    for n in (1, 2, 3):
        rec.replay()
        assert _build.launch_counts() == {"stub_a": 1 + 2 * n, "stub_b": n}
    assert _build.launch_sizes() == {"stub_a": {(3, 4), (5, 6)},
                                     "stub_b": {(7,)}}
    with _build.record() as counted:    # an eager span counts and notes
        kb(dev, 8)
    assert counted.launches == {"stub_b": 1}
    assert _build.launch_counts()["stub_b"] == 4
    _build.reset_launch_counts()
    assert _build.launch_counts() == {"stub_a": 0, "stub_b": 0}


def test_serve_batch_eager_on_the_cpu_gives_the_default_tokens():
    cfg = _cfg("hymba-1.5b")
    model = build(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(2))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 36))
    runs = []
    for eager in (False, True):
        trace = {}
        runs.append((serve.serve_batch(cfg, params, prompts, gen_tokens=3,
                                       model=model, trace=trace, eager=eager),
                     trace))
    (a, ta), (b, tb) = runs
    assert np.array_equal(a, b) and a.shape == (2, 3)
    assert ta["step"] == tb["step"] == "eager"
    assert all(torch.equal(x, y) for x, y in zip(ta["logits"], tb["logits"]))
    assert len(ta["decode_sizes"]) == 3 and not model.serve_graphs
    with pytest.raises(ValueError, match="gen_tokens"):
        serve.serve_batch(cfg, params, prompts, gen_tokens=0, model=model)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-medium"])
def test_compiled_steps_over_static_buffers_equal_the_eager_serve(arch):
    cfg = _cfg(arch)
    model = build(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(4))
    rng = np.random.default_rng(6)
    gen = 3
    cs = serve.CompiledServe(model, params, BATCH, PROMPT, PROMPT + gen,
                             torch.device("cpu"))
    assert cs.stream is None and cs.pos.dim() == 0
    for _ in range(2):     # two serves: the cache is reset in place
        prompts = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))
        trace = {}
        want = serve.serve_batch(cfg, params, prompts, gen_tokens=gen,
                                 model=model, trace=trace)
        cs.prompts.copy_(torch.from_numpy(prompts))
        logits = [cs.prefill(model)]
        toks = []
        for _ in range(gen):
            toks.append(cs.tok.clone())
            logits.append(cs.decode(model))
        assert int(cs.pos) == cs.pos0 + gen
        assert np.array_equal(torch.stack(toks, 1).numpy(), want)
        assert all(torch.equal(a, b) for a, b in zip(logits, trace["logits"]))
    key = serve.compiled_key(cfg, BATCH, PROMPT, PROMPT + gen)
    assert key == serve.compiled_key(cfg, BATCH, PROMPT, PROMPT + gen)
    assert key != serve.compiled_key(cfg, BATCH, PROMPT, PROMPT + gen + 1)
    assert cs.holds(params) and not cs.holds(dict(params, embed=params[
        "embed"].clone()))

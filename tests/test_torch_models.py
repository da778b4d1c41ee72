"""The port's serving path against the JAX package's: the reduced
``hymba-1.5b`` (hybrid), ``h2o-danube-1.8b`` (dense, sliding window),
``mamba2-130m`` (SSM), ``granite-moe-3b-a800m`` and ``dbrx-132b`` (MoE:
4 experts, top 2, at ``reduced()``), ``whisper-medium`` (enc-dec: two
encoder and two decoder layers, sinusoidal positions, zero frames) and
``internvl2-76b`` (VLM: an 8-position zero patch prefix) configs, and
the int8 KV cache on the reduced ``granite-moe-3b-a800m`` and ``yi-6b``
(the JAX package's own int8 case), with the JAX parameters carried
across by ``convert.model_params_from_reference``.

The JAX model runs under ``dispatch.use_backend("interpret")`` (its
Pallas kernel bodies), the port on CPU tensors (its plain versions).  A
48-token prompt goes into a 64-slot cache (16 tokens generated), so the
window-32 ring of hymba and danube wraps.  Both packages get the batch,
the first decode position and the encoder length of the port's
``launch.serve.serve_inputs`` (the JAX launcher's stubs).  Held equal:

  * prefill logits and every layer's cache (kpos and the int8 words
    exactly; k, v, their int8 scales, the enc-dec cross keys and values,
    the SSM state and the conv tail), then each of the 16 decode steps'
    logits and caches, the JAX package's greedy tokens fed to both;
  * the tokens of ``serve_batch``, exactly;
  * every shipped config builds; an int8 cache that would be written as
    a ring (window <= max_len) raises ``Int8RingCacheError`` in the port
    where the JAX package's first decode raises ``KeyError`` (ROADMAP.md
    queue 3 item 4), and one shorter than the window matches it.

Tolerance: |port - JAX| <= 1e-4 max|JAX| per tensor.  The reduced
configs are float32 end to end; every op agrees to a few float32 ulp
(~1e-6 relative): the port sums in other orders (the matmuls, ``cumsum``,
the sequential inter-chunk scan against ``associative_scan``, the
softmax over all keys against the online one) and its ``pow``/``cos``/
``exp`` may differ by an ulp; 1e-4 leaves room for that to compound
over two layers and 16 steps.  The MoE archs' routing must pick the same
experts and slots in both packages: an ulp cannot flip a top-k choice
unless two router probabilities tie to within it, which these seeds do
not reach (``tests/test_torch_moe.py`` asserts that margin per token).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.kernels import dispatch as jax_dispatch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import build as jax_build
from repro_torch import configs
from repro_torch.convert import model_params_from_reference
from repro_torch.errors import Int8RingCacheError
from repro_torch.launch.serve import serve_batch, serve_inputs
from repro_torch.models import attention as attn
from repro_torch.models import build

ARCHS = ["hymba-1.5b", "h2o-danube-1.8b", "mamba2-130m",
         "granite-moe-3b-a800m", "dbrx-132b", "whisper-medium",
         "internvl2-76b"]
#: the archs whose reduced config is also run with an int8 KV cache
INT8_ARCHS = ["granite-moe-3b-a800m", "yi-6b"]
BATCH, PROMPT, GEN = 2, 48, 16
RTOL = 1e-4
_RUNS = {}


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, what
    if want.dtype.kind in "iu":
        assert np.array_equal(got, want), what
        return
    want = want.astype(np.float64)
    tol = RTOL * max(np.abs(want).max(), 1e-30)
    assert np.abs(got.astype(np.float64) - want).max() <= tol, what


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _run(arch: str, kv_cache_dtype: str = "bfloat16") -> dict:
    """Both packages on one arch, run once and shared by the tests."""
    if (arch, kv_cache_dtype) in _RUNS:
        return _RUNS[arch, kv_cache_dtype]
    cfg = dataclasses.replace(jax_configs.get(arch).reduced(),
                              kv_cache_dtype=kv_cache_dtype)
    pcfg = dataclasses.replace(configs.get(arch).reduced(),
                               kv_cache_dtype=kv_cache_dtype)
    assert pcfg.name == cfg.name
    jm = jax_build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    pparams = model_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng([75, len(arch)]).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    run = {"cfg": pcfg, "n_layers": cfg.n_layers}
    batch, pos, enc_len = serve_inputs(pcfg, torch.from_numpy(prompts).long())
    jbatch = {k: jnp.asarray(v.numpy().astype(
        np.int32 if k == "tokens" else np.float32)) for k, v in batch.items()}
    with jax_dispatch.use_backend("interpret"):
        run["jax_tokens"] = np.asarray(jax_serve_batch(
            cfg, params, prompts, gen_tokens=GEN, model=jm))
        prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
        cache = jm.init_cache(BATCH, PROMPT + GEN, enc_len)
        logits, cache = prefill(params, jbatch, cache)
        steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
        for i in range(GEN):
            tok = jnp.asarray(run["jax_tokens"][:, i])
            logits, cache = decode(params, tok, pos + i, cache)
            steps.append((np.asarray(logits),
                          jax.tree.map(np.asarray, cache)))
    run["jax_steps"] = steps

    pm = build(pcfg)
    run["port_tokens"] = serve_batch(pcfg, pparams, prompts, gen_tokens=GEN,
                                     model=pm)
    pcache = pm.init_cache(BATCH, PROMPT + GEN, enc_len, device="cpu")

    def snap(c):   # the port updates caches in place: copy each step's
        return [{k: v.clone().numpy() for k, v in _flat(layer).items()}
                for layer in c]

    logits, pcache = pm.prefill(pparams, batch, pcache)
    psteps = [(logits.numpy(), snap(pcache))]
    for i in range(GEN):
        tok = torch.from_numpy(run["jax_tokens"][:, i]).long()
        logits, pcache = pm.decode(pparams, tok, pos + i, pcache)
        psteps.append((logits.numpy(), snap(pcache)))
    run["port_steps"] = psteps
    _RUNS[arch, kv_cache_dtype] = run
    return run


def _check_step(run: dict, step: int) -> None:
    (jl, jc), (pl, pc) = run["jax_steps"][step], run["port_steps"][step]
    _close(pl, jl, f"logits, step {step}")
    jflat = _flat(jc)
    for i in range(run["n_layers"]):
        assert set(pc[i]) == set(jflat), (step, i)
        for name, arr in pc[i].items():
            _close(arr, jflat[name][i], f"layer {i} {name}, step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch):
    run = _run(arch)
    _check_step(run, 0)
    kpos = [c for k, c in run["port_steps"][0][1][0].items()
            if k.endswith("kpos")]
    if run["cfg"].window:     # the ring kept the prompt's last 32 positions
        assert kpos and sorted(kpos[0].tolist()) == list(range(16, 48))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_logits_and_caches_match_jax(arch):
    run = _run(arch)
    for step in range(1, GEN + 1):
        _check_step(run, step)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_match_jax(arch):
    run = _run(arch)
    assert run["port_tokens"].dtype == np.int32
    assert np.array_equal(run["port_tokens"], run["jax_tokens"])


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_prefill_logits_and_caches_match_jax(arch):
    run = _run(arch, "int8")
    pc = run["port_steps"][0][1][0]
    assert pc["/k"].dtype == np.int8 and pc["/kscale"].dtype == np.float32
    assert pc["/kscale"].shape == pc["/k"].shape[:3] + (1,)
    _check_step(run, 0)


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_decode_steps_logits_and_caches_match_jax(arch):
    run = _run(arch, "int8")
    for step in range(1, GEN + 1):
        _check_step(run, step)


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_serve_batch_tokens_match_jax(arch):
    run = _run(arch, "int8")
    assert np.array_equal(run["port_tokens"], run["jax_tokens"])


def test_int8_ring_cache_raises_typed_error():
    """h2o-danube's window of 32 makes a cache of 64 slots a ring, and one
    of 32 slots is written as one too: the JAX package fills either and
    then fails to decode (its ring write drops the int8 scales); the port
    refuses both at ``cache_spec``, and a ring write to an int8 cache,
    with a typed error that names ROADMAP.md queue 3 item 4."""
    cfg = dataclasses.replace(jax_configs.get("h2o-danube-1.8b").reduced(),
                              kv_cache_dtype="int8")
    jm = jax_build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tokens = jnp.zeros((BATCH, 40), jnp.int32)
    for max_len, prompt in ((64, 40), (32, 24)):
        logits, cache = jm.prefill(params, {"tokens": tokens[:, :prompt]},
                                   jm.init_cache(BATCH, max_len))
        assert "kscale" not in cache
        with pytest.raises(KeyError, match="kscale"):
            jm.decode(params, tokens[:, prompt - 1], prompt, cache)

    pcfg = dataclasses.replace(configs.get("h2o-danube-1.8b").reduced(),
                               kv_cache_dtype="int8")
    for max_len in (64, 32):
        with pytest.raises(Int8RingCacheError,
                           match="queue 3 item 4") as err:
            attn.cache_spec(pcfg, BATCH, max_len)
        assert err.value.code == "int8-ring"
        assert isinstance(err.value, NotImplementedError)
        with pytest.raises(Int8RingCacheError):
            build(pcfg).init_cache(BATCH, max_len, device="cpu")
    ring = attn.init_cache(attn.CacheSpec(BATCH, pcfg.n_kv_heads, 32,
                                          pcfg.head_dim, True, "int8"),
                           torch.device("cpu"))
    kv = torch.ones(BATCH, pcfg.n_kv_heads, 1, pcfg.head_dim)
    with pytest.raises(Int8RingCacheError):
        attn._write_ring(ring, kv, kv, 0, 32)


def test_int8_cache_shorter_than_the_window_matches_jax():
    """With max_len < window the int8 cache of h2o-danube is linear in
    both packages: a 24-token prompt and 6 decode steps into 31 slots
    give the JAX package's logits and caches (int8 words equal)."""
    cfg = dataclasses.replace(jax_configs.get("h2o-danube-1.8b").reduced(),
                              kv_cache_dtype="int8")
    pcfg = dataclasses.replace(configs.get("h2o-danube-1.8b").reduced(),
                               kv_cache_dtype="int8")
    spec = attn.cache_spec(pcfg, BATCH, 31)
    assert not spec.ring and spec.dtype == "int8" and spec.length == 31
    jm, pm = jax_build(cfg), build(pcfg)
    params = jm.init(jax.random.PRNGKey(0))
    pparams = model_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(31).integers(
        0, cfg.vocab_size, (BATCH, 30)).astype(np.int32)
    with jax_dispatch.use_backend("interpret"):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :24])},
                            jm.init_cache(BATCH, 31))
    pl, pc = pm.prefill(pparams, {"tokens": torch.from_numpy(
        tokens[:, :24]).long()}, pm.init_cache(BATCH, 31, device="cpu"))
    for pos in range(24, 31):
        _close(pl.numpy(), np.asarray(jl), f"logits before {pos}")
        jflat = _flat(jax.tree.map(np.asarray, jc))
        for i, layer in enumerate(pc):
            assert "/kscale" in jflat
            for name, arr in _flat(layer).items():
                _close(arr.numpy(), jflat[name][i], f"layer {i} {name}")
        if pos == 30:
            break
        with jax_dispatch.use_backend("interpret"):
            jl, jc = jm.decode(params, jnp.asarray(tokens[:, pos]), pos, jc)
        pl, pc = pm.decode(pparams, torch.from_numpy(tokens[:, pos]).long(),
                           pos, pc)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_shipped_config_builds(arch):
    """Every family serves: ``build`` takes each shipped config, and its
    model holds the JAX package's parameter tree (the reduced config's
    names and shapes; layer stacks as lists)."""
    cfg = configs.get(arch)
    assert build(cfg).cfg is cfg
    rcfg = jax_configs.get(arch).reduced()
    shapes = jax.eval_shape(jax_build(rcfg).init, jax.random.PRNGKey(0))
    ours = build(configs.get(arch).reduced()).init(torch.Generator())
    for key in ("layers", "enc_layers"):
        if key in shapes:
            assert len(ours[key]) == jax.tree.leaves(shapes[key])[0].shape[0]
            shapes[key] = jax.tree.map(lambda a: a.shape[1:], shapes[key])
            ours[key] = ours[key][0]
    want = {k: tuple(v.shape if hasattr(v, "shape") else v)
            for k, v in _flat(shapes).items()}
    assert {k: tuple(v.shape) for k, v in _flat(ours).items()} == want


def test_configs_and_param_counts_match_jax():
    assert configs.list_archs() == jax_configs.list_archs()
    for arch in configs.list_archs():
        ours, theirs = configs.get(arch), jax_configs.get(arch)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "window",
                  "ssm_state", "ssm_chunk", "tie_embeddings", "dtype"):
            assert getattr(ours, f) == getattr(theirs, f), (arch, f)
        assert ours.param_count() == theirs.param_count()
        assert ours.head_dim == theirs.head_dim
        assert ours.reduced().param_count() == theirs.reduced().param_count()
        assert ours.activation_dtype == getattr(torch, theirs.dtype)

"""The port's serving path against the JAX package's: the reduced
``hymba-1.5b`` (hybrid), ``h2o-danube-1.8b`` (dense, sliding window),
``mamba2-130m`` (SSM), ``granite-moe-3b-a800m`` and ``dbrx-132b`` (MoE:
4 experts, top 2, at ``reduced()``) configs, with the JAX parameters
carried across by ``convert.model_params_from_reference``.

The JAX model runs under ``dispatch.use_backend("interpret")`` (its
Pallas kernel bodies), the port on CPU tensors (its plain versions).  A
48-token prompt goes into a 64-slot cache (16 tokens generated), so the
window-32 ring of hymba and danube wraps.  Held equal:

  * prefill logits and every layer's cache (kpos exactly; k, v, the SSM
    state and the conv tail), then each of the 16 decode steps' logits
    and caches, the JAX package's greedy tokens fed to both;
  * the tokens of ``serve_batch``, exactly;
  * ``build`` raising ``NotPortedError`` for the enc-dec and VLM
    families (ROADMAP.md queue 1 items 10.2 and 10.3), and
    ``cache_spec`` for the int8 KV cache (item 10.4).

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
from repro_torch.errors import NotPortedError
from repro_torch.launch.serve import serve_batch
from repro_torch.models import attention as attn
from repro_torch.models import build

ARCHS = ["hymba-1.5b", "h2o-danube-1.8b", "mamba2-130m",
         "granite-moe-3b-a800m", "dbrx-132b"]
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


def _run(arch: str) -> dict:
    """Both packages on one arch, run once and shared by the tests."""
    if arch in _RUNS:
        return _RUNS[arch]
    cfg = jax_configs.get(arch).reduced()
    pcfg = configs.get(arch).reduced()
    assert pcfg.name == cfg.name
    jm = jax_build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    pparams = model_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng([75, len(arch)]).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    run = {"cfg": pcfg, "n_layers": cfg.n_layers}
    with jax_dispatch.use_backend("interpret"):
        run["jax_tokens"] = np.asarray(jax_serve_batch(
            cfg, params, prompts, gen_tokens=GEN, model=jm))
        prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
        cache = jm.init_cache(BATCH, PROMPT + GEN)
        logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)},
                                cache)
        steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
        for i in range(GEN):
            tok = jnp.asarray(run["jax_tokens"][:, i])
            logits, cache = decode(params, tok, PROMPT + i, cache)
            steps.append((np.asarray(logits),
                          jax.tree.map(np.asarray, cache)))
    run["jax_steps"] = steps

    pm = build(pcfg)
    run["port_tokens"] = serve_batch(pcfg, pparams, prompts, gen_tokens=GEN,
                                     model=pm)
    pcache = pm.init_cache(BATCH, PROMPT + GEN, device="cpu")

    def snap(c):   # the port updates caches in place: copy each step's
        return [{k: v.clone().numpy() for k, v in _flat(layer).items()}
                for layer in c]

    logits, pcache = pm.prefill(pparams, {"tokens": torch.from_numpy(
        prompts).long()}, pcache)
    psteps = [(logits.numpy(), snap(pcache))]
    for i in range(GEN):
        tok = torch.from_numpy(run["jax_tokens"][:, i]).long()
        logits, pcache = pm.decode(pparams, tok, PROMPT + i, pcache)
        psteps.append((logits.numpy(), snap(pcache)))
    run["port_steps"] = psteps
    _RUNS[arch] = run
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


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_build_raises_not_ported_for_other_families(arch):
    cfg = configs.get(arch)
    with pytest.raises(NotPortedError, match="queue 1 item 10") as err:
        build(cfg)
    assert cfg.family in str(err.value) and err.value.code == "not-ported"
    assert isinstance(err.value, NotImplementedError)


@pytest.mark.parametrize("field, value, item", [
    ("pos_embed", "sinusoidal", "queue 1 item 10.2"),
    ("frontend", "vision", "queue 1 item 10.3")])
def test_build_raises_not_ported_for_unported_fields(field, value, item):
    """A served family with a field the JAX model branches on and the
    port does not run yet (sinusoidal positions, a frontend) would build
    another model than the reference's: ``build`` refuses it, naming the
    sub-item that ports the field; the ten shipped configs build (the
    MoE ones too), or raise for their family."""
    import dataclasses
    cfg = dataclasses.replace(configs.get("h2o-danube-1.8b").reduced(),
                              **{field: value})
    with pytest.raises(NotPortedError, match=item) as err:
        build(cfg)
    assert field.split("_")[-1] in str(err.value)
    for arch in configs.list_archs():
        shipped = configs.get(arch)
        if shipped.family in ("dense", "moe", "ssm", "hybrid"):
            assert build(shipped).cfg is shipped
        else:
            with pytest.raises(NotPortedError,
                               match=f"the {shipped.family} family"):
                build(shipped)


def test_int8_kv_cache_raises_not_ported():
    import dataclasses
    cfg = dataclasses.replace(configs.get("yi-6b").reduced(),
                              kv_cache_dtype="int8")
    with pytest.raises(NotPortedError, match="int8"):
        attn.cache_spec(cfg, 2, 64)


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

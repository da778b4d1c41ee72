"""The enc-dec and VLM pieces of the port's model stack against the JAX
package, module by module, on the CPU: ``layers.sinusoidal_positions``,
``attention.attend`` (causal and not), ``attention.encode_kv`` with
``cross_attend`` (one query and several against a longer encoder),
``blocks.apply`` (the whisper encoder's and decoder's attention blocks,
a decoder layer with its cross-attention, and the SSM and hybrid
mixers) and ``Model._encode`` (the encoder),
``launch.serve.serve_inputs`` (the JAX launcher's stubs) and
``convert.model_params_from_reference`` unstacking ``enc_layers``.

The JAX side runs under ``dispatch.use_backend("interpret")`` (its
Pallas kernel bodies), the port on CPU tensors (its plain versions), on
reduced float32 configs with the JAX parameters carried across.
Tolerance: |port - JAX| <= 1e-4 max|JAX| per tensor, as in
``test_torch_models.py``; the sinusoids within 4 eps32 (|angle| + 1),
since torch's and XLA's float32 ``exp`` may differ by an ulp, which an
angle of up to 1500 rad carries into sin/cos (the rope tables' bound in
``test_torch_model_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.kernels import dispatch as jax_dispatch
from repro.models import attention as jax_attn
from repro.models import blocks as jax_blocks
from repro.models import build as jax_build
from repro.models.layers import sinusoidal_positions as jax_sinusoids
from repro_torch import configs
from repro_torch.convert import model_params_from_reference
from repro_torch.launch.serve import serve_inputs
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import build
from repro_torch.models.layers import sinusoidal_positions

RTOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


def _close(got: torch.Tensor, want, what: str = "") -> None:
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, what
    tol = RTOL * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol, what


def _torch_tree(tree):
    """A float32 JAX parameter dict as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(shape, seed: int):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _cfgs(arch: str):
    cfg, pcfg = jax_configs.get(arch).reduced(), configs.get(arch).reduced()
    assert cfg.name == pcfg.name
    return cfg, pcfg


@pytest.mark.parametrize("d", [2, 64, 1024])
def test_sinusoidal_positions_match_jax(d):
    pos = np.concatenate([np.arange(64), [511, 1024, 1499]]).astype(np.int32)
    want = np.asarray(jax_sinusoids(jnp.asarray(pos), d), np.float64)
    got = sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (len(pos), d)
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = np.abs(pos[:, None] * freq[None, :])
    tol = 4 * EPS32 * (np.concatenate([ang, ang], axis=-1) + 1)
    assert (np.abs(got.double().numpy() - want) <= tol).all()
    # position 0: sin 0 then cos 1, exactly
    assert torch.equal(got[0], torch.cat([torch.zeros(half),
                                          torch.ones(half)]))


@pytest.mark.parametrize("arch, causal", [("whisper-medium", False),
                                          ("whisper-medium", True),
                                          ("h2o-danube-1.8b", True)])
def test_attend_matches_jax(arch, causal):
    """Full-sequence attention without a cache: whisper's (no RoPE, GQA
    group 2) both ways, and danube's (RoPE, a window of 32) causal."""
    cfg, pcfg = _cfgs(arch)
    params = jax_attn.init(jax.random.PRNGKey(3), cfg, jnp.float32)
    jx, tx = _x((2, 40, cfg.d_model), 4)
    with jax_dispatch.use_backend("interpret"):
        want = jax_attn.attend(params, jx, cfg, causal=causal)
    got = attn.attend(_torch_tree(params), tx, pcfg, causal=causal)
    _close(got, want, f"{arch} causal={causal}")


@pytest.mark.parametrize("s", [1, 7])
def test_encode_kv_and_cross_attend_match_jax(s):
    """The decoder's queries (one, as in whisper's prefill and decode, or
    several) against a 40-position encoder output, unmasked."""
    cfg, pcfg = _cfgs("whisper-medium")
    params = jax_attn.init(jax.random.PRNGKey(5), cfg, jnp.float32)
    tparams = _torch_tree(params)
    jenc, tenc = _x((2, 40, cfg.d_model), 6)
    jx, tx = _x((2, s, cfg.d_model), 7)
    want_kv = jax_attn.encode_kv(params, jenc, cfg)
    got_kv = attn.encode_kv(tparams, tenc, pcfg)
    for name in ("k", "v"):
        assert got_kv[name].shape == (2, cfg.n_kv_heads, 40, cfg.head_dim)
        _close(got_kv[name], want_kv[name], name)
    with jax_dispatch.use_backend("interpret"):
        want = jax_attn.cross_attend(params, jx, want_kv, cfg)
    _close(attn.cross_attend(tparams, tx, got_kv, pcfg), want, "out")


def _model_params(arch: str):
    cfg, pcfg = _cfgs(arch)
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    tparams = model_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, pcfg, params, tparams


@pytest.mark.parametrize("stack, causal", [
    ("enc_layers", False),     # the encoder's block
    ("layers", True)])         # a decoder layer's self-attention and MLP
def test_block_apply_matches_jax(stack, causal):
    """``blocks.apply``, the full-sequence attention block without a
    cache, on whisper's first layer of ``stack``: the encoder's unmasked
    and, causal, a decoder layer's (its cross-attention left out)."""
    cfg, pcfg, params, tparams = _model_params("whisper-medium")
    jx, tx = _x((2, 24, cfg.d_model), 8)
    layer = jax.tree.map(lambda a: a[0], params[stack])
    with jax_dispatch.use_backend("interpret"):
        want, aux = jax_blocks.apply(layer, jx, cfg, causal=causal)
    got, got_aux = blocks.apply(tparams[stack][0], tx, pcfg, causal=causal)
    assert got_aux == aux == 0.0
    _close(got, want, stack)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
def test_block_apply_refuses_ssm_mixers(arch):
    """``apply`` once refused the SSM and hybrid mixers (serving runs
    them only through a cache); the training forward runs them over a
    full sequence: the SSD mixer, and the hybrid's two branches with
    their ``0.5 * (norm + norm)`` delta, against the JAX package's
    ``apply`` on the first layer (8 positions, a padded chunk)."""
    cfg, pcfg, params, tparams = _model_params(arch)
    jx, tx = _x((2, 8, cfg.d_model), 9)
    layer = jax.tree.map(lambda a: a[0], params["layers"])
    with jax_dispatch.use_backend("interpret"):
        want, aux = jax_blocks.apply(layer, jx, cfg)
    got, got_aux = blocks.apply(tparams["layers"][0], tx, pcfg)
    assert got_aux == aux == 0.0
    _close(got, want, arch)


def test_block_apply_with_cross_kv_matches_jax():
    """A whisper decoder layer's full-sequence block with its
    cross-attention against ``encode_kv`` of a 40-position encoder
    output (the training forward's), causal."""
    cfg, pcfg, params, tparams = _model_params("whisper-medium")
    jx, tx = _x((2, 24, cfg.d_model), 10)
    jenc, tenc = _x((2, 40, cfg.d_model), 11)
    layer = jax.tree.map(lambda a: a[0], params["layers"])
    with jax_dispatch.use_backend("interpret"):
        kv = jax_attn.encode_kv(layer["cross"], jenc, cfg)
        want, _ = jax_blocks.apply(layer, jx, cfg, causal=True, cross_kv=kv)
    tl = tparams["layers"][0]
    got, _ = blocks.apply(tl, tx, pcfg, causal=True,
                          cross_kv=attn.encode_kv(tl["cross"], tenc, pcfg))
    _close(got, want, "cross")


def test_encoder_stack_matches_jax():
    """``Model._encode``: sinusoids, both encoder layers, the final norm."""
    cfg, pcfg, params, tparams = _model_params("whisper-medium")
    jx, tx = _x((2, 24, cfg.d_model), 8)
    with jax_dispatch.use_backend("interpret"):
        want = jax_build(cfg)._encode(params, jx)
    _close(build(pcfg)._encode(tparams, tx), want, "encoder")


def test_convert_unstacks_enc_layers():
    cfg, pcfg = _cfgs("whisper-medium")
    params = jax.tree.map(np.asarray, jax_build(cfg).init(
        jax.random.PRNGKey(1)))
    out = model_params_from_reference(pcfg, params, device="cpu")
    assert len(out["layers"]) == cfg.n_layers
    assert len(out["enc_layers"]) == cfg.encoder_layers
    assert set(out["enc_layers"][0]) == set(params["enc_layers"])
    assert "cross" in out["layers"][0] and "cross" not in out["enc_layers"][0]
    for i in range(cfg.encoder_layers):
        for name in ("wq", "wo"):
            assert np.array_equal(out["enc_layers"][i]["attn"][name].numpy(),
                                  params["enc_layers"]["attn"][name][i])
    assert np.array_equal(out["enc_final_norm"].numpy(),
                          params["enc_final_norm"])


@pytest.mark.parametrize("arch, pos, enc_len, keys", [
    ("whisper-medium", 1, 12, {"tokens", "frames"}),
    ("internvl2-76b", 12, 0, {"tokens", "patches"}),
    ("hymba-1.5b", 12, 0, {"tokens"})])
def test_serve_inputs_are_the_jax_launchers_stubs(arch, pos, enc_len, keys):
    """The stubs of ``repro/launch/serve.py``: zero frames (B, S, d) and
    the prompts' first token for the audio frontend, a zero patch prefix
    (B, n_frontend_tokens, d) for the vision one; decoding from position
    1 against S encoder positions for enc-dec, else from S."""
    cfg = configs.get(arch).reduced()
    prompts = torch.arange(24).reshape(2, 12)
    batch, got_pos, got_enc = serve_inputs(cfg, prompts)
    assert (got_pos, got_enc, set(batch)) == (pos, enc_len, keys)
    if "frames" in batch:
        assert torch.equal(batch["tokens"], prompts[:, :1])
        assert torch.equal(batch["frames"], torch.zeros(2, 12, cfg.d_model))
    else:
        assert torch.equal(batch["tokens"], prompts)
    if "patches" in batch:
        assert torch.equal(batch["patches"], torch.zeros(
            2, cfg.n_frontend_tokens, cfg.d_model))


def test_encdec_cache_and_prefill_refusals():
    """An enc-dec decoder layer's cache holds separate zeroed cross k and
    v of ``enc_len`` positions; its prefill needs the encoder output, and
    a cross cache of another length than the encoder's is refused."""
    cfg = configs.get("whisper-medium").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 16, 12, device="cpu")
    cross = cache[0]["cross"]
    assert cross["k"].shape == (2, cfg.n_kv_heads, 12, cfg.head_dim)
    assert cross["k"].data_ptr() != cross["v"].data_ptr()
    x = torch.zeros(2, 1, cfg.d_model)
    with pytest.raises(ValueError, match="enc_out"):
        blocks.prefill(params["layers"][0], x, cfg, cache[0])
    batch, _, _ = serve_inputs(cfg, torch.zeros(2, 10, dtype=torch.long))
    with pytest.raises(ValueError, match="enc_len"):
        model.prefill(params, batch, cache)

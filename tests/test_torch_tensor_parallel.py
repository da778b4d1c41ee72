"""The port's tensor parallelism over ``model`` on the CPU, against its
one-device paths: attention split by heads, the SwiGLU MLP by its
hidden dim and the embedding, the head and the loss by vocabulary, as
the JAX package's col/row specs lay them out (Megatron's split).

Sharded runs use ``gloo`` ranks spawned by ``tests/torch_dist.py``: one
group of 2 ranks for the (1, 2) mesh and one of 4 for (2, 2), each
running every scenario it serves once for the module.  The reduced
configs (float32, 4 query and 2 kv heads, d_ff 128, vocabulary 256)
split on a 2-wide ``model`` axis everywhere; the one-device result is
the oracle, within ``RTOL`` = 1e-4 of the largest magnitude.

  * a train step of reduced yi-6b (dense), granite-moe-3b-a800m (MoE)
    and whisper-medium (enc-dec) on (1, 2) and (2, 2): loss, global norm
    and updated parameters;
  * ``serve_batch`` (a prefill and 4 greedy decode steps) of reduced
    yi-6b and whisper-medium against a head-sharded cache on (2, 2):
    every step's logits, the greedy tokens equal;
  * the prefill's collectives: no all-gather over ``model`` (no col or
    row leaf, no logit is gathered), one all-reduce over ``model`` a
    mixer and a SwiGLU MLP, and one for the embedding;
  * one prompt on (2, 2), a batch the data axis does not divide: the
    data axis splits the dense contractions instead (each rank's slice
    of d, the partial products all-reduced over data), as XLA splits
    the reference's -- no weight is gathered over data but the
    embedding, and the tokens and logits are one device's;
  * ``layers.greedy`` on logits split over ``model`` bit for bit equal
    to the argmax of the gathered logits, on planted ties;
  * where ``model`` = 2 does not divide the heads (``torch_dist.
    UNEVEN``: hymba's shape, 5 query and 1 kv head with a window and the
    SSM branch -- attention on the sequence split, a slot-split ring
    cache, the split SSM decode -- and a dense 4/1 -- query heads split
    with their kv group, a slot-split linear cache), on (1, 2) and
    (2, 2): a train step, ``serve_batch``'s logits and tokens, and the
    decode steps' collectives: no all-gather over ``model`` of a
    projection weight's, a cache leaf's or the SSM state's shard, each
    one a token's worth, and the all-reduces over ``model`` as
    ``chip_smoke.tp_collectives`` derives them;
  * hymba's shape (``JAX_UNEVEN``) served on (1, 2) with the JAX
    package's parameters against the JAX package's own serve sharded on
    a (1, 2) host mesh (its subprocess: 2 host devices): the tokens
    equal, every step's logits within ``RTOL``;
  * ``sharding.attn_layout`` for the production configs.

Every scenario's ranks also fail if a functional collective was left
unwaited (``torch_dist._rank_main``).
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch import configs  # noqa: E402

RTOL = torch_dist.RTOL
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNEVEN = list(torch_dist.UNEVEN)
ARCHS = ["yi-6b", "granite-moe-3b-a800m", "whisper-medium"] + UNEVEN
KEYS = {"yi-6b": "yi", "granite-moe-3b-a800m": "granite",
        "whisper-medium": "whisper", **{n: n for n in UNEVEN}}


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        np.all(np.abs(a - b) <= rtol * max(np.abs(b).max(), 1e-30)))


#: the ``UNEVEN`` config also served by the JAX package on a (1, 2)
#: host mesh, and its prompt and generated lengths
JAX_UNEVEN, JAX_PROMPT, JAX_GEN = "hymba-5q1kv", 12, 4


@pytest.fixture(scope="module")
def jax_uneven(tmp_path_factory):
    """The JAX package's sharded serve of ``JAX_UNEVEN`` on a (1, 2) host
    mesh (its ``params_specs``, ``cache_specs`` and ``batch_specs``; a
    jitted prefill and ``JAX_GEN`` greedy decode steps, its plain
    reference kernels), in a subprocess with 2 host devices: an npz of
    its ``PRNGKey(0)`` parameters by "/"-joined key, the prompts, the
    tokens and every step's logits.  None where jax is not installed
    (a card's host): the comparison skips there, the rest runs."""
    if importlib.util.find_spec("jax") is None:
        return None
    out = str(tmp_path_factory.mktemp("jax") / "uneven.npz")
    code = textwrap.dedent(r"""
        import dataclasses, json, sys
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro import configs
        from repro.distributed import sharding
        from repro.kernels import dispatch
        from repro.launch.mesh import make_mesh, mesh_context
        from repro.models import build
        (base, kw), out, prompt, gen = json.loads(sys.argv[1])
        cfg = dataclasses.replace(configs.get(base).reduced(), **kw)
        mesh = make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
        model = build(cfg)
        params = model.init(jax.random.PRNGKey(0))
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, prompt)).astype(np.int32)
        cache = model.init_cache(2, prompt + gen, 0)
        batch = {"tokens": jnp.asarray(prompts)}
        fsdp, _ = sharding.axis_names(mesh)
        with mesh_context(mesh), dispatch.use_backend("ref"):
            psh = sharding.to_shardings(sharding.params_specs(params, mesh),
                                        mesh, params)
            csh = sharding.to_shardings(
                sharding.cache_specs(cache, cfg, mesh), mesh, cache)
            bsh = sharding.to_shardings(sharding.batch_specs(
                batch, mesh, accum_dim=False), mesh, batch)
            tsh = sharding.to_shardings(P(fsdp), mesh, jax.ShapeDtypeStruct(
                (2,), jnp.int32))
            prefill = jax.jit(model.prefill, in_shardings=(psh, bsh, csh),
                              out_shardings=(None, csh))
            decode = jax.jit(model.decode, in_shardings=(psh, tsh, None, csh),
                             out_shardings=(None, csh))
            placed = jax.device_put(params, psh)
            logits, cache = prefill(placed, jax.device_put(batch, bsh),
                                    jax.device_put(cache, csh))
            steps, tokens = [np.asarray(logits)], []
            for i in range(gen):
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                tokens.append(np.asarray(tok))
                logits, cache = decode(placed, tok, prompt + i, cache)
                steps.append(np.asarray(logits))
        flat = {}
        def walk(t, pre):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{pre}/{k}" if pre else k)
            else:
                flat[pre] = np.asarray(t)
        walk(params, "")
        np.savez(out, prompts=prompts, tokens=np.stack(tokens, 1),
                 logits=np.stack(steps),
                 **{"params/" + k: v for k, v in flat.items()})
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code, json.dumps(
        [torch_dist.UNEVEN[JAX_UNEVEN], out, JAX_PROMPT, JAX_GEN])],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_uneven):
    return torch_dist.spawn("tp_two_ranks", 2, tmp_path_factory.mktemp("t2"),
                            jax_uneven and (JAX_UNEVEN, jax_uneven),
                            deadline=300)


@pytest.fixture(scope="module")
def four(tmp_path_factory, two):
    return torch_dist.spawn("tp_four_ranks", 4,
                            tmp_path_factory.mktemp("t4"), deadline=400)


@pytest.fixture(scope="module")
def one_device():
    """Each arch's one-device step: the oracle accumulates the same
    per-shard micro-batches (2 rows)."""
    return {arch: torch_dist.train_one(arch, 1) for arch in ARCHS}


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_train_step_matches_one_device(two, four, one_device, arch,
                                             mesh):
    losses, norms, params = (two if mesh == "1x2" else four)[KEYS[arch]]
    want_l, want_n, want_p = one_device[arch]
    assert _close(losses, want_l) and _close(norms, want_n)
    assert len(params) == len(want_p)
    for a, b in zip(params, want_p):
        assert _close(a, b), float(np.abs(a - b).max())


def _one_device_serve(arch: str, prompt: int = 12, gen: int = 4,
                      n_seq: int = 2):
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    cfg = torch_dist.reduced(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (n_seq, prompt)).astype(np.int32)
    trace = {}
    with torch.no_grad():
        tokens = serve_batch(cfg, params, prompts, gen_tokens=gen,
                             model=model, trace=trace)
    return tokens, [lg.numpy() for lg in trace["logits"]]


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium"])
def test_serve_against_a_head_sharded_cache(four, arch):
    tokens, logits, where, _ = four["serve_" + KEYS[arch]]
    cfg = configs.get(arch).reduced()
    assert cfg.n_kv_heads % 2 == 0
    assert where == "(Shard(dim=0), Shard(dim=1))"   # batch, kv heads
    want_tokens, want = _one_device_serve(arch)
    assert np.array_equal(tokens, want_tokens)
    assert len(logits) == len(want) == 5
    for a, b in zip(logits, want):
        assert _close(a, b)


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium"])
def test_prefill_collectives_over_model(four, arch):
    calls = four["serve_" + KEYS[arch]][3]
    cfg = configs.get(arch).reduced()
    L, E = cfg.n_layers, cfg.encoder_layers
    gathers = [c for c in calls if c[0].startswith("all_gather")]
    assert gathers and all(axis == "data" for _, axis in gathers)
    reduces = sum(1 for kind, axis in calls
                  if kind == "all_reduce" and axis == "model")
    # the embedding; a self-attention and an MLP a layer; an encoder
    # layer's attention and MLP; a decoder layer's cross-attention
    assert reduces == 1 + 2 * L + 2 * E + (L if cfg.is_encdec else 0)
    assert all(axis in ("data", "model") for _, axis in calls)


def test_one_prompt_splits_the_contractions_over_data(four):
    tokens, logits, where, calls = four["serve_yi_one"]
    cfg = configs.get("yi-6b").reduced()
    L = cfg.n_layers
    assert where == "(Replicate(), Shard(dim=1))"   # one row: whole on data
    want_tokens, want = _one_device_serve("yi-6b", n_seq=1)
    assert np.array_equal(tokens, want_tokens)
    for a, b in zip(logits, want):
        assert _close(a, b)

    def count(kind, axis):
        return sum(1 for k, a in calls if k.startswith(kind) and a == axis)
    # the prefill: q, k, v, gate and up a layer and the head summed over
    # data; each mixer's and MLP's slices of d and the embedding table
    # gathered over data; the embedding, mixers and MLPs reduced over model
    assert count("all_reduce", "data") == 5 * L + 1
    assert count("all_gather", "data") == 2 * L + 1
    assert count("all_reduce", "model") == 1 + 2 * L


def test_vocab_split_argmax_is_the_gathered_argmax(two):
    got, want = two["argmax"]
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got.tolist() == [2, 5, 2, 0]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", UNEVEN)
def test_serve_where_model_does_not_divide_the_heads(two, four, arch, mesh):
    tokens, logits, where, _, _, _ = (two if mesh == "1x2" else four)[
        "serve_" + arch]
    cfg = torch_dist.reduced(arch)
    assert cfg.n_heads % 2 or cfg.n_kv_heads % 2
    assert where.endswith("Shard(dim=2))")     # slots over model
    want_tokens, want = _one_device_serve(arch)
    assert np.array_equal(tokens, want_tokens)
    assert len(logits) == len(want) == 5
    for a, b in zip(logits, want):
        assert _close(a, b)


def test_uneven_serve_matches_the_jax_package_on_a_mesh(two, jax_uneven):
    """The port's serve of ``JAX_UNEVEN`` on (1, 2) with the JAX
    package's parameters against the JAX package's own sharded serve:
    the tokens equal, every step's logits within ``RTOL``."""
    if jax_uneven is None:
        pytest.skip("the JAX package's side needs jax")
    tokens, logits = two["jax_" + JAX_UNEVEN]
    with np.load(jax_uneven) as ref:
        want_tokens, want = ref["tokens"], ref["logits"]
    assert np.array_equal(tokens, want_tokens)
    assert len(logits) == len(want) == JAX_GEN + 1
    for a, b in zip(logits, want):
        assert _close(a, b), float(np.abs(a - b).max())


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", UNEVEN)
def test_decode_moves_a_token_not_a_shard(two, four, arch, mesh):
    *_, calls, held = (two if mesh == "1x2" else four)["serve_" + arch]
    cfg = torch_dist.reduced(arch)
    gathers = [shape for (kind, axis), shape in calls
               if kind.startswith("all_gather") and axis == "model"]
    assert gathers                     # each step gathers its token's q/k/v
    rows = 2 // int(mesh[0])
    widest = max((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim,
                 2 * cfg.ssm_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
    for shape in gathers:
        assert shape not in held and shape[1:] not in held, shape
        assert int(np.prod(shape)) <= rows * widest, shape
    assert all(axis in ("data", "model") for (_, axis), _ in calls)
    # all-reduces over model, as chip_smoke.tp_collectives derives them:
    # a step's embedding (a vocabulary model divides), a layer's scores'
    # max, sums and wo, its MLP and its SSM output; each greedy pick's
    # max and index (5 picks, the prefill's logits' first)
    vocab = int(cfg.vocab_size % 2 == 0)
    layer = 3 + int(bool(cfg.d_ff)) + int(cfg.family == "hybrid")
    reduces = sum(1 for (kind, axis), _ in calls
                  if kind == "all_reduce" and axis == "model")
    assert reduces == 4 * (vocab + cfg.n_layers * layer) + 5 * 2 * vocab


@pytest.mark.parametrize("arch,width,want", [
    ("yi-6b", 2, "heads"), ("yi-6b", 8, "groups"), ("yi-6b", 16, "groups"),
    ("hymba-1.5b", 2, "sequence"), ("hymba-1.5b", 5, "heads"),
    ("granite-moe-3b-a800m", 16, "sequence"),
    ("h2o-danube-1.8b", 16, "groups"), ("dbrx-132b", 16, "groups"),
    ("phi3-mini-3.8b", 16, "heads"), ("internvl2-76b", 1, "heads")])
def test_attention_layout_of_the_production_configs(arch, width, want):
    from repro_torch.distributed import sharding
    assert sharding.attn_layout(configs.get(arch), width) == want

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
    to the argmax of the gathered logits, on planted ties.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch import configs  # noqa: E402

RTOL = torch_dist.RTOL
ARCHS = ["yi-6b", "granite-moe-3b-a800m", "whisper-medium"]
KEYS = {"yi-6b": "yi", "granite-moe-3b-a800m": "granite",
        "whisper-medium": "whisper"}


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        np.all(np.abs(a - b) <= rtol * max(np.abs(b).max(), 1e-30)))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return torch_dist.spawn("tp_two_ranks", 2, tmp_path_factory.mktemp("t2"),
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
    cfg = configs.get(arch).reduced()
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

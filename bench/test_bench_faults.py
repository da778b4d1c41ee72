"""The benchmark's ``correct`` on the CPU at a small size (two layers of
width 512, float32, whose logits spread about as the cells' do): a sound run of
each cell kind passes, and a run with the timed path broken underneath
fails, once for each fault the kind of cell can have (serving: a token
altered where it is produced, a decode step that leaves its state
unchanged; training: a step that leaves its state unchanged, half of each
batch left out and the mean taken over the rest).  The drivers run as the
benchmark runs them, without the look for a card, under limits set for
these small models as the cells' limits are set: between the largest
reading of sound runs and the smallest of the float8 control, with more
room above the former."""
import time

import pytest

torch = pytest.importorskip("torch")

from bench import serve_cell, train_cell  # noqa: E402

#: the small models' limits.  Readings on the CPU, seeds 2**31 + 100 ..
#: 105 (serving) and 2**31 + 200 .. 205 (training): sound runs read 0
#: (serving; float32 on both sides) and at most 1.1e-7 (loss), 4.4e-7
#: (first gradient) and 7.3e-6 (change); the control at least 0.055 and
#: 0.0036 (hybrid widest and mean gap), 0.24 and 0.025 (moe), 3.0e-3,
#: 0.025 and 9.3e-3 (training)
LIMITS = {
    "hybrid": {"served_logit_gap": {"limit": 0.01},
               "served_mean_gap": {"limit": 5e-4}},
    "moe": {"served_logit_gap": {"limit": 0.03},
            "served_mean_gap": {"limit": 3e-3}},
    "train": {"loss_gap": {"limit": 1e-5},
              "grad_norm_gap": {"limit": 1e-4},
              "change_norm_gap": {"limit": 3e-4}}}


@pytest.fixture(autouse=True)
def _threads():
    """Two CPU threads a test: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tiny(family: str, d: int = 512) -> dict:
    m = {"name": "tiny-" + family, "family": family, "n_layers": 2,
         "d_model": d, "n_heads": 4, "n_kv_heads": 2, "d_head": d // 4,
         "d_ff": 96, "vocab_size": 256, "dtype": "float32",
         "kv_cache_dtype": "float32", "norm_eps": 1e-5, "remat": "none"}
    if family == "hybrid":
        m.update(window=24, ssm_state=8, ssm_headdim=16, ssm_chunk=16,
                 tie_embeddings=True)
    else:
        m.update(n_experts=4, experts_per_token=2)
    return m


def _serve(family: str) -> dict:
    return {"name": "tiny", "chips": 1, "config": {"model": _tiny(family)},
            "traffic": {"kind": "serve", "clients": 1, "batch": 3,
                        "buckets": [
                            {"prompt_tokens": 12, "output_tokens": 6,
                             "share": 1},
                            {"prompt_tokens": 30, "output_tokens": 10,
                             "share": 1}],
                        "check_per_bucket": 1},
            "limits": LIMITS[family]}


def _altered_token(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "greedy", lambda logits: (
        torch.argmax(logits, dim=-1) + 1) % logits.shape[-1])


def _stale_decode(monkeypatch):
    from repro_torch.models import blocks
    decode = blocks.decode

    def unchanged(p, x, cfg, cache, pos):   # the step's state put back
        leaves = [t for t in _tensors(cache)]
        kept = [t.clone() for t in leaves]
        out = decode(p, x, cfg, cache, pos)
        for t, k in zip(leaves, kept):
            t.copy_(k)
        return out
    monkeypatch.setattr(blocks, "decode", unchanged)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


@pytest.mark.parametrize("family,fault", [
    ("hybrid", None), ("moe", None), ("hybrid", _altered_token),
    ("moe", _altered_token), ("hybrid", _stale_decode),
    ("moe", _stale_decode)])
def test_serve_correct_only_when_sound(monkeypatch, family, fault):
    if fault is not None:
        fault(monkeypatch)
    r = serve_cell.run(_serve(family), 2 ** 31 + 11, 0.05, False, "cpu",
                       time.perf_counter())
    assert r["correct"] is (fault is None), r["checks"]


def _train() -> dict:
    return {"name": "tiny", "chips": 1,
            "config": {"model": _tiny("hybrid", 64)},
            "traffic": {"kind": "train", "global_batch": 4, "seq_len": 24,
                        "micro_per_shard": 2, "warm_steps": 3,
                        "peak_lr": 3e-4, "warmup_steps": 1,
                        "total_steps": 100},
            "limits": LIMITS["train"]}


def _unchanged_state(monkeypatch):
    from repro_torch.distributed import steps

    def update(grads, opt_state, params, cfg):
        return params, {**opt_state, "step": opt_state["step"] + 1}, {
            "lr": 0.0, "grad_norm": torch.zeros(())}
    monkeypatch.setattr(steps, "adamw_update", update)


def _half_batch(monkeypatch):
    from repro_torch.distributed import steps
    vg = steps.value_and_grad

    def half(model, params, batch, accum_steps, *, timing=None):
        return vg(model, params, {k: v[:accum_steps // 2]
                                  for k, v in batch.items()},
                  accum_steps // 2, timing=timing)
    monkeypatch.setattr(steps, "value_and_grad", half)


@pytest.mark.parametrize("fault", [None, _unchanged_state, _half_batch])
def test_train_correct_only_when_sound(monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    r = train_cell.run(_train(), 2 ** 31 + 13, 0.05, False, "cpu",
                       time.perf_counter())
    assert r["correct"] is (fault is None), r["checks"]

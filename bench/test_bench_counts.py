"""The benchmark's counts of operations and bytes, on the CPU: the bounds
reproduce the recorded ``bound_ms`` of the port's kernel table (PERF.md)
before any roofline share is read on the card."""
import json
import os

import pytest

from bench import counts

HERE = os.path.dirname(os.path.abspath(__file__))
H100 = counts.peaks("NVIDIA H100 80GB HBM3")


def _model(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("s,window,q_offset", [
    (7, None, 0), (9, 4, 0), (6, 3, 5), (1, 4, 20), (12, 12, 0)])
def test_live_pairs_by_enumeration(s, window, q_offset):
    want = sum(1 for i in range(s) for j in range(s + q_offset)
               if j <= q_offset + i and (window is None
                                         or j > q_offset + i - window))
    assert counts.live_pairs(s, window=window, q_offset=q_offset) == want


def test_flash_bound_at_hymba_prefill_shape():
    # q 100 x 2048 x 64 (batch 4, 25 heads), kv 5 heads, window 1024
    ms = 1e3 * counts.flash_bound_s(H100, b=4, hq=25, hkv=5, s=2048, d=64,
                                    window=1024)
    assert ms == pytest.approx(0.04073, abs=5e-6)
    ops = counts.flash_ops(100, counts.live_pairs(2048, window=1024), 64)
    assert ms == pytest.approx(1e3 * ops / H100["bf16_flops"])   # ops-bound


def test_ssd_bound_at_hymba_prefill_shape():
    # 32 chunks of 256, 50 heads of 64, state 16: bytes-bound
    ms = 1e3 * counts.ssd_bound_s(H100, bc=32, lc=256, h=50, p=64, n=16)
    assert ms == pytest.approx(0.04955, abs=5e-6)
    nbytes = counts.ssd_bytes(32, 256, 50, 64, 16)
    assert ms == pytest.approx(1e3 * nbytes / H100["hbm_bytes_per_s"])


def test_flash_bound_at_granite_prefill_shape():
    ms = 1e3 * counts.flash_bound_s(H100, b=4, hq=24, hkv=8, s=2048, d=64,
                                    window=None)
    assert ms == pytest.approx(0.05214, abs=5e-6)


@pytest.mark.parametrize("name", ["hymba-1.5b", "granite-moe-3b-a800m"])
def test_model_flops_follow_the_parameters(name):
    m = _model(name)
    per_layer, expert = counts.layer_params(m)
    if m.get("n_experts"):
        assert expert == m["experts_per_token"] * 3 * m["d_model"] * m["d_ff"]
    # a train step is three forward passes over every position
    fwd = counts.forward_flops(
        m, tokens=2 * 64, pairs_per_head=2 * counts.live_pairs(
            64, window=m.get("window")), head_rows=2 * 64)
    assert counts.train_flops(m, 2, 64) == pytest.approx(3 * fwd)
    # a served batch is at least 2 * params a token over its positions
    assert counts.serve_flops(m, 2, 64, 4) > 2 * per_layer * m["n_layers"] \
        * 2 * (64 + 3)

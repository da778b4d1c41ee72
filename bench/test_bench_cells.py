"""Every cell of ``BENCHMARK.json`` finds its files by name, the traffic
generator gives every seed the same work in another order, and a kernel's
roofline share sums each traced launch's own bound."""
import math

import pytest

from bench import counts, harness, traffic
from bench.metrics._common import kernel_roofline

SPEC = harness.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
#: the numbers each kind of cell's driver reads
READINGS = {"serve": {"served_logit_gap", "served_mean_gap"},
            "train": {"loss_gap", "grad_norm_gap", "change_norm_gap"}}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    c = harness.cell(SPEC, name)
    kind = c["traffic"]["kind"]
    assert set(c["limits"]) <= READINGS[kind]
    for v in c["limits"].values():
        assert v["lower"] < v["limit"] < v["upper"], v
    for m in c["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert {"setup_s"} < {m["name"] for m in c["end_to_end"]}
    if kind == "serve":
        top = max(s + g for s, g in traffic.ServeTraffic(
            c["traffic"], 0, 2).buckets)
        assert top <= c["config"]["published"].get(
            "max_position_embeddings", math.inf)


@pytest.mark.parametrize("name", [n for n in CELLS if harness.cell(
    SPEC, n)["traffic"]["kind"] == "serve"])
def test_every_seed_serves_the_same_passes(name):
    tr = harness.cell(SPEC, name)["traffic"]
    a, b = (traffic.ServeTraffic(tr, seed, 1000)
            for seed in (2 ** 31 + 5, 3 * 2 ** 32 + 7))
    n = len(a.deck)
    for p in range(3):
        calls = range(p * n, (p + 1) * n)
        assert sorted(a.shape(i) for i in calls) \
            == sorted(b.shape(i) for i in calls)
    assert [a.shape(i) for i in range(3 * n)] \
        != [b.shape(i) for i in range(3 * n)]
    assert a.ends_pass(n - 1) and not a.ends_pass(n)
    assert a.prompts(n).shape == (a.batch, a.shape(n)[0])
    picked = a.sample(3 * n, tr["check_per_bucket"])
    assert {a.bucket_of(i) for i in picked} == set(range(len(a.buckets)))


class _Profile:
    def __init__(self, times):
        self.times = times

    def launches(self, fragments):
        return self.times


def test_roofline_sums_each_launchs_bound():
    m = {"n_layers": 2, "family": "hybrid", "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "d_head": 16, "window": 8}
    h100 = counts.peaks("NVIDIA H100 80GB HBM3")
    shapes = [(2, 16), (2, 64)]
    per = [counts.flash_launch_s(h100, m, r, s) for r, s in shapes]
    # two rounds of the two shapes, a launch a layer, each at twice its bound
    times = [2 * t for _ in range(2) for t in per for _ in range(2)]
    ctx = {"kind": "serve", "model": m, "launch_shapes": shapes,
           "device": {"kind": "NVIDIA H100 80GB HBM3"},
           "profile": _Profile(times)}
    got = kernel_roofline(ctx, "serve", ("flash_kernel",),
                          counts.flash_launch_s)
    assert got == pytest.approx(50.0)
    ctx["profile"] = _Profile(times[:-2])   # not whole rounds: no reading
    assert kernel_roofline(ctx, "serve", ("flash_kernel",),
                           counts.flash_launch_s) is None

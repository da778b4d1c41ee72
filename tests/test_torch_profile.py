"""The port's cost-model-attributed profiler against the JAX package's.

The same seeded mixed-lane traffic (``profile_smoke_workload``: 64
requests, seed 17, both dtype lanes and all three plan kinds) served by
both packages on the CPU under a ``VirtualClock``: the ``launch``
instants are equal field for field, the autotune ones (``config``,
``kernel``, ``pred_*``) included, so ``Profile.counters()`` are equal --
the reference's stream without its ``plan.trace`` instants, which eager
PyTorch does not have -- and the observed/predicted byte ratio is exactly
1.0 on every launch.  The dump round-trips byte for byte.
"""
import json
import os
import subprocess
import sys

import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import serving as jserving  # noqa: E402
from repro.obs import profile as jprofile  # noqa: E402
from repro_torch import obs, serving  # noqa: E402
from repro_torch.obs import profile  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def smoke():
    """Both packages' smoke profile: (port tracer, port stats, reference
    tracer, reference stats)."""
    serving.reset_stats()
    tracer, _ = profile.profile_smoke_workload(device="cpu")
    stats = dict(serving.stats)
    jserving.reset_stats()
    jtracer, _ = jprofile.profile_smoke_workload()
    jstats = dict(jserving.stats)
    return tracer, stats, jtracer, jstats


def _reference_spans(jtracer):
    return [s for s in jtracer.spans if s.name != "plan.trace"]


def test_launch_instants_equal_the_reference(smoke):
    tracer, _, jtracer, _ = smoke
    mine = [(s.track, s.tickets, s.attrs) for s in tracer.spans
            if s.name == "launch"]
    theirs = [(s.track, s.tickets, s.attrs) for s in jtracer.spans
              if s.name == "launch"]
    assert mine == theirs
    assert {"config", "kernel", "pred_hbm_bytes", "pred_flops",
            "pred_m1_cycles"} <= set(mine[0][2])
    assert {a["config"] for _, _, a in mine} == {"default"}


def test_counters_equal_the_reference(smoke):
    tracer, _, jtracer, _ = smoke
    mine = profile.Profile.from_tracer(tracer).counters()
    theirs = jprofile.Profile.from_spans(_reference_spans(jtracer)) \
        .counters()
    assert mine == theirs
    assert mine["byte_ratio_exact"] == 1 and mine["launches"] > 0
    assert mine["kernels"] == 5        # three float kinds, two q kinds


def test_launch_tables_equal_the_reference(smoke):
    tracer, _, jtracer, _ = smoke
    prof = profile.Profile.from_tracer(tracer)
    jprof = jprofile.Profile.from_spans(_reference_spans(jtracer))
    for table in ("kernels", "buckets", "kinds"):
        assert {k: vars(g) for k, g in getattr(prof, table).items()} == \
            {k: vars(g) for k, g in getattr(jprof, table).items()}, table
    assert prof.byte_ratios == jprof.byte_ratios


def test_launches_equal_the_engine_counter(smoke):
    tracer, stats, _, jstats = smoke
    prof = profile.Profile.from_tracer(tracer)
    assert prof.launches == stats["launches"] == jstats["launches"]
    assert prof.byte_ratio_exact


def test_attribution_tree_self_time(smoke):
    """Self time is total minus the child extents; the tree's counts are
    the span stream's."""
    tracer, *_ = smoke
    prof = profile.Profile.from_tracer(tracer)
    for _, node in prof.root.walk():
        if node is prof.root or not node.children:
            continue
        kids = sum(c.total_s for c in node.children.values()
                   if c.name != "launch")
        assert node.self_s == pytest.approx(node.total_s - kids, abs=1e-9)
    assert sum(n.count for _, n in prof.root.walk()
               if n is not prof.root) == prof.n_events


def test_markdown_report_shape(smoke):
    tracer, *_ = smoke
    text = profile.Profile.from_tracer(tracer).render_markdown()
    for section in ("## Attribution tree", "## Launches by kernel",
                    "## Launches by bucket", "## Launches by plan kind",
                    "## Model error"):
        assert section in text
    assert "exact (every ratio == 1.0): True" in text


def test_dump_round_trip_is_byte_deterministic(smoke, tmp_path):
    tracer, *_ = smoke
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    n = profile.dump_span_stream(tracer, str(a))
    assert n == len(tracer.spans)
    spans = profile.load_span_stream(str(a))
    holder = obs.Tracer()
    holder.spans = spans
    profile.dump_span_stream(holder, str(b))
    assert a.read_bytes() == b.read_bytes()
    assert profile.Profile.from_spans(spans).counters() == \
        profile.Profile.from_tracer(tracer).counters()
    # and a second run of the workload dumps the same bytes
    again, _ = profile.profile_smoke_workload(device="cpu")
    c = tmp_path / "c.jsonl"
    profile.dump_span_stream(again, str(c))
    assert c.read_bytes() == a.read_bytes()


def test_a_stream_without_predictions_folds():
    """A stream whose launches carry no prediction folds by kind and
    reports no exact ratio."""
    trc = obs.Tracer()
    trc.instant("launch", track="2D:TS|ref|<f4|8", kind="diag", rows=2,
                lpad=8, hbm_bytes=100)
    prof = profile.Profile.from_tracer(trc)
    assert list(prof.kernels) == ["diag"] and not prof.byte_ratio_exact
    assert "no launches carried predictions" in prof.render_markdown()


def test_cli_smoke_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = tmp_path / "spans.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.profile", "--smoke",
         "--device", "cpu", "--spans-out", str(out), "--markdown",
         str(tmp_path / "r.md")], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.profile", "--spans",
         str(out), "--chrome", str(tmp_path / "t.json")], env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "# Serving profile" in res.stdout
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]

"""``repro_torch.obs.bench_history``, the port's copy of the JAX
package's bench-trajectory analytics: its reports on the committed
``benchmarks/BENCH_*.json`` records equal the reference's, string for
string, and its drift check flags a planted regression."""
import json
import os
import shutil

import pytest

pytest.importorskip("torch")

from repro.obs import bench_history as jbh  # noqa: E402
from repro_torch.obs import bench_history as bh  # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


def test_history_and_reports_equal_the_reference():
    port, ref = bh.load_history(BENCH), jbh.load_history(BENCH)
    assert len(port) == len(ref) > 1
    assert [r.name for r in port] == [r.name for r in ref]
    assert [r.rows for r in port] == [r.rows for r in ref]
    assert bh.drift_report(port) == jbh.drift_report(ref)
    assert [str(r) for r in bh.find_regressions(port)] == \
        [str(r) for r in jbh.find_regressions(ref)]
    assert bh.LOWER_IS_BETTER == jbh.LOWER_IS_BETTER


def test_series_equals_the_reference():
    port, ref = bh.load_history(BENCH), jbh.load_history(BENCH)
    row = next(iter(port[-1].rows))
    for field in sorted(port[-1].rows[row]):
        assert bh.series(port, row, field) == jbh.series(ref, row, field)


def test_a_planted_regression_is_found(tmp_path):
    records = sorted(f for f in os.listdir(BENCH)
                     if f.startswith("BENCH_"))
    last = records[-1]
    shutil.copy(os.path.join(BENCH, last), tmp_path / last)
    with open(os.path.join(BENCH, last)) as f:
        doc = json.load(f)
    row = next(r for r in doc["rows"] if "launches" in r)
    row["launches"] += 1
    with open(tmp_path / "BENCH_99999999_000000.json", "w") as f:
        json.dump(doc, f)
    found = bh.find_regressions(bh.load_history(str(tmp_path)))
    assert [(r.row, r.field) for r in found] == [(row["name"], "launches")]
    assert [str(r) for r in found] == [str(r) for r in jbh.find_regressions(
        jbh.load_history(str(tmp_path)))]

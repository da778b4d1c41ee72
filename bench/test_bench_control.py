"""The control at a size a test run holds: the fault tests' small models
on the CPU.  The reference computed in float8 takes the program's place,
its readings go through the same limits and the same rule that decide
``correct``, and it comes out not correct, while the program's run
beside it comes out correct.  On the card, at the cells' own sizes, the
control's verdict is read by ``bench/calibrate.py`` (PERF.md)."""
import time

import pytest

torch = pytest.importorskip("torch")

from bench import serve_cell, train_cell  # noqa: E402
from bench.test_bench_faults import _serve, _train  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    """Two CPU threads a test: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("family", ["hybrid", "moe"])
def test_serving_control_is_not_correct(family):
    r = serve_cell.run(_serve(family), 2 ** 31 + 17, 0.05, False, "cpu",
                       time.perf_counter(), control=True)
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, r["control_checks"]
    assert r["verdict"]["control_off_best"] > 0, r["verdict"]


def test_training_control_is_not_correct():
    r = train_cell.run(_train(), 2 ** 31 + 19, 0.05, False, "cpu",
                       time.perf_counter(), control=True)
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, r["control_checks"]

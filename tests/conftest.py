"""Pytest settings for the suite: registers the ``cuda`` marker.

Tests marked ``cuda`` need a CUDA device; each decides inside the test
(the ``cuda_device`` fixture of the port's test files) and skips with a
reason where there is none.  Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")

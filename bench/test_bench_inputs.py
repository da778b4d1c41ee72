"""The reference's frozen copies of what ``train_loop`` draws from its seed
agree with the port's own draws, on the CPU at a tiny size."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench import train_inputs  # noqa: E402
from bench.test_bench_faults import _tiny  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    """Two CPU threads a test: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _named(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("family", ["hybrid", "moe"])
def test_init_params_are_the_ports(family):
    from repro_torch.models import build
    from repro_torch.models.config import ModelConfig
    m = dict(_tiny(family, 64), dtype="bfloat16", tie_embeddings=False)
    got = build(ModelConfig(**m)).init(torch.Generator().manual_seed(2 ** 33))
    mine = dict(train_inputs.init_params(m, 2 ** 33, "cpu"))
    low = {p for p, _, how in train_inputs.param_specs(m)
           if train_inputs.stored_low(how)}
    theirs = dict(_named(got))
    assert set(theirs) == set(mine)
    for path, t in theirs.items():
        assert (t.dtype == torch.bfloat16) is (path in low), path
        assert torch.equal(t.float(), mine[path]), path


def test_global_batch_is_the_ports():
    from repro_torch.data import DataConfig, SyntheticLMData
    data = SyntheticLMData(DataConfig(vocab_size=301, seq_len=33,
                                      global_batch=3, seed=2 ** 31 + 3))
    for step in (0, 2):
        want = data.global_batch(step)
        got = train_inputs.global_batch(301, 33, 3, 2 ** 31 + 3, step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])

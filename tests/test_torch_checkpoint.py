"""The port's checkpoint store, data pipeline and restart contract: the
JAX package's ``tests/test_checkpoint.py`` (atomic saves, retention,
structure check, manifest, async saves, kill-and-resume equal to an
uninterrupted run) and its data tests (``tests/test_system.py::
TestDataPipeline``) on the port, plus ``SyntheticLMData``'s batches
bitwise equal to the reference's for the same ``(seed, step)`` and every
frontend.

Tolerance: restores and batches are bitwise.  Kill-and-resume holds the
histories and final parameters to the reference test's own rtol/atol
2e-4 / 2e-3; on the CPU the port's run is in fact bit-for-bit
repeatable.
"""
import json
import os

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JaxSyntheticLMData  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "c": torch.randn(2, 2, generator=g).to(torch.bfloat16)},
            "layers": [{"w": torch.randn(3, generator=g)} for _ in range(2)],
            "step": 7}


def _like(tree):
    """A template: the same structure, other values."""
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v) for v in tree]
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0


class TestStore:
    def test_roundtrip(self, tmp_path):
        t = _tree()
        save_checkpoint(str(tmp_path), 10, t)
        restored, step = load_checkpoint(str(tmp_path), _like(t))
        assert step == 10
        assert restored["step"] == 7
        for a, b in zip(leaves(t), leaves(restored)):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b)

    def test_latest_step_ignores_incomplete(self, tmp_path):
        save_checkpoint(str(tmp_path), 5, _tree())
        # a crashed save: directory without manifest
        os.makedirs(tmp_path / "step_000000009")
        assert latest_step(str(tmp_path)) == 5

    def test_atomic_tmp_never_visible(self, tmp_path):
        save_checkpoint(str(tmp_path), 7, _tree())
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))

    def test_retention_gc(self, tmp_path):
        for s in range(1, 6):
            save_checkpoint(str(tmp_path), s, _tree(), keep=2)
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
        assert steps == [4, 5]

    def test_structure_mismatch_rejected(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        with pytest.raises(ValueError):
            load_checkpoint(str(tmp_path), {"different": torch.zeros(3)})
        t = _like(_tree())
        t["layers"].append({"w": torch.zeros(3)})   # one more layer
        with pytest.raises(ValueError):
            load_checkpoint(str(tmp_path), t)

    def test_manifest_contents(self, tmp_path):
        save_checkpoint(str(tmp_path), 3, _tree(), extra={"arch": "yi-6b"})
        with open(tmp_path / "step_000000003" / "manifest.json") as f:
            m = json.load(f)
        assert m["step"] == 3 and m["extra"]["arch"] == "yi-6b"
        assert "['layers'][1]['w']" in m["keys"]


class TestManagerAsync:
    def test_async_save_completes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), interval=2, keep=3)
        t = _tree()
        assert not mgr.maybe_save(1, t)      # off-interval
        assert mgr.maybe_save(2, t)
        t["a"].add_(1.0)                     # the snapshot was taken
        mgr.wait()
        assert latest_step(str(tmp_path)) == 2
        restored, _ = load_checkpoint(str(tmp_path), _like(t))
        assert torch.equal(restored["a"], _tree()["a"])


class TestResume:
    def test_kill_and_resume_matches_uninterrupted(self, tmp_path):
        """Train 10 steps; separately train 6, 'crash', resume to 10.
        Histories and final params must agree -- the restart contract."""
        cfg = configs.get("mamba2-130m").reduced()
        kw = dict(global_batch=8, seq_len=64, log_every=100,
                  ckpt_interval=3, seed=11, device="cpu",
                  # fixed horizon: the LR schedule must not depend on how
                  # many steps this particular incarnation will run
                  opt_cfg=AdamWConfig(total_steps=10, warmup_steps=2))
        p_full, h_full = train_loop(cfg, steps=10,
                                    ckpt_dir=str(tmp_path / "full"), **kw)
        p1, h1 = train_loop(cfg, steps=6, ckpt_dir=str(tmp_path / "r"), **kw)
        # crash after step 6 (checkpoint exists at step 6); resume
        assert latest_step(str(tmp_path / "r")) == 6
        p2, h2 = train_loop(cfg, steps=10, ckpt_dir=str(tmp_path / "r"),
                            resume=True, **kw)
        np.testing.assert_allclose(h1[:6] + h2, h_full, rtol=2e-4, atol=2e-4)
        for a, b in zip(leaves(p_full), leaves(p2)):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=2e-3, atol=2e-3)


# -- the data pipeline ----------------------------------------------------------

@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
def test_batches_bitwise_equal_reference(frontend):
    kw = dict(vocab_size=97, seq_len=48, global_batch=4, seed=5,
              frontend=frontend, n_frontend_tokens=6, d_model=16)
    mine = SyntheticLMData(DataConfig(**kw))
    ref = JaxSyntheticLMData(JaxDataConfig(**kw))
    for step in (0, 3, 1000):
        a, b = mine.global_batch(step), ref.global_batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
        la, lb = mine.local_batch(step, 1, 2), ref.local_batch(step, 1, 2)
        assert all(la[k].tobytes() == lb[k].tobytes() for k in la)


class TestDataPipeline:
    def test_step_seekable_determinism(self):
        """batch(step) is a pure function -- the restart contract."""
        cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8, seed=3)
        d1, d2 = SyntheticLMData(cfg), SyntheticLMData(cfg)
        for step in (0, 7, 1000):
            b1, b2 = d1.global_batch(step), d2.global_batch(step)
            np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_steps_differ(self):
        d = SyntheticLMData(DataConfig(vocab_size=100, seq_len=32,
                                       global_batch=8))
        assert not np.array_equal(d.global_batch(0)["tokens"],
                                  d.global_batch(1)["tokens"])

    def test_host_shards_concatenate_to_global(self):
        d = SyntheticLMData(DataConfig(vocab_size=100, seq_len=16,
                                       global_batch=8))
        g = d.global_batch(5)["tokens"]
        parts = [d.local_batch(5, h, 4)["tokens"] for h in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts), g)

    def test_labels_are_next_tokens_structure(self):
        """Stream has learnable next-token structure (Markov component)."""
        d = SyntheticLMData(DataConfig(vocab_size=97, seq_len=256,
                                       global_batch=4))
        b = d.global_batch(0)
        follow = (b["tokens"] * 31 + 7) % 97
        frac = (b["labels"] == follow).mean()
        assert 0.3 < frac < 0.7   # ~half the transitions are deterministic

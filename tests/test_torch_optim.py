"""The port's optimizer (``repro_torch.optim``) against the JAX package's:
``warmup_cosine`` along a schedule, ``global_norm``, and ``adamw_update``
from the same gradients and the same state (carried across by
``convert.opt_state_from_reference``) over a reduced model's parameter
tree, three steps in a row; then the JAX package's own optimizer tests
(``tests/test_distributed.py::TestOptimizer``) on the port.

Tolerance: the port runs the reference's formulas op for op in float32;
what differs is the order of the global norm's sum of squares (within
1e-6 relative) and an ulp of ``cos``/``sqrt``/``pow`` between XLA and
torch (the learning rate within 2 ulps).  The clip scale carries the
norm's rounding into the moments: ``m`` (linear in the gradient) within
8 float32 ulps of the terms of ``b1 m + (1 - b1) g`` (which may
cancel), ``v`` (quadratic, a sum of positive terms) within 16 ulps of
itself.  The masters
and params within 4 ulps of the terms of ``master - lr * update``:
4 eps32 (|master| + lr (|m_hat| / (sqrt(v_hat) + eps) + wd |master|)),
since the update is a difference of those terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.optim.adamw import global_norm as jax_global_norm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 opt_state_from_reference)
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, warmup_cosine)
from repro_torch.optim.adamw import global_norm, leaves, tree_map  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def _within(got: torch.Tensor, want: torch.Tensor, scale) -> bool:
    return bool(((got.double() - want.double()).abs() <= scale).all())


def _ulps(got: torch.Tensor, want: torch.Tensor, n: float) -> bool:
    return _within(got, want, n * EPS32 * want.double().abs().clamp_min(
        float(np.finfo(np.float32).tiny)))


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 10), (1, 3),
                                          (100, 10_000)])
def test_warmup_cosine_matches_reference(warmup, total):
    for step in sorted({0, 1, warmup // 2, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 5}):
        kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
        want = float(jax_warmup_cosine(step, **kw))
        got = warmup_cosine(step, **kw)
        assert abs(got - want) <= 2 * EPS32 * abs(want), (step, got, want)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(27)
    tree = {"a": rng.standard_normal((64, 32)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32)]}
    want = float(jax_global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm(tree_map(torch.from_numpy, tree)))
    assert abs(got - want) <= 1e-6 * want


def test_adamw_update_matches_reference_over_a_model_tree():
    """Three AdamW steps on granite-moe's reduced parameters (dense
    matrices, MoE expert stacks, float32 gains), each from the reference's
    params and state carried across and the same random gradients,
    clipping active on the first: every leaf of the new params and state
    within the bounds above."""
    cfg = jax_configs.get("granite-moe-3b-a800m").reduced()
    pcfg = configs.get(cfg.name).reduced()
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    jstate = jax_adamw_init(params)
    ocfg = dict(peak_lr=1e-2, warmup_steps=1, total_steps=5,
                weight_decay=0.1, clip_norm=1.0)
    rng = np.random.default_rng(27)
    update = jax.jit(lambda g, s, p: jax_adamw_update(
        g, s, p, JaxAdamWConfig(**ocfg)))

    def port(tree):
        return model_params_from_reference(
            pcfg, jax.tree.map(np.asarray, tree), device="cpu")
    for step in range(3):
        pparams = port(params)
        pstate = opt_state_from_reference(
            pcfg, jax.tree.map(np.asarray, jstate), device="cpu")
        old_w, old_m = leaves(pstate["master"]), leaves(pstate["m"])
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * (10.0 if step == 0 else 0.01), params)
        params, jstate, jm = update(jax.tree.map(jnp.asarray, g), jstate,
                                    params)
        pg = model_params_from_reference(pcfg, g, device="cpu")
        pparams, pstate, pm = adamw_update(pg, pstate, pparams,
                                           AdamWConfig(**ocfg))
        assert pstate["step"] == int(jstate["step"]) == step + 1
        assert abs(pm["lr"] - float(jm["lr"])) <= 2 * EPS32 * pm["lr"]
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
        ref = {k: leaves(port(v)) for k, v in (
            ("params", params), ("master", jstate["master"]),
            ("m", jstate["m"]), ("v", jstate["v"]))}
        clip = min(1.0, 1.0 / float(jm["grad_norm"]))
        b1c, b2c = 1 - 0.9 ** (step + 1), 1 - 0.95 ** (step + 1)
        for i, (w, m, v, p) in enumerate(zip(
                leaves(pstate["master"]), leaves(pstate["m"]),
                leaves(pstate["v"]), leaves(pparams))):
            m_terms = 0.9 * old_m[i].double().abs() \
                + 0.1 * clip * leaves(pg)[i].double().abs()
            assert _within(m, ref["m"][i], 8 * EPS32 * m_terms), (step, i)
            assert _ulps(v, ref["v"][i], 16), (step, i)
            old = old_w[i].double().abs()
            u = (m_terms / b1c) / ((ref["v"][i].double() / b2c).sqrt()
                                   + 1e-8)
            w_terms = old + pm["lr"] * (u + 0.1 * old)
            assert _within(w, ref["master"][i], 4 * EPS32 * w_terms), \
                (step, i)
            assert p.dtype == ref["params"][i].dtype
            assert _within(p, ref["params"][i], 4 * EPS32 * w_terms), \
                (step, i)


def test_adamw_init_layout():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "layers": [{"g": torch.ones(2)}]}
    state = adamw_init(params)
    assert state["step"] == 0
    assert state["master"]["w"].dtype == torch.float32
    # a distinct buffer even for a float32 parameter
    assert state["master"]["layers"][0]["g"].data_ptr() \
        != params["layers"][0]["g"].data_ptr()
    assert float(state["m"]["w"].abs().sum()) == 0.0


# -- the JAX package's optimizer tests, on the port --------------------------------

class TestOptimizer:
    def test_adamw_converges_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = adamw_init(params)
        cfg = AdamWConfig(peak_lr=0.2, warmup_steps=5, total_steps=200,
                          weight_decay=0.0)
        for _ in range(200):
            g = {"w": 2 * state["master"]["w"]}
            params, state, _ = adamw_update(g, state, params, cfg)
        assert float(params["w"].abs().max()) < 0.05

    def test_weight_decay_skips_1d(self):
        params = {"gain": torch.ones(4), "w": torch.ones(4, 4)}
        state = adamw_init(params)
        cfg = AdamWConfig(peak_lr=0.0, warmup_steps=0, total_steps=10,
                          weight_decay=0.5)
        g = tree_map(torch.zeros_like, params)
        newp, _, _ = adamw_update(g, state, params, cfg)
        # lr=0 -> nothing moves even with decay (decay scales with lr)
        assert torch.equal(newp["gain"], params["gain"])

    def test_weight_decay_reaches_only_matrices(self):
        params = {"gain": torch.ones(4), "w": torch.ones(4, 4)}
        state = adamw_init(params)
        cfg = AdamWConfig(peak_lr=0.1, warmup_steps=0, total_steps=10,
                          weight_decay=0.5)
        newp, _, _ = adamw_update(tree_map(torch.zeros_like, params), state,
                                  params, cfg)
        assert torch.equal(newp["gain"], params["gain"])
        assert bool((newp["w"] < 1.0).all())

    def test_grad_clipping(self):
        params = {"w": torch.zeros(3)}
        state = adamw_init(params)
        cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, total_steps=10)
        _, state, m = adamw_update({"w": torch.full((3,), 100.0)}, state,
                                   params, cfg)
        assert float(m["grad_norm"]) > 100
        # the moment saw the clipped gradient: (1 - b1) * 100 / |g|
        assert torch.allclose(state["m"]["w"],
                              torch.full((3,), 0.1 * 100 / float(
                                  m["grad_norm"])))

    def test_schedule_shape(self):
        lr0 = warmup_cosine(0, peak_lr=1.0, warmup_steps=10, total_steps=100)
        lr10 = warmup_cosine(10, peak_lr=1.0, warmup_steps=10,
                             total_steps=100)
        lr100 = warmup_cosine(100, peak_lr=1.0, warmup_steps=10,
                              total_steps=100)
        assert lr0 == 0.0
        assert lr10 == 1.0
        assert 0.05 < lr100 < 0.15

    def test_global_norm(self):
        t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
        assert float(global_norm(t)) == 5.0

    def test_master_weights_preserve_bf16_params(self):
        params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
        state = adamw_init(params)
        assert state["master"]["w"].dtype == torch.float32
        g = {"w": torch.full((4, 4), 1e-3, dtype=torch.bfloat16)}
        newp, state, _ = adamw_update(g, state, params,
                                      AdamWConfig(warmup_steps=0))
        assert newp["w"].dtype == torch.bfloat16
        assert state["master"]["w"].dtype == torch.float32

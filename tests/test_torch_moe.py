"""The port's MoE FFN against the JAX package's ``_moe_local`` (no mesh), in
float32 at ``reduced()`` widths: a prompt (S > 1, one group a sequence),
a decode step (S = 1, B = 4: ONE group of 4 tokens, capacity 8) and a
router that sends every token to one expert, overflowing its capacity.

Held: the expert ids and the keep mask equal to the reference's (its
routing lines, ``repro/models/moe.py:_moe_local``, run in jnp here,
since ``_moe_local`` returns only ``y`` and ``aux``); ``y`` within
RTOL = 1e-4 of max |y| and ``aux`` within 1e-6 relative of
``_moe_local``'s.  The port sums a token's k contributions in the order
the reference's scatter-add visits them on the CPU (ascending sorted
position), so the remaining differences are the products' and the
softmax's float32 rounding, a few ulp.  The seeds are fixed so that the
k-th and (k+1)-th router probabilities differ by at least 1e-4 at every
token -- asserted -- so the test holds the port, not float32 ties.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402

RTOL = 1e-4
AUX_RTOL = 1e-6
MARGIN = 1e-4
#: (experts, top-k) beside the reduced configs' (4, 2)
WIDER = (8, 3)


def _cfgs(wider: bool):
    cfg = jax_configs.get("granite-moe-3b-a800m").reduced()
    pcfg = configs.get("granite-moe-3b-a800m").reduced()
    if wider:
        e, k = WIDER
        cfg = dataclasses.replace(cfg, n_experts=e, experts_per_token=k)
        pcfg = dataclasses.replace(pcfg, n_experts=e, experts_per_token=k)
    return cfg, pcfg


def _ref_routing(router, x, cfg):
    """``_moe_local``'s routing and slot lines (repro/models/moe.py), in
    jnp: (expert_ids, keep in sorted order, probs)."""
    if x.shape[1] == 1 and x.shape[0] > 1:
        x = x.reshape(1, x.shape[0], -1)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    c = jmoe.capacity(cfg, s)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    ids = expert_ids.reshape(b, s * k)
    order = jnp.argsort(ids, axis=-1, stable=True)
    sid = jnp.take_along_axis(ids, order, -1)
    counts = jax.nn.one_hot(ids, e, dtype=jnp.int32).sum(axis=1)
    starts = jnp.cumsum(counts, axis=-1) - counts
    pos = jnp.arange(s * k)[None] - jnp.take_along_axis(starts, sid, -1)
    return (np.asarray(expert_ids), np.asarray(pos < c), np.asarray(probs))


#: the overflow case's (shift of x, boost of the router's expert-0
#: column) along one direction, by config: every token routes to expert
#: 0, whose mass still leaves the other probabilities MARGIN apart
OVERFLOW = {False: (4.0, 1.0), True: (4.0, 0.5)}


def _case(case: str, cfg, seed: int):
    """(JAX params, x) for a case, numpy-seeded; the overflow case
    shifts every token and boosts the router's expert-0 column along one
    direction."""
    params = jmoe.init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng([seed, len(case)])
    shape = {"prefill": (2, 48), "decode": (4, 1), "overflow": (2, 48)}[case]
    x = rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)
    if case == "overflow":
        u = rng.standard_normal(cfg.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        shift, boost = OVERFLOW[cfg.n_experts != 4]
        x = x + shift * u
        router = np.asarray(params["router"]).copy()
        router[:, 0] += boost * u
        params = dict(params, router=jnp.asarray(router))
    return params, x


#: the seeds of each (case, wider): chosen so every token's k-th and
#: (k+1)-th probabilities differ by at least MARGIN
SEEDS = {("prefill", False): 0, ("decode", False): 0, ("overflow", False): 1,
         ("prefill", True): 0, ("decode", True): 0, ("overflow", True): 8}


@pytest.mark.parametrize("wider", [False, True], ids=["e4k2", "e8k3"])
@pytest.mark.parametrize("case", ["prefill", "decode", "overflow"])
def test_moe_ffn_matches_reference(case, wider):
    cfg, pcfg = _cfgs(wider)
    params, x = _case(case, cfg, SEEDS[case, wider])
    ids, keep, probs = _ref_routing(params["router"], jnp.asarray(x), cfg)
    k = cfg.experts_per_token
    top = -np.sort(-probs, axis=-1)
    assert (top[..., k - 1] - top[..., k]).min() >= MARGIN

    pparams = {n: torch.from_numpy(np.asarray(v).copy())
               for n, v in params.items()}
    r = moe.route(pparams["router"], torch.from_numpy(x), pcfg)
    assert np.array_equal(r.expert_ids.numpy(), ids)
    assert np.array_equal(r.keep.numpy(), keep)
    if case == "decode":
        assert r.capacity == 8 and r.keep.shape == (1, 4 * k)
    if case == "overflow":
        assert (ids == 0).any(axis=-1).all() and not keep.all()
    else:
        assert keep.all()

    y, aux = jmoe._moe_local(params["router"], params["w_gate"],
                             params["w_up"], params["w_down"],
                             jnp.asarray(x), cfg, tp_axis=None)
    y, aux = np.asarray(y), float(aux)
    py, paux = moe.moe_ffn(pparams, torch.from_numpy(x), pcfg)
    assert py.shape == y.shape and py.dtype == torch.float32
    assert np.abs(py.numpy() - y).max() <= RTOL * np.abs(y).max()
    assert abs(float(paux) - aux) <= AUX_RTOL * abs(aux)
    again, _ = moe.moe_ffn(pparams, torch.from_numpy(x), pcfg)
    assert torch.equal(again, py)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "dbrx-132b"])
def test_capacity_and_init_shapes_match_reference(arch):
    for cfg, pcfg in ((jax_configs.get(arch), configs.get(arch)),
                      (jax_configs.get(arch).reduced(),
                       configs.get(arch).reduced())):
        for tokens in (1, 4, 7, 48, 2048, 8192):
            assert moe.capacity(pcfg, tokens) == jmoe.capacity(cfg, tokens)
    jp = jmoe.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    pp = moe.init(torch.Generator().manual_seed(0), pcfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in pp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert pp["router"].dtype == torch.float32
    lp = build(pcfg).init(torch.Generator().manual_seed(0))["layers"][0]
    assert set(lp) == {"attn_norm", "attn", "mlp_norm", "moe"}
    assert moe.capacity(configs.get("granite-moe-3b-a800m"), 4) == 8


def test_decode_groups_the_batch_and_prefill_groups_each_sequence():
    """A decode step's tokens share one group's capacity; a prompt's
    sequences route apart: sequence 0 alone takes the same experts and
    slots, and gives the same rows."""
    cfg, pcfg = _cfgs(False)
    params, x = _case("prefill", cfg, 0)
    pparams = {n: torch.from_numpy(np.asarray(v).copy())
               for n, v in params.items()}
    xt = torch.from_numpy(x)
    both, alone = moe.route(pparams["router"], xt, pcfg), \
        moe.route(pparams["router"], xt[:1], pcfg)
    assert torch.equal(both.expert_ids[:1], alone.expert_ids)
    assert torch.equal(both.keep[:1], alone.keep)
    y, _ = moe.moe_ffn(pparams, xt, pcfg)
    y0, _ = moe.moe_ffn(pparams, xt[:1], pcfg)
    assert float((y[:1] - y0).abs().max()) <= RTOL * float(y0.abs().max())
    step = xt[:, :1]                            # (2, 1, d): one group
    r = moe.route(pparams["router"], step, pcfg)
    assert r.expert_ids.shape == (1, 2, cfg.experts_per_token)
    assert r.capacity == 8 and r.keep.all()
    assert int(r.dest.max()) < cfg.n_experts * r.capacity


def test_serve_launcher_serves_a_reduced_moe_arch_on_the_cpu(capsys):
    serve.main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device",
                "cpu", "--batch", "2", "--prompt-len", "8",
                "--gen-tokens", "3"])
    assert "granite-moe-3b-a800m" in capsys.readouterr().out

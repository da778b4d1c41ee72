"""The serve step's layer spans, its phases and the MoE drop counter
(``repro_torch.obs.steps``) on the CPU, for the reduced hymba (hybrid:
attention and SSM) and granite (MoE):

  * the tokens are bit for bit the same with no tracer, with an
    ``obs.Tracer`` installed, with ``eager=True``, and from
    ``CompiledServe``'s static-buffer steps with their spans armed;
  * a decode step with a tracer gives exactly the expected spans -- each
    layer's, ``embed``, ``head`` and ``greedy`` once -- each child inside
    its parent and the top-level spans inside the step's phase;
  * the drop counter equals ``(~moe.route(...).keep).sum()`` on the same
    input, and reads 0 where capacity cannot bind;
  * with no tracer nothing is armed, and the compiled key differs with
    spans on;
  * the serve's phases land in a ``torch.profiler`` trace as host ops.

The on-card half (spanned graphs against plain ones, a replay's
coverage by its top-level spans) is in ``test_torch_cuda.py``.
"""
import collections
import contextlib
import dataclasses

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro_torch import configs, obs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402
from repro_torch.obs import steps  # noqa: E402

BATCH, PROMPT, GEN = 2, 36, 3
ARCHS = ["hymba-1.5b", "granite-moe-3b-a800m"]
#: the spans of one layer of a decode step, by family
LAYER = {
    "hybrid": {"layer": 1, "norm": 2, "attention": 1, "attention.core": 1,
               "ssm": 1, "ffn": 1},
    "moe": {"layer": 1, "norm": 2, "attention": 1, "attention.core": 1,
            "ffn": 1, "moe.route": 1, "moe.dispatch": 1, "moe.experts": 1,
            "moe.combine": 1}}
#: each span's parent ("step": a top-level span)
PARENT = {"embed": "step", "layer": "step", "head": "step", "greedy": "step",
          "norm": "layer", "attention": "layer", "ssm": "layer",
          "ffn": "layer", "attention.core": "attention",
          "moe.route": "ffn", "moe.dispatch": "ffn", "moe.experts": "ffn",
          "moe.combine": "ffn"}


@pytest.fixture(autouse=True)
def _threads():
    """Two CPU threads a test: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _setup(arch: str, seed: int = 0):
    cfg = configs.get(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(seed))
    prompts = np.random.default_rng([36, seed]).integers(
        0, cfg.vocab_size, (BATCH, PROMPT))
    return cfg, model, params, prompts


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_are_the_same_with_and_without_spans(arch):
    cfg, model, params, prompts = _setup(arch)
    want = serve.serve_batch(cfg, params, prompts, gen_tokens=GEN,
                             model=model)
    trc = obs.Tracer()
    with obs.installed(trc):
        traced = serve.serve_batch(cfg, params, prompts, gen_tokens=GEN,
                                   model=model)
        eager = serve.serve_batch(cfg, params, prompts, gen_tokens=GEN,
                                  model=model, eager=True)
        cs = serve.CompiledServe(model, params, BATCH, PROMPT, PROMPT + GEN,
                                 torch.device("cpu"), spans=True)
        cs.load(prompts)
        with steps.recording(cs.spans[0]):
            cs.prefill(model)
        toks = []
        for _ in range(GEN):
            toks.append(cs.tok.clone())
            with steps.recording(cs.spans[1]):
                cs.decode(model)
    assert np.array_equal(traced, want) and np.array_equal(eager, want)
    assert np.array_equal(torch.stack(toks, 1).numpy(), want)
    assert trc.count("layer") == 2 * (1 + GEN) * cfg.n_layers
    assert [r[0] for r in cs.spans[1].regions].count("greedy") == 1


def _decode_step(trc, step: int) -> list:
    return [s for s in trc.spans
            if s.track == "decode" and s.attrs["step"] == step]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_step_records_each_span_inside_its_parent(arch):
    cfg, model, params, prompts = _setup(arch, seed=1)
    trc = obs.Tracer()
    with obs.installed(trc):
        serve.serve_batch(cfg, params, prompts, gen_tokens=GEN, model=model)
    spans = _decode_step(trc, 1)
    want = collections.Counter({k: v * cfg.n_layers
                                for k, v in LAYER[cfg.family].items()})
    want.update(embed=1, head=1, greedy=1)
    assert collections.Counter(s.name for s in spans) == want
    assert {s.attrs["layer"] for s in spans if s.name == "layer"} \
        == set(range(cfg.n_layers))
    phase, = [s for s in trc.spans if s.name == "serve.decode_step"
              and s.attrs["step"] == 1]
    for s in spans:
        assert s.t0 <= s.t1
        if PARENT[s.name] == "step":
            assert phase.t0 <= s.t0 and s.t1 <= phase.t1, s
            continue
        parents = [p for p in spans if p.name == PARENT[s.name]
                   and p.attrs.get("layer") == s.attrs["layer"]]
        assert len(parents) == 1, s
        assert parents[0].t0 <= s.t0 and s.t1 <= parents[0].t1, s
    got = steps.summary(trc)
    d = got[("decode", PROMPT, False)]
    assert d["steps"] == GEN and got[("prefill", PROMPT, False)]["steps"] == 1
    # the top-level spans follow one another inside the step
    assert sum(v for k, v in d["ms"].items() if k in steps.TOP) \
        <= d["step_ms"] * (1 + 1e-9)
    assert 0 < d["top_share"] <= 1


@pytest.mark.parametrize("factor, binds", [(0.5, True), (None, False)])
def test_the_drop_counter_counts_what_routing_drops(factor, binds):
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    # a capacity factor of n_experts gives every expert room for every
    # token: nothing can drop
    cfg = dataclasses.replace(cfg, capacity_factor=factor or cfg.n_experts)
    p = build(cfg).init(torch.Generator(device="cpu").manual_seed(3))[
        "layers"][0]["moe"]
    x = torch.randn((BATCH, PROMPT, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    keep = moe.route(p["router"], x, cfg).keep
    rec, trc = steps.StepSpans("cpu"), obs.Tracer()
    for _ in range(2):      # two runs: the buffer sums both
        with steps.recording(rec):
            moe.moe_ffn(p, x, cfg)
        rec.emit(trc, steps.Anchor(trc, "cpu"), "prefill")
    rec.take_counts(trc, "prefill")
    dropped = trc.metrics.value("moe_dropped_entries", phase="prefill")
    assert dropped == 2 * int((~keep).sum())
    assert trc.metrics.value("moe_routed_entries", phase="prefill") \
        == 2 * keep.numel()
    assert (dropped > 0) == binds
    assert [r[0] for r in rec.regions] == ["moe.route", "moe.dispatch",
                                           "moe.experts", "moe.combine"]
    rec.take_counts(trc, "prefill")       # read once: the buffer was zeroed
    assert trc.metrics.value("moe_dropped_entries", phase="prefill") \
        == dropped


def test_no_tracer_arms_nothing_and_spans_have_their_own_key(monkeypatch):
    cfg, model, params, prompts = _setup("granite-moe-3b-a800m", seed=2)

    def refuse(*a, **k):
        raise AssertionError("a span was recorded with no tracer installed")
    monkeypatch.setattr(steps.StepSpans, "open", refuse)
    monkeypatch.setattr(steps.StepSpans, "count", refuse)
    serve.serve_batch(cfg, params, prompts, gen_tokens=2, model=model)
    cs = serve.CompiledServe(model, params, BATCH, PROMPT, PROMPT + 2,
                             torch.device("cpu"))
    assert cs.spans is None
    cs.load(prompts)
    cs.prefill(model)
    cs.decode(model)
    assert steps.armed() is None
    key = serve.compiled_key(cfg, BATCH, PROMPT, PROMPT + 2)
    assert key == serve.compiled_key(cfg, BATCH, PROMPT, PROMPT + 2,
                                     spans=False)
    assert key != serve.compiled_key(cfg, BATCH, PROMPT, PROMPT + 2,
                                     spans=True)


def test_serve_phases_are_host_ranges_of_the_profiler():
    cfg, model, params, prompts = _setup("hymba-1.5b", seed=3)
    assert isinstance(steps.phase("serve.load"), contextlib.nullcontext)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        serve.serve_batch(cfg, params, prompts, gen_tokens=GEN, model=model)
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("serve.")]
    names = collections.Counter(e.name() for e in ranges)
    # host ops: a user annotation would be mirrored onto the device's
    # timeline, where the benchmark counts activity
    assert {e.activity_type() for e in ranges} == {"cpu_op"}
    assert names == {"serve.batch": 1, "serve.load": 1, "serve.prefill": 1,
                     "serve.decode_step": GEN, "serve.to_host": 1}
    trc = obs.Tracer()
    with obs.installed(trc):
        serve.serve_batch(cfg, params, prompts, gen_tokens=GEN, model=model)
    assert collections.Counter(s.name for s in trc.spans
                               if s.name.startswith("serve.")) == names
    batch, = [s for s in trc.spans if s.name == "serve.batch"]
    assert all(s.parent == batch.sid for s in trc.spans
               if s.name.startswith("serve.") and s is not batch)

"""The compiled mesh step's parts on the CPU: ``launch.train.CompiledTrain``
and ``launch.serve.CompiledServe`` over DTensor parameters and static
buffers placed on a mesh, run op by op (what a card captures once as a
CUDA graph and replays; gloo's collectives run on the host, so here
nothing is captured), against the eager mesh paths they stand in for.

Sharded runs use ``gloo`` ranks spawned by ``tests/torch_dist.py``, the
groups started at once (``spawn_all``): one rank for the (1, 1) mesh,
two for (2, 1), (1, 2) and the serves (whose group also runs the step
from the JAX package's parameters).

  * ``CompiledTrain``'s step over DTensor parameters, optimizer state and
    batch -- each step's batch copied into every rank's local rows --
    gives the loss, the global norm and every parameter and optimizer
    leaf of ``train_loop(..., mesh=..., eager=True)`` bit for bit at each
    of 3 steps, for reduced hymba (hybrid) and granite-moe (MoE) on (1,
    1) and (1, 2) (two micro-batches accumulated a step) and (2, 1)
    (one a step and shard, its gradients placed by ``placed_as``).
  * ``CompiledServe``'s prefill and tensor-``pos`` decode steps over its
    placed batch, cache (``cache_specs``) and ``tok`` give the eager mesh
    serve's tokens and logits bit for bit, twice over one set of buffers,
    on (1, 2) for the ``UNEVEN`` yi (the "groups" layout) and hymba (the
    "sequence" layout with the slot-split ring) and reduced whisper.
  * ``launch.mesh.compiled_route`` takes the eager route for a gloo
    mesh, the CPU and ``eager=True``; ``compiled_key`` tells a serve on a
    mesh from one without.
  * A step of one micro-batch (accum 1) on (2, 1) leaves every parameter
    and optimizer leaf on its specs' placements.
  * The compiled step on (1, 2) from the JAX package's parameters against
    the JAX package's jitted, donated ``train_loop`` on its local mesh:
    the three losses within ``RTOL`` relative.

The on-card half (captures and replays on a one-rank NCCL group) is in
``test_torch_cuda.py``.
"""
import importlib.util
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

RTOL = torch_dist.RTOL
ARCHS = ["hymba-1.5b", "granite-moe-3b-a800m"]
MESHES = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2)}
SERVED = ["yi-4q1kv", "hymba-5q1kv", "whisper-medium"]
#: the config held against the JAX package's train_loop
JAX_ARCH = "hymba-1.5b"


def _save_jax_params(path: str) -> None:
    """The JAX package's ``PRNGKey(0)`` parameters of reduced ``JAX_ARCH``
    (those its ``train_loop`` draws from seed 0) saved to ``path`` by
    "/"-joined key under "params/"."""
    import jax
    from repro import configs as jax_configs
    from repro.models import build as jax_build
    params = jax_build(jax_configs.get(JAX_ARCH).reduced()).init(
        jax.random.PRNGKey(0))
    flat = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{pre}/{k}" if pre else k)
        else:
            flat["params/" + pre] = np.asarray(t)
    walk(params, "")
    np.savez(path, **flat)


def _jax_losses() -> list:
    """The JAX package's ``train_loop`` (its jitted, donated step) of
    reduced ``JAX_ARCH`` from seed 0 over ``torch_dist.MESH_TRAIN``'s run
    on a one-device mesh: the losses."""
    import jax
    from repro import configs as jax_configs
    from repro.launch.mesh import make_mesh
    from repro.launch.train import train_loop
    from repro.optim import AdamWConfig
    opt = torch_dist._mesh_opt()
    _, history = train_loop(
        jax_configs.get(JAX_ARCH).reduced(),
        mesh=make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1]),
        seed=0, log_every=1000,
        opt_cfg=AdamWConfig(peak_lr=opt.peak_lr,
                            warmup_steps=opt.warmup_steps,
                            total_steps=opt.total_steps),
        **torch_dist.MESH_TRAIN)
    return history


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's rank-0 results, by mesh and "serves" (which also
    holds "jax_port", the compiled step on (1, 2) from the JAX package's
    parameters), and the JAX package's losses under "jax" (None where
    jax is not installed: that comparison skips, the rest runs).  The
    port's groups start at once; meanwhile the JAX package's parameters
    are saved (the serves' group reads them after its own runs) and its
    ``train_loop`` runs."""
    tmp = tmp_path_factory.mktemp("compiled_mesh")
    path = None
    if importlib.util.find_spec("jax") is not None:
        path = str(tmp / "jax_params.npz")
    groups = [("compiled_mesh_trains", 1, (1, 1)),
              ("compiled_mesh_trains", 2, (2, 1)),
              ("compiled_mesh_trains", 2, (1, 2)),
              ("compiled_mesh_serves", 2, path and (JAX_ARCH, path))]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(torch_dist.spawn_all, groups, tmp / "port")
        history = None
        if path is not None:
            part = str(tmp / "jax_params.part.npz")
            _save_jax_params(part)
            os.replace(part, path)     # whole when the group sees it
            history = _jax_losses()
        out = dict(zip(("1x1", "2x1", "1x2", "serves"), port.result()))
    out["jax"] = history
    return out


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_mesh_train_step_is_bitwise_the_eager_mesh_loop(runs, arch,
                                                                 mesh):
    compiled, eager = runs[mesh][arch]
    assert len(compiled) == len(eager) == torch_dist.MESH_TRAIN["steps"]
    for i, (c, e) in enumerate(zip(compiled, eager)):
        assert c[0] == e[0] and c[1] == e[1], (i, c[:2], e[:2])
        assert _same(c[2], e[2]), f"step {i + 1}: parameters"
        assert _same(c[3], e[3]), f"step {i + 1}: optimizer state"
    # the steps moved the parameters: a step that wrote nothing would
    # also be "equal" to itself
    assert not _same(compiled[0][2], compiled[-1][2])


@pytest.mark.parametrize("arch", SERVED)
def test_compiled_mesh_serve_is_bitwise_the_eager_mesh_serve(runs, arch):
    (tokens, logits, step), compiled, placed, pos = runs["serves"][arch]
    cfg = torch_dist.reduced(arch)
    assert step == "eager"            # gloo's route
    assert placed                     # batch, cache and tok as DTensors
    assert pos == serve.serve_inputs(cfg, torch.zeros(
        (2, 12), dtype=torch.int64))[1] + 4
    for toks, lgs in compiled:        # two serves over one set of buffers
        assert np.array_equal(toks, tokens)
        assert _same(lgs, logits)


def test_route_is_eager_on_gloo_the_cpu_and_eager_true(runs):
    card_no_mesh, card_gloo, card_eager, cpu = runs["serves"]["route"]
    assert card_no_mesh
    assert not (card_gloo or card_eager or cpu)


def test_a_step_of_one_micro_batch_keeps_the_state_on_its_specs(runs):
    """At accum 1 on (2, 1) the gradients are brought to their
    parameters' placements (``steps.placed_as``), as the accumulator does
    at accum > 1: no parameter or optimizer leaf leaves its specs (a
    replicated leaf's state went ``Partial`` and, at hymba's full width
    on 4 ranks, non-finite)."""
    off, losses = runs["serves"]["accum_one"]
    assert off == []
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_compiled_key_tells_a_mesh_serve_from_one_without():
    cfg = configs.get("yi-6b").reduced()
    mesh = types.SimpleNamespace(shape=(1, 2), mesh_dim_names=("data",
                                                               "model"))
    other = types.SimpleNamespace(shape=(2, 1), mesh_dim_names=("data",
                                                                "model"))
    keys = {serve.compiled_key(cfg, 2, 12, 16, m)
            for m in (None, mesh, other)}
    assert len(keys) == 3
    assert serve.compiled_key(cfg, 2, 12, 16) == \
        serve.compiled_key(cfg, 2, 12, 16, None)


def test_compiled_mesh_train_step_matches_the_jax_jitted_train_loop(runs):
    if runs["jax"] is None:
        pytest.skip("jax is not installed")
    got = [row[0] for row in runs["serves"]["jax_port"]]
    want = runs["jax"]
    assert len(got) == len(want) == torch_dist.MESH_TRAIN["steps"]
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= RTOL * abs(b), (i, a, b)

"""Multi-rank runs of the port on the CPU for the tests: ``spawn`` starts
``world`` processes joined by a ``gloo`` group (a ``FileStore`` under
the test's temporary directory, a 60 s timeout), runs one scenario of
this module in each and returns rank 0's result, joining every process
within a deadline and killing what is left.  Each scenario builds its
own mesh; the results are numpy arrays and Python numbers.  A rank fails
if any functional collective it issued was never waited for (the work
registry is not empty at the scenario's end).

Imported by the spawned ranks, so nothing here runs at import.
"""
from __future__ import annotations

import datetime
import os
import queue
import traceback

import numpy as np

#: float32 models (``ModelConfig.reduced``): 1e-4 of the largest magnitude,
#: as ``tests/test_torch_train.py``
RTOL = 1e-4


def spawn(scenario: str, world: int, tmp_path, *args, deadline: float = 240):
    """Rank 0's result of ``scenario(rank, world, *args)`` run on
    ``world`` gloo ranks; raises with every failing rank's traceback."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{scenario}-{world}")
    procs = [ctx.Process(target=_rank_main,
                         args=(scenario, r, world, store, q, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, value = q.get(timeout=deadline)
            (results.__setitem__(rank, value) if ok
             else errors.append(f"rank {rank}:\n{value}"))
    except queue.Empty:
        errors.append(f"{scenario}: no result within {deadline} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return results[0]


def _rank_main(scenario, rank, world, store, q, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        out = globals()[scenario](rank, world, *args)
        # every functional collective the scenario issued was waited for:
        # over NCCL a result read unwaited is a race
        unwaited = torch._C._distributed_c10d._get_work_registry_size()
        if unwaited:
            raise AssertionError(f"{scenario}: {unwaited} functional "
                                 f"collectives never waited for")
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- helpers ------------------------------------------------------------------

#: reduced configs whose head counts a 2-wide ``model`` axis does not
#: divide, by name: hymba's shape (5 query heads, 1 kv head, a window of
#: 8 below the 16 served positions -- a ring cache -- the SSM branch and
#: an odd vocabulary, as hymba's 32 001: the sequence layout, the
#: slot-split ring, the split SSM decode and the head on split tokens)
#: and a dense one (4 query heads, 1 kv head, a linear cache: the groups
#: layout and the slot-split linear cache)
UNEVEN = {"hymba-5q1kv": ("hymba-1.5b", dict(n_heads=5, n_kv_heads=1,
                                              window=8, vocab_size=255)),
          "yi-4q1kv": ("yi-6b", dict(n_kv_heads=1))}


def reduced(arch: str):
    """The reduced config of ``arch``, or of an ``UNEVEN`` name."""
    import dataclasses
    from repro_torch import configs
    if arch in UNEVEN:
        base, kw = UNEVEN[arch]
        return dataclasses.replace(configs.get(base).reduced(), **kw)
    return configs.get(arch).reduced()

def full(t):
    """A (possibly DTensor) tensor as a numpy array."""
    from repro_torch.distributed import sharding
    t = t.full_tensor() if sharding.is_dtensor(t) else t
    return t.detach().numpy()


def leaf_arrays(tree) -> list:
    from repro_torch.optim.adamw import leaves
    return [full(t) for t in leaves(tree) if hasattr(t, "shape")]


def train_one(arch: str, steps: int, mesh=None, *, global_batch: int = 8,
              seq_len: int = 32, micro_per_shard: int = 2, **kw):
    """``train_loop`` on a reduced ``arch``: (losses, each step's global
    norm, the last parameters as numpy arrays)."""
    from repro_torch.launch.train import train_loop
    cfg = reduced(arch)
    norms, last = [], {}

    def on_step(i, m):
        norms.append(float(full(m["grad_norm"])))
        last["params"] = m["params"]
    _, history = train_loop(cfg, steps=steps, global_batch=global_batch,
                            seq_len=seq_len, micro_per_shard=micro_per_shard,
                            device="cpu", mesh=mesh, on_step=on_step,
                            log_every=1000, **kw)
    return history, norms, leaf_arrays(last["params"])


#: every mesh this process made: DTensor's cached sharding propagation
#: may hand back an earlier mesh of the same shape, whose groups a
#: ``CollectiveLog`` must name too
_MADE: list = []


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    _MADE.append(make_mesh(shape, axes))
    return _MADE[-1]


# -- scenarios ----------------------------------------------------------------

def train_step(rank, world, arch, shape):
    """One sharded train step of a reduced ``arch`` on a ``shape`` mesh."""
    return train_one(arch, 1, _mesh(shape))


def moe_mesh_path(rank, world, shape):
    """The MoE mesh path of reduced granite on a ``shape`` mesh (plain
    tensors in, as serving gives them; then DTensors with a backward):
    (y, aux, the mesh-path calls, the gradients)."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    g = torch.Generator().manual_seed(0)
    params = moe.init(g, cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    mesh = _mesh(shape)
    moe.reset_mesh_calls()
    with sharding.mesh_context(mesh):
        y, aux = moe.moe_ffn(params, x, cfg)
        whole = (Replicate(),) * mesh.ndim
        ps = {k: distribute_tensor(v, mesh, whole, src_data_rank=None)
              .requires_grad_(True) for k, v in params.items()}
        xd = distribute_tensor(x, mesh, whole, src_data_rank=None) \
            .requires_grad_(True)
        y2, aux2 = moe.moe_ffn(ps, xd, cfg)
        ((y2 * y2).sum() + aux2).backward()
    grads = {k: full(v.grad) for k, v in ps.items()}
    grads["x"] = full(xd.grad)
    return (y.numpy(), float(aux), moe.mesh_calls(), full(y2), grads)


def decode_seq_sharded(rank, world, arch, shape, prompt, gen):
    """Prefill and ``gen`` decode steps of a reduced ``arch`` with the
    parameters placed by ``params_specs`` and the cache by
    ``cache_specs`` (sequence-sharded when ``model`` does not divide the
    kv heads): every step's logits and the cache's k placements."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import build
    cfg = configs.get(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mesh = _mesh(shape)
    rng = np.random.default_rng(0)
    b = 2
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt)))
    batch, pos, enc_len = serve_inputs(cfg, tokens)
    cache = model.init_cache(b, prompt + gen, enc_len, device="cpu")
    params = elastic.place(params, mesh, sharding.params_specs(params, mesh))
    cache = elastic.place(cache, mesh, sharding.cache_specs(cache, cfg, mesh))
    batch = elastic.place(batch, mesh, sharding.batch_specs(
        batch, mesh, accum_dim=False))
    where = str(tuple(cache[0]["k"].placements))
    out = []
    with sharding.mesh_context(mesh), torch.no_grad():
        lg, cache = model.prefill(params, batch, cache)
        out.append(full(lg))
        tok = full(lg).argmax(-1)
        for i in range(gen):
            step = elastic.place({"t": torch.from_numpy(tok)}, mesh,
                                 sharding.batch_specs({"t": tok}, mesh,
                                                      accum_dim=False))
            lg, cache = model.decode(params, step["t"], pos + i, cache)
            out.append(full(lg))
            tok = out[-1].argmax(-1)
    return out, where


def elastic_drill(rank, world, ckpt_dir, steps, resume, shape):
    """The reference's shrink-and-resume drill on reduced mamba2-130m:
    train to ``steps`` on a ``shape`` mesh with checkpoints every 3 steps
    (resuming from ``ckpt_dir`` when asked), every run on the schedule of
    a 10-step job; the losses of the steps run."""
    from repro_torch.optim import AdamWConfig
    history, _, _ = train_one(
        "mamba2-130m", steps, _mesh(shape), seq_len=64,
        micro_per_shard=1, ckpt_dir=ckpt_dir, ckpt_interval=3,
        resume=resume, seed=5,
        opt_cfg=AdamWConfig(total_steps=10, warmup_steps=1))
    return history


def geometry_flush(rank, world, n_requests):
    """A seeded mixed workload flushed by a CPU ``GeometryServer`` under a
    (world, 1) mesh (every rank the same submissions): every result and
    projective mask, in submission order, and the launches."""
    from repro_torch import serving
    from repro_torch.distributed import sharding
    from repro_torch.serving import workload
    reqs = workload.random_workload(seed=3, n_requests=n_requests)
    srv = serving.GeometryServer(device="cpu")
    with sharding.mesh_context(_mesh((world, 1))):
        for chain, pts in reqs:
            srv.submit(chain, pts)
        results = srv.flush()
    return flush_arrays(results)


def flush_arrays(results) -> list:
    """A flush's results as plain arrays, a projective one's mask after
    its points."""
    out = []
    for r in results:
        out.append(np.asarray(r).copy())
        if getattr(r, "mask", None) is not None:
            out.append(np.asarray(r.mask).copy())
    return out


def pod_sync(rank, world, grads_by_rank, shape):
    """``pod_sync_int8`` on a (pod, data, model) mesh, each pod rank with
    its own gradients: (the synced gradients, the new errors)."""
    import torch
    from repro_torch.distributed import compression
    mesh = _mesh(shape, ("pod", "data", "model"))
    g = {k: torch.from_numpy(v) for k, v in grads_by_rank[rank].items()}
    err = compression.init_error_state(g)
    out, new_err = compression.pod_sync_int8(g, err, mesh)
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in new_err.items()})


def four_ranks(rank, world, ckpt_dir):
    """Everything the tests run on 4 ranks, in one group: a train step
    of reduced hymba and of reduced granite on (2, 2); a decode of reduced
    yi-6b on (1, 4), where ``model`` does not divide its 2 kv heads (a
    sequence-sharded cache); the drill's first 6 steps on (4, 1)."""
    return {
        "hymba": train_step(rank, world, "hymba-1.5b", (2, 2)),
        "granite": train_step(rank, world, "granite-moe-3b-a800m", (2, 2)),
        "decode": decode_seq_sharded(rank, world, "yi-6b", (1, 4), 12, 4),
        "drill": elastic_drill(rank, world, ckpt_dir, 6, False, (4, 1)),
    }


def two_ranks(rank, world, ckpt_dir):
    """Everything the tests run on 2 ranks: the MoE mesh path on (1, 2);
    the drill resumed from the 4-rank checkpoints to step 10 on (2, 1),
    and the same 10 steps uninterrupted; a geometry mesh flush on
    (2, 1)."""
    return {
        "moe": moe_mesh_path(rank, world, (1, 2)),
        "resumed": elastic_drill(rank, world, ckpt_dir, 10, True, (2, 1)),
        "straight": elastic_drill(rank, world, None, 10, False, (2, 1)),
        "flush": geometry_flush(rank, world, 48),
    }


# -- tensor parallelism over "model" ------------------------------------------

class CollectiveLog:
    """A dispatch mode recording every functional collective as (kind,
    the mesh dim names of its group) -- ``model``, ``data`` -- so a test
    tells a ``model`` all-reduce from a ``data`` one; ``shapes`` holds
    each call's input shape, in the same order."""

    def __init__(self, mesh):
        self.groups = {m.get_group(n).group_name: n
                       for m in (*_MADE, mesh) for n in m.mesh_dim_names
                       if m.size(m.mesh_dim_names.index(n)) > 1}
        self.calls: list = []
        self.shapes: list = []

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        log = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kind = func.__name__.split(".")[0]
                if func.namespace == "_c10d_functional" and kind not in (
                        "wait_tensor", "_wrap_tensor_autograd"):
                    group = [a for a in args if isinstance(a, str)][-1]
                    log.calls.append((kind, log.groups.get(group, group)))
                    log.shapes.append(tuple(getattr(args[0], "shape", ())))
                return func(*args, **(kwargs or {}))
        self._mode = Mode()
        self._mode.__enter__()
        del torch
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    def count(self, kind: str, axis: str) -> int:
        return sum(1 for k, a in self.calls if k.startswith(kind)
                   and a == axis)


def serve_split(rank, world, arch, shape, prompt, gen, n_seq=2,
                log_decode=False):
    """``serve_batch`` of a reduced ``arch`` (or an ``UNEVEN`` name) with
    the parameters placed by ``params_specs`` on a ``shape`` mesh,
    ``n_seq`` prompts: the tokens, every step's logits, the cache's k
    placements and the collectives of the prefill (by kind and axis).
    ``log_decode``: then also ``gen`` greedy decode steps after that
    prefill, their collectives with each call's input shape, and the
    local shapes of every projection weight, cache leaf and SSM state
    shard a rank holds."""
    import torch
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    cfg = reduced(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mesh = _mesh(shape)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (n_seq, prompt)).astype(np.int32)
    params = elastic.place(params, mesh, sharding.params_specs(params, mesh))
    trace, log = {}, CollectiveLog(mesh)
    with sharding.mesh_context(mesh), torch.no_grad():
        with log:     # the prefill alone (one decode step would follow)
            from repro_torch.launch.serve import serve_inputs
            batch, _, enc_len = serve_inputs(cfg, torch.from_numpy(
                prompts).long())
            cache = model.init_cache(
                n_seq, prompt + (gen if log_decode else 1), enc_len,
                device="cpu")
            cache = elastic.place(cache, mesh, sharding.cache_specs(
                cache, cfg, mesh))
            batch = elastic.place(batch, mesh, sharding.batch_specs(
                batch, mesh, accum_dim=False))
            lg, cache = model.prefill(params, batch, cache)
        if log_decode:
            from repro_torch.models.layers import greedy
            dec = CollectiveLog(mesh)
            with dec:       # greedy: no logit is gathered
                tok = greedy(lg)
                for i in range(gen):
                    lg, cache = model.decode(params, tok, prompt + i, cache)
                    tok = greedy(lg)
        c0 = cache[0]["attn"] if cfg.family == "hybrid" else cache[0]
        k = c0["self"]["k"] if cfg.is_encdec else c0["k"]
        tokens = serve_batch(cfg, params, prompts, gen_tokens=gen,
                             model=model, trace=trace)
    out = (tokens, [full(x) for x in trace["logits"]],
           str(tuple(k.placements)), log.calls)
    if not log_decode:
        return out
    names = ("wq", "wk", "wv", "wo", "in_proj", "out_proj")
    held = {tuple(t.to_local().shape) for lp in params["layers"]
            for sub in lp.values() if isinstance(sub, dict)
            for n, t in sub.items() if n in names}
    from repro_torch.optim.adamw import leaves
    held |= {tuple(t.to_local().shape) for t in leaves(cache)
             if t.dim() > 1}
    return out + (list(zip(dec.calls, dec.shapes)), held)


def split_argmax(rank, world, rows):
    """``layers.greedy`` of ``rows`` (numpy, (B, V)) split over ``model``
    on a (1, world) mesh, bit for bit, and the gathered argmax."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.layers import greedy
    mesh = _mesh((1, world))
    x = distribute_tensor(torch.from_numpy(rows), mesh,
                          (Replicate(), Shard(1)), src_data_rank=None)
    return full(greedy(x)), full(x).argmax(-1)


def serve_reference_params(rank, world, name, shape, path):
    """``serve_batch`` of an ``UNEVEN`` config on a ``shape`` mesh with
    the JAX package's parameters and prompts from the npz at ``path``
    (its parameters by "/"-joined key under "params/", "prompts", and
    "tokens" for the generated length): the tokens and every step's
    logits."""
    import torch
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    cfg = reduced(name)
    params = _reference_params(name, path)
    with np.load(path) as z:
        prompts, gen = z["prompts"], z["tokens"].shape[1]
    mesh = _mesh(shape)
    params = elastic.place(params, mesh, sharding.params_specs(params, mesh))
    trace = {}
    with sharding.mesh_context(mesh), torch.no_grad():
        tokens = serve_batch(cfg, params, prompts, gen_tokens=gen,
                             model=build(cfg), trace=trace)
    return tokens, [full(x) for x in trace["logits"]]


def tp_two_ranks(rank, world, jax_ref):
    """Everything the tensor-parallel tests run on (1, 2): train steps of
    reduced yi-6b, granite-moe-3b-a800m and whisper-medium and of the two
    ``UNEVEN`` configs, ``serve_batch`` of the ``UNEVEN`` configs with
    their decode's collectives, the planted argmax ties, and, unless it
    is None, ``jax_ref`` = (an ``UNEVEN`` name, the npz of the JAX
    package's serve of it) served with the JAX package's parameters."""
    ties = np.zeros((4, 8), np.float32)
    ties[0, [2, 5]] = 3.0            # one in each shard: the lower wins
    ties[1, [5, 6]] = 2.0            # two in the second shard
    ties[2, [0, 1, 3]] = -1.0        # all but one at -1, max 0 at 2, 4..7
    ties[3] = np.arange(8)[::-1]     # the max alone, in the first shard
    out = {
        "yi": train_step(rank, world, "yi-6b", (1, 2)),
        "granite": train_step(rank, world, "granite-moe-3b-a800m", (1, 2)),
        "whisper": train_step(rank, world, "whisper-medium", (1, 2)),
        "argmax": split_argmax(rank, world, ties),
        **uneven(rank, world, (1, 2)),
    }
    if jax_ref:
        out["jax_" + jax_ref[0]] = serve_reference_params(
            rank, world, jax_ref[0], (1, 2), jax_ref[1])
    return out


def uneven(rank, world, shape) -> dict:
    """A train step and a logged serve of each ``UNEVEN`` config on a
    ``shape`` mesh, by name and "serve_" + name."""
    out = {}
    for name in UNEVEN:
        out[name] = train_step(rank, world, name, shape)
        out["serve_" + name] = serve_split(rank, world, name, shape, 12, 4,
                                           log_decode=True)
    return out


def tp_four_ranks(rank, world):
    """Everything the tensor-parallel tests run on (2, 2): train steps of
    the three reduced archs; ``serve_batch`` (a prefill and 4 decode
    steps) of reduced yi-6b and whisper-medium against a head-sharded
    cache, and of one yi-6b prompt, a batch the data axis does not
    divide; the ``UNEVEN`` configs' train steps and logged serves."""
    return {
        "yi": train_step(rank, world, "yi-6b", (2, 2)),
        "granite": train_step(rank, world, "granite-moe-3b-a800m", (2, 2)),
        "whisper": train_step(rank, world, "whisper-medium", (2, 2)),
        "serve_yi": serve_split(rank, world, "yi-6b", (2, 2), 12, 4),
        "serve_whisper": serve_split(rank, world, "whisper-medium", (2, 2),
                                     12, 4),
        "serve_yi_one": serve_split(rank, world, "yi-6b", (2, 2), 12, 4, 1),
        **uneven(rank, world, (2, 2)),
    }


# -- the compiled mesh step ---------------------------------------------------

#: the compiled mesh train step's run: 3 steps, 4 rows of 32 tokens, two
#: rows a micro-batch and shard (2 micro-batches accumulated where "data"
#: is 1, one where it is 2), a warmup over two steps (every step's
#: learning rate differs)
MESH_TRAIN = dict(steps=3, global_batch=4, seq_len=32, micro_per_shard=2)


def _mesh_opt():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                       total_steps=MESH_TRAIN["steps"])


def compiled_train_rows(cfg, mesh, params=None, seed: int = 0) -> list:
    """``launch.train.CompiledTrain`` over DTensor parameters, optimizer
    state and batch on ``mesh``, placed as ``train_loop`` places them, its
    step run op by op over the static buffers (what a card captures once
    and replays) for ``MESH_TRAIN``'s steps: each step's (loss, global
    norm, every parameter and optimizer leaf as numpy arrays).
    ``params``: the initial parameters (by default ``Model.init``'s from
    ``seed``, as ``train_loop``'s)."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.train import CompiledTrain, _host_batch
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    run = MESH_TRAIN
    model = build(cfg)
    accum = elastic.replan_accum(run["global_batch"], run["micro_per_shard"],
                                 mesh)
    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq_len"],
        global_batch=run["global_batch"], seed=seed, frontend=cfg.frontend,
        n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model))
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed))
    opt_state = adamw_init(params)
    pspecs = sharding.params_specs(params, mesh)
    params = elastic.place(params, mesh, pspecs)
    opt_state = elastic.place(opt_state, mesh,
                              sharding.opt_specs(opt_state, pspecs))
    ct = CompiledTrain(model, _mesh_opt(), accum, params, opt_state, mesh)
    rows = []
    with sharding.mesh_context(mesh):
        for step in range(run["steps"]):
            ct.load(_host_batch(data, step, accum,
                                run["global_batch"] // accum))
            out = ct.run()
            rows.append((float(full(out["loss"])),
                         float(full(out["grad_norm"])),
                         [a.copy() for a in leaf_arrays(ct.params)],
                         [a.copy() for a in leaf_arrays(ct.opt_state)]))
    assert ct.params is params and all(
        sharding.is_dtensor(t) for t in ct.batch.values())
    return rows


def eager_train_rows(cfg, mesh) -> list:
    """``train_loop(..., mesh=mesh, eager=True)`` on ``MESH_TRAIN``'s run:
    each step's (loss, global norm, parameters, optimizer leaves), as
    ``compiled_train_rows`` (each step's are new tensors)."""
    from repro_torch.launch.train import train_loop
    rows, trace = [], {}

    def on_step(i, m):
        rows.append((m["loss"], float(full(m["grad_norm"])),
                     leaf_arrays(m["params"]), leaf_arrays(m["opt_state"])))
    train_loop(cfg, device="cpu", mesh=mesh, on_step=on_step,
               log_every=1000, opt_cfg=_mesh_opt(), eager=True, trace=trace,
               **MESH_TRAIN)
    assert trace["step"] == "eager"
    return rows


def compiled_mesh_train(rank, world, arch, shape):
    """A reduced ``arch`` on a ``shape`` mesh: (the compiled step's rows,
    the eager loop's rows)."""
    cfg = reduced(arch)
    mesh = _mesh(shape)
    return compiled_train_rows(cfg, mesh), eager_train_rows(cfg, mesh)


def compiled_mesh_serve(rank, world, arch, shape, prompt=12, gen=4):
    """``serve_batch`` of a reduced ``arch`` (or an ``UNEVEN`` name) with
    DTensor parameters under ``mesh_context`` of a ``shape`` gloo mesh --
    the eager route -- and ``launch.serve.CompiledServe``'s prefill and
    tensor-``pos`` decode steps over its placed static buffers, twice
    (the cache reset in place): (the eager tokens and logits, each
    compiled serve's tokens and logits, the static buffers' placements
    against the eager serve's specs)."""
    import torch
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.serve import CompiledServe, serve_batch
    from repro_torch.models import build
    cfg = reduced(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mesh = _mesh(shape)
    params = elastic.place(params, mesh, sharding.params_specs(params, mesh))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    trace = {}
    with sharding.mesh_context(mesh), torch.no_grad():
        tokens = serve_batch(cfg, params, prompts, gen_tokens=gen,
                             model=model, trace=trace)
        cs = CompiledServe(model, params, 2, prompt, prompt + gen,
                           torch.device("cpu"), mesh)
        runs = []
        for _ in range(2):
            cs.load(prompts)
            logits, toks = [full(cs.prefill(model))], []
            for _ in range(gen):
                toks.append(full(cs.tok).copy())
                logits.append(full(cs.decode(model)))
            runs.append((np.stack(toks, 1).astype(np.int32), logits))
    cache_specs = sharding.sanitize_specs(
        cs.cache, sharding.cache_specs(cs.cache, cfg, mesh), mesh)
    from repro_torch.optim.adamw import leaves
    placed = all(sharding.is_dtensor(t) and tuple(t.placements)
                 == sharding.placements(s, mesh) for t, s in
                 zip(leaves(cs.cache), _spec_leaves(cache_specs)))
    placed &= sharding.is_dtensor(cs.tok) and not sharding.is_dtensor(
        cs.pos) and all(sharding.is_dtensor(t) for t in cs.batch.values())
    return ((tokens, [full(x) for x in trace["logits"]], trace["step"]),
            runs, placed, int(cs.pos))


def _spec_leaves(tree) -> list:
    """The specs (tuples) of a spec tree, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tree]


def route_cases(rank, world):
    """``launch.mesh.compiled_route`` under this gloo world: (parameters
    on the card with no mesh, on a gloo mesh, with ``eager=True``; the
    CPU's parameters with no mesh), a card's parameters stood in for by
    their device alone."""
    import types
    import torch
    from repro_torch.launch.mesh import compiled_route
    card = {"embed": types.SimpleNamespace(device=torch.device("cuda", 0))}
    cpu = {"embed": torch.zeros(1)}
    mesh = _mesh((world, 1))
    return (compiled_route(card, None, False), compiled_route(card, mesh, False),
            compiled_route(card, None, True), compiled_route(cpu, None, False))


def compiled_mesh_trains(rank, world, shape):
    """The train step of reduced hymba and granite on a ``shape`` mesh, by
    arch."""
    return {arch: compiled_mesh_train(rank, world, arch, shape)
            for arch in ("hymba-1.5b", "granite-moe-3b-a800m")}


def jax_port_rows(arch: str, path: str, shape) -> list:
    """The compiled step's rows (``compiled_train_rows``) of a reduced
    ``arch`` on a ``shape`` mesh from the JAX package's parameters in the
    npz at ``path`` (``_reference_params``), once the file is there (the
    caller writes it meanwhile)."""
    import time
    waited = time.monotonic() + 120
    while not os.path.exists(path):
        if time.monotonic() > waited:
            raise TimeoutError(f"{path} was not written within 120 s")
        time.sleep(0.2)
    return compiled_train_rows(reduced(arch), _mesh(shape),
                               _reference_params(arch, path))


def compiled_mesh_serves(rank, world, jax_run=None):
    """The rest of the compiled-mesh tests, on 2 ranks: the route
    predicate, a step at accum 1 on (2, 1) (``accum_one_placements``),
    the serves of the two ``UNEVEN`` configs (yi's "groups", hymba's
    "sequence" with the slot-split ring) and of reduced whisper on (1,
    2), and with ``jax_run`` = (arch, npz path) the compiled step on (1,
    2) from the JAX package's parameters (``jax_port_rows``)."""
    out = {"route": route_cases(rank, world),
           "accum_one": accum_one_placements(rank, world)}
    for arch in ("yi-4q1kv", "hymba-5q1kv", "whisper-medium"):
        out[arch] = compiled_mesh_serve(rank, world, arch, (1, 2))
    if jax_run is not None:
        out["jax_port"] = jax_port_rows(*jax_run, (1, world))
    return out


def accum_one_placements(rank, world, arch="hymba-1.5b"):
    """One eager ``train_loop`` step of a reduced ``arch`` with one
    micro-batch (accum 1) on a (world, 1) mesh, where autograd leaves a
    replicated parameter's gradient ``Partial`` over "data": (the names
    of the parameter and optimizer leaves whose placements left
    ``params_specs``' / ``opt_specs``', the loss)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.train import train_loop
    cfg = reduced(arch)
    mesh = _mesh((world, 1))
    off, losses = [], []

    def on_step(i, m):
        losses.append(m["loss"])
        pspecs = sharding.sanitize_specs(
            m["params"], sharding.params_specs(m["params"], mesh), mesh)
        for key, tree in (("params", m["params"]),
                          *((k, m["opt_state"][k])
                            for k in ("master", "m", "v"))):
            sharding.tree_map_with_path(
                lambda path, t, spec, key=key: off.append(f"{key}/{path}")
                if tuple(t.placements) != sharding.placements(spec, mesh)
                else None, tree, pspecs)
    train_loop(cfg, steps=1, global_batch=world, seq_len=32,
               micro_per_shard=1, device="cpu", mesh=mesh, on_step=on_step,
               log_every=1000, eager=True)
    return off, losses


def spawn_all(runs: list, tmp_path, deadline: float = 240) -> list:
    """``spawn`` of each (scenario, world, *args) in ``runs`` at once, one
    thread and one store directory under ``tmp_path`` each: their rank-0
    results in order."""
    from concurrent.futures import ThreadPoolExecutor
    dirs = [os.path.join(str(tmp_path), f"run{i}") for i in range(len(runs))]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = [pool.submit(spawn, name, world, d, *args,
                               deadline=deadline)
                   for d, (name, world, *args) in zip(dirs, runs)]
        return [f.result() for f in futures]


def _reference_params(arch: str, path: str) -> dict:
    """The port's parameters of a reduced ``arch`` from an npz of the JAX
    package's, by "/"-joined key under "params/"."""
    from repro_torch.convert import model_params_from_reference
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("params/"):
                *outer, leaf = key.split("/")[1:]
                node = tree
                for k in outer:
                    node = node.setdefault(k, {})
                node[leaf] = z[key]
    return model_params_from_reference(reduced(arch), tree, device="cpu")

"""Multi-rank runs of the port on the CPU for the tests: ``spawn`` starts
``world`` processes joined by a ``gloo`` group (a ``FileStore`` under
the test's temporary directory, a 60 s timeout), runs one scenario of
this module in each and returns rank 0's result, joining every process
within a deadline and killing what is left.  Each scenario builds its
own mesh; the results are numpy arrays and Python numbers.

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
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- helpers ------------------------------------------------------------------

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
    from repro_torch import configs
    from repro_torch.launch.train import train_loop
    cfg = configs.get(arch).reduced()
    norms, last = [], {}

    def on_step(i, m):
        norms.append(float(full(m["grad_norm"])))
        last["params"] = m["params"]
    _, history = train_loop(cfg, steps=steps, global_batch=global_batch,
                            seq_len=seq_len, micro_per_shard=micro_per_shard,
                            device="cpu", mesh=mesh, on_step=on_step,
                            log_every=1000, **kw)
    return history, norms, leaf_arrays(last["params"])


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes)


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
    tells a ``model`` all-reduce from a ``data`` one."""

    def __init__(self, mesh):
        self.groups = {mesh.get_group(n).group_name: n
                       for n in mesh.mesh_dim_names if mesh.size(
                           mesh.mesh_dim_names.index(n)) > 1}
        self.calls: list = []

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


def serve_split(rank, world, arch, shape, prompt, gen, n_seq=2):
    """``serve_batch`` of a reduced ``arch`` with the parameters placed by
    ``params_specs`` on a ``shape`` mesh, ``n_seq`` prompts: the tokens,
    every step's logits, the cache's k placements and the collectives of
    the prefill (by kind and axis)."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    cfg = configs.get(arch).reduced()
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
            cache = model.init_cache(n_seq, prompt + 1, enc_len,
                                     device="cpu")
            cache = elastic.place(cache, mesh, sharding.cache_specs(
                cache, cfg, mesh))
            batch = elastic.place(batch, mesh, sharding.batch_specs(
                batch, mesh, accum_dim=False))
            lg, cache = model.prefill(params, batch, cache)
        k = cache[0]["self"]["k"] if cfg.is_encdec else cache[0]["k"]
        tokens = serve_batch(cfg, params, prompts, gen_tokens=gen,
                             model=model, trace=trace)
    return (tokens, [full(x) for x in trace["logits"]],
            str(tuple(k.placements)), log.calls)


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


def tp_two_ranks(rank, world):
    """Everything the tensor-parallel tests run on (1, 2): train steps of
    reduced yi-6b, granite-moe-3b-a800m and whisper-medium, and the
    planted argmax ties."""
    ties = np.zeros((4, 8), np.float32)
    ties[0, [2, 5]] = 3.0            # one in each shard: the lower wins
    ties[1, [5, 6]] = 2.0            # two in the second shard
    ties[2, [0, 1, 3]] = -1.0        # all but one at -1, max 0 at 2, 4..7
    ties[3] = np.arange(8)[::-1]     # the max alone, in the first shard
    return {
        "yi": train_step(rank, world, "yi-6b", (1, 2)),
        "granite": train_step(rank, world, "granite-moe-3b-a800m", (1, 2)),
        "whisper": train_step(rank, world, "whisper-medium", (1, 2)),
        "argmax": split_argmax(rank, world, ties),
    }


def tp_four_ranks(rank, world):
    """Everything the tensor-parallel tests run on (2, 2): train steps of
    the three reduced archs; ``serve_batch`` (a prefill and 4 decode
    steps) of reduced yi-6b and whisper-medium against a head-sharded
    cache, and of one yi-6b prompt, a batch the data axis does not
    divide."""
    return {
        "yi": train_step(rank, world, "yi-6b", (2, 2)),
        "granite": train_step(rank, world, "granite-moe-3b-a800m", (2, 2)),
        "whisper": train_step(rank, world, "whisper-medium", (2, 2)),
        "serve_yi": serve_split(rank, world, "yi-6b", (2, 2), 12, 4),
        "serve_whisper": serve_split(rank, world, "whisper-medium", (2, 2),
                                     12, 4),
        "serve_yi_one": serve_split(rank, world, "yi-6b", (2, 2), 12, 4, 1),
    }

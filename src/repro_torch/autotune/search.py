"""On-device search: candidate generation -> analytic prune -> timer -> cache.

The port of ``repro/autotune/search.py``, with its discipline for every
tunable kernel:

  1. enumerate a small closed candidate space (the chain kernels' block
     threads and grid waves, ``matmul_2d``'s wgmma tile width and ring
     stages, ``rmsnorm_2d``'s warps a row, the serving-grid knobs);
  2. prune it with the analytic cost model (``costmodel``) -- infeasible
     candidates (shared memory, registers, block size) die here, and only
     the ``keep`` cheapest survive to be timed;
  3. time the survivors through the SAME public op entry production uses
     (``config=``), the default always first;
  4. keep the default configuration unless a candidate beats it by more
     than the noise floor, and persist the winner to the tuning cache.

The timer is the card's: a kernel's candidate is the minimum of ``iters``
CUDA-event windows after one warm-up call, the device spinning while the
host enqueues so the window holds the kernel alone; a serving-grid
candidate is the wall clock of ``srv.serve(reqs)`` up to
``torch.cuda.synchronize()``, because the grid trades host launches
against device bytes.  On the CPU (``device="cpu"``) the clock is
``time.perf_counter``.  Every ``tune_*`` runs on ``device`` (the GPU
unless the caller asks for the CPU) through the backend that device
resolves to: the kernels on CUDA, never the plain version in their
place.

Every ``tune_*`` entry accepts ``measure=`` -- a ``cfg -> seconds``
callable replacing the timer -- which is how the determinism tests make
"same inputs -> same winners file" a hard property (and how a
cost-model-only tuning mode works: pass the prediction as the measure).
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from repro_torch.autotune import costmodel
from repro_torch.autotune.cache import DEFAULTS, KernelConfig, TuningCache
from repro_torch.kernels import dispatch

#: a candidate must beat the default by this fraction to replace it --
#: below the floor, timer noise would make winners flap run to run.
NOISE_FLOOR = 0.03
#: GPU cycles (~1 ms) the device spins before each timed window, so the
#: host's cost of enqueueing the call stays out of it
SPIN_CYCLES = 2_000_000


# -- candidate spaces ---------------------------------------------------------

def chain_candidates(kernel: str) -> list[KernelConfig]:
    """Single-chain kernels and the scalar batch kernels: threads a block
    x grid waves."""
    return [KernelConfig(kernel, block_threads=bt, waves=w,
                         source="candidate")
            for bt in (128, 256, 512)
            for w in (1, 2, 4)]


def chain_batch_candidates(kernel: str, vectors: bool = True
                           ) -> list[KernelConfig]:
    """Batched chain kernels: grid waves where the bucket takes the
    16-byte kernel (its block is no knob: it sizes the kernel's shared
    staging), the scalar kernel's threads x waves otherwise."""
    if not vectors:
        return chain_candidates(kernel)
    return [KernelConfig(kernel, waves=w, source="candidate")
            for w in (1, 2, 4, 8)]


def matmul_candidates() -> list[KernelConfig]:
    """``matmul_2d``'s wgmma regime: tile width x ring stages."""
    return [KernelConfig("matmul", bn=bn, stages=s, source="candidate")
            for bn in (64, 128) for s in (3, 4, 6)]


def rmsnorm_candidates() -> list[KernelConfig]:
    """``rmsnorm_2d``'s 16-byte kernel: warps a row (the prune drops the
    counts whose lanes cannot hold the row)."""
    return [KernelConfig("rmsnorm", row_warps=w, source="candidate")
            for w in (1, 2, 4, 8, 16, 32)]


def grid_candidates() -> list[KernelConfig]:
    """Serving size grid: floor x waste cap.  Coarser floors merge small
    size classes (fewer launches, more padding); tighter caps refine the
    grid (more launches, less padded traffic)."""
    return [KernelConfig("serving_grid", grid_min_len=m, grid_waste_cap=c,
                         source="candidate")
            for m in (4, 8, 16, 32, 64)
            for c in (0.125, 0.25, 0.5)]


_SINGLE = ("chain_diag", "chain_apply", "chain_project", "chain_diag_q",
           "chain_apply_q")
_BATCH = ("chain_diag_batch", "chain_apply_batch", "chain_project_batch",
          "chain_diag_batch_q", "chain_apply_batch_q")


def candidates_for(kernel: str) -> list[KernelConfig]:
    """The candidate space of a tunable kernel (a batch kernel's: its
    16-byte kernel's)."""
    if kernel in _SINGLE:
        return chain_candidates(kernel)
    if kernel in _BATCH:
        return chain_batch_candidates(kernel)
    if kernel == "matmul":
        return matmul_candidates()
    if kernel == "rmsnorm":
        return rmsnorm_candidates()
    if kernel == "serving_grid":
        return grid_candidates()
    raise ValueError(f"no candidate space for kernel {kernel!r}")


# -- the timer ----------------------------------------------------------------

def _time_best(fn: typing.Callable[[], typing.Any], iters: int,
               device: torch.device) -> float:
    """Best-of-``iters`` seconds of ``fn()`` after one warm-up call: CUDA
    events around the call on the card (the device spinning while the
    host enqueues it), the host clock on the CPU."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _time_serve(serve: typing.Callable[[], typing.Any], iters: int,
                device: torch.device) -> float:
    """Best-of-``iters`` wall seconds of ``serve()`` after one warm-up
    call, the device synchronised before the clock stops."""
    serve()
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        serve()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass(frozen=True)
class TrialResult:
    """One timed candidate: its seconds and its predicted microseconds."""
    config: KernelConfig
    seconds: float
    predicted_us: float


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """One tuning decision: the winner plus every timed trial (the CLI
    prints these; ``chip_smoke.py`` records tuned-vs-default from them)."""
    kernel: str
    backend: str
    dtype: str
    n: int
    winner: KernelConfig
    trials: tuple[TrialResult, ...]

    @property
    def default_seconds(self) -> float:
        """The default config's time."""
        return self.trials[0].seconds      # default is always trial 0

    @property
    def winner_seconds(self) -> float:
        """The winner's time."""
        key = self.winner.key_fields()
        return min(t.seconds for t in self.trials
                   if t.config.key_fields() == key)


def _is_default(kernel: str, cfg: KernelConfig) -> bool:
    return cfg.key_fields() == DEFAULTS[kernel].key_fields()


def _run_trials(kernel: str, backend: str, dtype: str, n: int,
                candidates: list[KernelConfig],
                cost_fn: typing.Callable[[KernelConfig], typing.Any],
                measure: typing.Callable[[KernelConfig], float],
                *, keep: int, cache: TuningCache | None) -> TuneReport:
    """Prune -> time (default always first) -> pick -> cache."""
    survivors = costmodel.prune(candidates, cost_fn, keep)
    default = DEFAULTS[kernel]
    trials_cfgs = [default] + [c for c in survivors
                               if not _is_default(kernel, c)]
    trials = tuple(TrialResult(c, measure(c), cost_fn(c).predicted_us)
                   for c in trials_cfgs)
    # incumbent scan: a candidate must beat the current best by the noise
    # floor to take over, so the default survives timer noise and ties
    # resolve to the deterministically-first (cheapest-predicted) survivor
    best = trials[0]
    for t in trials[1:]:
        if t.seconds < best.seconds * (1.0 - NOISE_FLOOR):
            best = t
    # a default that merely kept its seat stays labelled "default" -- only
    # a candidate that actually beat it earns "tuned"
    winner = dataclasses.replace(
        best.config, source="tuned" if best is not trials[0] else "default")
    if cache is not None:
        cache.put(kernel, backend, dtype, n, winner)
    return TuneReport(kernel, backend, dtype, n, winner, trials)


# -- per-kernel tuners --------------------------------------------------------

def _ref_ignores_launch_knobs(kernel: str, backend: str, measure) -> bool:
    """True when searching would time identical code: the ``ref`` backend
    is the plain version and never reads the launch knobs, so on it a
    wall-clock search over kernel configs caches nothing but timer noise
    -- the winner is pinned to the default instead.  An injected
    ``measure`` (tests, cost-model-only tuning) overrides this."""
    return measure is None and backend == "ref" and kernel != "serving_grid"


def _resolve(device, backend: str | None) -> tuple[torch.device, str]:
    dev = torch.device(device)
    return dev, dispatch.backend_for(dev, backend)


_KIND = {"chain_diag": "diag", "chain_apply": "matrix",
         "chain_project": "projective", "chain_diag_q": "diag_q",
         "chain_apply_q": "matrix_q", "chain_diag_batch": "diag",
         "chain_apply_batch": "matrix", "chain_project_batch": "projective",
         "chain_diag_batch_q": "diag_q", "chain_apply_batch_q": "matrix_q"}


def _chain_entry(kernel: str, backend: str, dev: torch.device, shape: tuple,
                 dtype: str) -> typing.Callable[[KernelConfig], typing.Any]:
    """``cfg -> result`` of the public op entry of a chain kernel (single
    or batched, by ``shape``'s rank) on seeded inputs of ``shape`` made
    on ``dev`` (standard normal points; parameters from numpy seed 0).
    Fixed-point kernels take their points quantised to ``dtype``'s
    format, so the tuner measures the lane it ships; the projective ones
    draw the served traffic's homographies (``workload.random_projective``)."""
    from repro_torch import kernels, quantize
    from repro_torch.serving import workload
    kind = _KIND[kernel]
    d = shape[-1]
    lead = shape[:1] if len(shape) == 3 else ()
    batched = bool(lead)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=dev)

    def tensor(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    if kind in ("diag_q", "matrix_q"):
        fmt = quantize.as_qformat(dtype)
        pq = fmt.quantize_torch(x)
        t = tensor(fmt.quantize(rng.uniform(-1, 1, lead + (d,))),
                   torch.int16)
        if kind == "diag_q":
            s = tensor(fmt.quantize(rng.uniform(0.5, 2.0, lead + (d,))),
                       torch.int16)
            op = kernels.chain_diag_batch_q if batched \
                else kernels.chain_diag_q
            return lambda cfg: op(pq, s, t, n_frac=fmt.n, backend=backend,
                                  config=cfg)
        a = tensor(fmt.quantize(rng.standard_normal(lead + (d, d))),
                   torch.int16)
        op = kernels.chain_apply_batch_q if batched else kernels.chain_apply_q
        return lambda cfg: op(pq, a, t, n_frac=fmt.n, backend=backend,
                              config=cfg)
    if kind == "diag":
        s = tensor(rng.uniform(0.5, 2.0, lead + (d,)))
        t = tensor(rng.uniform(-1, 1, lead + (d,)))
        op = kernels.chain_diag_batch if batched else kernels.chain_diag
        return lambda cfg: op(x, s, t, backend=backend, config=cfg)
    if kind == "matrix":
        a = tensor(rng.standard_normal(lead + (d, d)))
        t = tensor(rng.uniform(-1, 1, lead + (d,)))
        op = kernels.chain_apply_batch if batched else kernels.chain_apply
        return lambda cfg: op(x, a, t, backend=backend, config=cfg)
    h = tensor(np.stack([workload.random_projective(rng, d)
                         for _ in range(lead[0] if lead else 1)]))
    if not batched:
        h = h[0]
    # the bounds as tensors on the device: a Python float would be copied
    # to the card inside every timed call
    lo, hi = tensor(np.full(lead + (d,), -4.0)), tensor(np.full(lead + (d,),
                                                               4.0))
    op = kernels.chain_project_batch if batched else kernels.chain_project
    return lambda cfg: op(x, h, lo, hi, backend=backend, config=cfg)


def tune_chain(kernel: str, backend: str | None = None, *, n_points: int,
               d: int = 2, dtype: str = "float32",
               device: str | torch.device = "cuda",
               cache: TuningCache | None = None,
               measure: typing.Callable[[KernelConfig], float] | None = None,
               keep: int = 4, iters: int = 3) -> TuneReport:
    """Tune a single-chain kernel (``chain_diag`` / ``chain_apply`` /
    ``chain_project`` or their ``_q`` fixed-point twins) at one
    (points, dim) shape through the public op entry.  Fixed-point kernels
    cache under the Qm.n format name as the dtype (pass e.g.
    ``dtype="q8.7"``)."""
    dev, b = _resolve(device, backend)
    candidates = [] if _ref_ignores_launch_knobs(kernel, b, measure) \
        else candidates_for(kernel)
    if measure is None:
        entry = _chain_entry(kernel, b, dispatch.resolve_device(dev),
                             (n_points, d), dtype)
        measure = lambda cfg: _time_best(lambda: entry(cfg), iters, dev)
    cost = lambda cfg: costmodel.chain_cost(n_points, d, _KIND[kernel], cfg)
    return _run_trials(kernel, b, dtype, n_points, candidates, cost,
                       measure, keep=keep, cache=cache)


def tune_chain_batch(kernel: str, backend: str | None = None, *, bsz: int,
                     lpad: int, d: int = 2, dtype: str = "float32",
                     device: str | torch.device = "cuda",
                     cache: TuningCache | None = None,
                     measure: typing.Callable[[KernelConfig], float] | None
                     = None, keep: int = 4, iters: int = 3) -> TuneReport:
    """Tune a batched chain kernel (``chain_*_batch`` and their ``_q``
    twins) at one packed (B, L, d) bucket through the public op entry.
    The candidates are the 16-byte kernel's waves where the bucket takes
    it (``costmodel.batch_takes_vectors``), else the scalar kernel's
    threads x waves; the winner caches under B * L, the size class the
    serving engine looks a bucket's config up by."""
    dev, b = _resolve(device, backend)
    kind = _KIND[kernel]
    candidates = [] if _ref_ignores_launch_knobs(kernel, b, measure) \
        else chain_batch_candidates(
            kernel, costmodel.batch_takes_vectors(kind, lpad, d))
    if measure is None:
        entry = _chain_entry(kernel, b, dispatch.resolve_device(dev),
                             (bsz, lpad, d), dtype)
        measure = lambda cfg: _time_best(lambda: entry(cfg), iters, dev)
    cost = lambda cfg: costmodel.packed_chain_cost(bsz, lpad, d, kind, cfg)
    return _run_trials(kernel, b, dtype, bsz * lpad, candidates, cost,
                       measure, keep=keep, cache=cache)


def tune_serving_grid(reqs, backend: str | None = None, *,
                      device: str | torch.device = "cuda",
                      cache: TuningCache | None = None,
                      measure: typing.Callable[[KernelConfig], float] | None
                      = None, keep: int = 4, iters: int = 2) -> TuneReport:
    """Tune the serving size grid (floor + waste cap) on one workload:
    ``reqs`` is the ``[(chain, points), ...]`` list the GeometryServer
    serves.  The analytic prune replays the engine's bucketing per
    candidate; the timer serves the real workload under each survivor on
    ``device``.  The winner is cached at the workload's largest request
    length (the size-class convention grid consumers look up by), so
    grids tuned at different traffic scales coexist in one cache."""
    dev, b = _resolve(device, backend)
    shape = costmodel.workload_shape(reqs)
    n = workload_size_class_n(reqs)
    if measure is None:
        from repro_torch import serving
        dispatch.resolve_device(dev)

        def measure(cfg: KernelConfig) -> float:
            srv = serving.GeometryServer(device=dev, backend=b,
                                         min_len=cfg.grid_min_len,
                                         waste_cap=cfg.grid_waste_cap)
            return _time_serve(lambda: srv.serve(reqs), iters, dev)
    default = DEFAULTS["serving_grid"]
    cost = lambda cfg: costmodel.grid_cost(
        shape,
        cfg.grid_min_len if cfg.grid_min_len is not None
        else default.grid_min_len,
        cfg.grid_waste_cap if cfg.grid_waste_cap is not None
        else default.grid_waste_cap)
    return _run_trials("serving_grid", b, "float32", n,
                       candidates_for("serving_grid"), cost, measure,
                       keep=keep, cache=cache)


def _dense(rng, shape, dtype: str, dev) -> torch.Tensor:
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(getattr(torch, dtype))


def tune_matmul(backend: str | None = None, *, m: int, k: int, n: int,
                dtype: str = "bfloat16", device: str | torch.device = "cuda",
                cache: TuningCache | None = None,
                measure: typing.Callable[[KernelConfig], float] | None = None,
                keep: int = 4, iters: int = 3) -> TuneReport:
    """Tune ``matmul_2d``'s wgmma regime (bfloat16, K or N > 8) at one
    (M, K, N) through ``kernels.matmul(..., config=)``."""
    dev, b = _resolve(device, backend)
    candidates = [] if _ref_ignores_launch_knobs("matmul", b, measure) \
        else candidates_for("matmul")
    if measure is None:
        from repro_torch import kernels
        rng = np.random.default_rng(0)
        dispatch.resolve_device(dev)
        x, y = _dense(rng, (m, k), dtype, dev), _dense(rng, (k, n), dtype, dev)
        measure = lambda cfg: _time_best(
            lambda: kernels.matmul(x, y, backend=b, config=cfg), iters, dev)
    itemsize = 2 if dtype == "bfloat16" else 4
    cost = lambda cfg: costmodel.matmul_cost(m, k, n, cfg, itemsize=itemsize)
    return _run_trials("matmul", b, dtype, m * n, candidates, cost,
                       measure, keep=keep, cache=cache)


def tune_rmsnorm(backend: str | None = None, *, m: int, n: int,
                 dtype: str = "float32", device: str | torch.device = "cuda",
                 cache: TuningCache | None = None,
                 measure: typing.Callable[[KernelConfig], float] | None = None,
                 keep: int = 3, iters: int = 3) -> TuneReport:
    """Tune ``rmsnorm_2d``'s 16-byte kernel at one (M, N) through
    ``kernels.rmsnorm(..., config=)``."""
    dev, b = _resolve(device, backend)
    candidates = [] if _ref_ignores_launch_knobs("rmsnorm", b, measure) \
        else candidates_for("rmsnorm")
    if measure is None:
        from repro_torch import kernels
        rng = np.random.default_rng(0)
        dispatch.resolve_device(dev)
        x = _dense(rng, (m, n), dtype, dev)
        g = torch.ones(n, dtype=torch.float32, device=dev)
        measure = lambda cfg: _time_best(
            lambda: kernels.rmsnorm(x, g, backend=b, config=cfg), iters, dev)
    itemsize = 2 if dtype == "bfloat16" else 4
    cost = lambda cfg: costmodel.rmsnorm_cost(m, n, cfg, itemsize=itemsize)
    return _run_trials("rmsnorm", b, dtype, m * n, candidates, cost,
                       measure, keep=keep, cache=cache)


# -- the smoke search (two small chain shapes + the serving grid) -------------

SMOKE_SEED = 1234             #: workload seed shared with --check re-runs
SMOKE_REQUESTS = 24
SMOKE_MAX_POINTS = 96
#: the benchmark-scale workload (the JAX package's, shared with its
#: benchmarks/autotune_bench.py: tune where you serve -- a grid tuned on
#: small traffic does not transfer to large traffic, so both scales get
#: their own cache entry)
BENCH_SEED = 1904
BENCH_REQUESTS = 64
BENCH_MAX_POINTS = 1024


def workload_size_class_n(reqs) -> int:
    """The n a workload's grid entry is cached/looked up under: the
    largest request length (point count) in the mix."""
    return max((int(p.size // c.dim) for c, p in reqs), default=0)


def smoke_workload():
    """The JAX package's 24-request smoke mix (seed 1234)."""
    from repro_torch.serving import workload
    return workload.random_workload(seed=SMOKE_SEED,
                                    n_requests=SMOKE_REQUESTS,
                                    max_points=SMOKE_MAX_POINTS,
                                    templates=workload.TEMPLATES[:4])


def bench_workload():
    """The JAX package's 64-request benchmark-scale mix (seed 1904)."""
    from repro_torch.serving import workload
    return workload.random_workload(seed=BENCH_SEED,
                                    n_requests=BENCH_REQUESTS,
                                    max_points=BENCH_MAX_POINTS)


def smoke_search(backend: str | None = None, *,
                 device: str | torch.device = "cuda",
                 cache: TuningCache | None = None,
                 measure: typing.Callable[[KernelConfig], float] | None = None,
                 iters: int = 3) -> tuple[TuningCache, list[TuneReport]]:
    """The JAX package's pruned smoke search at its shapes: three small
    chain shapes (diagonal 3D, general 2D, projective 3D), the
    fixed-point twins of the affine two (int16 q8.7 -- cached under the
    format name as the dtype), plus the serving grid on BOTH seeded
    workloads (the tiny smoke mix and the benchmark-scale 64-request
    mix -- each caches at its own size class).  Returns the populated
    cache and the per-kernel reports."""
    cache = cache if cache is not None else TuningCache()
    kw = dict(device=device, cache=cache, measure=measure)
    reports = [
        tune_chain("chain_diag", backend, n_points=2048, d=3, iters=iters,
                   **kw),
        tune_chain("chain_apply", backend, n_points=2048, d=2, iters=iters,
                   **kw),
        tune_chain("chain_project", backend, n_points=2048, d=3,
                   iters=iters, **kw),
        tune_chain("chain_diag_q", backend, n_points=2048, d=3,
                   dtype="q8.7", iters=iters, **kw),
        tune_chain("chain_apply_q", backend, n_points=2048, d=2,
                   dtype="q8.7", iters=iters, **kw),
        tune_serving_grid(smoke_workload(), backend,
                          iters=max(1, iters - 1), **kw),
        tune_serving_grid(bench_workload(), backend,
                          iters=max(2, iters - 1), **kw),
    ]
    return cache, reports

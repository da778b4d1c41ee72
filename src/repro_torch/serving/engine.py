"""GeometryServer: plan-bucketed batched serving of transform chains.

The port of ``repro/serving/engine.py``.  Dispatching each request through
``TransformChain.apply`` pays one kernel launch per request; this engine
is the server loop, built from the paper's M1 execution discipline:

  1. **Bucket** -- pending requests group by
     ``(TransformChain.structure, backend, dtype, padded_length)``, where
     a fixed-point request's dtype is its format name (a float-submitted
     and an int16-submitted q8.7 request pack into one int16 batch).
     Structure + backend pick one cached batch plan; the size-bucketing
     policy (``bucketing.padded_length``) picks the padded length so the
     padding waste per request stays below the cap.
  2. **Pack** -- each bucket's variable-length point sets pad and stack
     into one (B, L, d) batch in pinned host memory, and each request's
     host fold (computed once at submit, the SAME numpy fold ``apply``
     uses) stacks into the batch parameters.
  3. **Launch** -- the whole bucket runs as ONE kernel launch
     (``kernels.chain_diag_batch`` / ``chain_apply_batch`` /
     ``chain_project_batch`` -- the last for projective viewing chains,
     whose per-point cull mask comes back as ``Projected.mask``).  Buckets
     whose packed batch exceeds ``max_points_per_launch`` split into
     shards along the batch axis.
  4. **Overlap** -- the frame-buffer set-0/set-1 discipline on the GPU:
     each launch's pinned host buffers are copied to the device on a side
     stream (set 1, the DMA filling), the compute stream waits on a CUDA
     event before the kernel (set 0, the array computing), and the
     device buffers are ``record_stream``-ed to the compute stream.  So
     bucket k+1's copy overlaps bucket k's kernel.  Each launch's result
     comes back in ONE device->host copy into pinned memory (a projective
     launch adds a second copy for its mask); unpacking is numpy slicing,
     and results are numpy arrays, as in the reference.

Equality contract: a request's fold is bit-identical however it is
dispatched (one shared host fold), and every kernel and plain version
runs the per-request arithmetic in separately rounded ops in one order.
So packed results equal per-request ``apply``/``project`` BITWISE on
every plan kind, masks included, on the card and on the CPU, and padded
rows never touch payload rows.

The fixed-point lane: ``submit(..., qformat="q8.7")`` packs int16 Qm.n
words (float points quantised at pack time, int16 points taken as words)
with each fold quantised by ``quantize.quantize_fold``, and runs the
int16 batch kernels; results come back dequantised float32 for float
submissions and int16 for int16 ones, bitwise equal to per-request
``apply(dtype=...)``.  ``FaultConfig.on_q_overflow`` decides what happens
to a request whose fold ``quantize.fits`` says would wrap: reroute it to
the float lane (the default, counted in ``q_fallbacks``), reject it with
``QRangeError``, or serve the wrapped words.

Fault tolerance, as in the reference: ``submit`` is the validation
boundary (malformed requests raise the typed ``errors`` taxonomy at
intake), and ``flush`` contains failures per LAUNCH.  A launch that
raises, or whose output fails the corruption check, is set aside; every
other launch completes; then each failed group walks a recovery ladder
of (1) bounded-exponential-backoff retries, (2) backend degradation
(``dispatch.fallback_ladder``: the CUDA kernel, then the plain version
on the same device, which stands in only after injected faults) and (3)
bisection, which quarantines a poison request in O(log B) launches.  A
request whose singleton launch still fails resolves to a typed
``LaunchError`` in its result slot.  Every
step is counted (``stats``, the server's ``metrics``, ``BucketReport``)
and traced (``obs.trace``); ``serving.faults`` injects deterministic
faults through the hooks below to drive it.  On a CUDA server, an
exception that is neither injected nor a detected corruption is checked
with ``torch.cuda.synchronize``: a device fault that broke the context
re-raises instead of being turned into a flush of ``LaunchError``s.

Autotune, as in the reference: the size grid resolves through
``bucketing.grid_for`` at every flush (explicit knobs, else the tuning
cache when ``repro_torch.autotune`` is enabled, else the defaults), each
bucket's kernel takes the cached launch knobs for its size class, and
every ``launch`` trace instant carries the config's source, the kernel
and the cost model's prediction (``autotune.costmodel.predict_launch``).

``submit_scene`` serves a scene node's points through the scene's cached
world fold (``repro_torch.scene``), which ``validate(fold=)`` injects in
place of ``chain.fold()``: the same buckets, kernels and checks as
``submit(scene.world_chain(name), ...)``, and bitwise the same results.
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from repro_torch import errors, quantize
from repro_torch.autotune import cache as tuning
from repro_torch.core import transform_chain as tc
from repro_torch.distributed import sharding
from repro_torch.kernels import (chain_apply_batch, chain_apply_batch_q,
                                 chain_diag_batch, chain_diag_batch_q,
                                 chain_project_batch, dispatch, opcount)
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serving import bucketing
from repro_torch.serving import errors as serrors

#: serving statistics (observable by tests, benchmarks and the driver):
#:   plan_compiles -- batched plans built (one per distinct structure+backend)
#:   plan_hits     -- plans served from the cache
#:   traces        -- jit traces in the JAX package; 0 here (eager PyTorch)
#:   launches      -- batched kernel launches DISPATCHED (shards, retries and
#:                    recovery launches included; injector-blocked attempts
#:                    are not -- they never reached the device)
#:   requests      -- requests served through flush()
#:   buckets       -- plan buckets executed
#:   shards        -- extra launches from splitting oversized buckets
#:   payload_points / padded_points -- real vs padded points moved
#: fault-tolerance counters (all deterministic under a seeded injector):
#:   rejected_requests  -- submissions refused with a typed RequestError
#:   q_fallbacks        -- q-lane requests rerouted to float32 because the
#:                         error bound predicted int16 wrap
#:   launch_failures    -- launch attempts that failed (injected or real)
#:   retries            -- re-attempts of a failing launch on the same rung
#:   backend_fallbacks  -- launches that succeeded on a degraded backend
#:   bisections         -- failing groups split in half to isolate poison
#:   recovered_requests -- requests that resolved OK after >= 1 failure
#:   failed_requests    -- requests resolved to a typed LaunchError
#: continuous-batching counters (incremented by serving.async_engine;
#: always 0 on the synchronous path):
#:   admitted_requests      -- requests past the admission gates
#:   queue_full_rejections  -- typed QueueFullError backpressure refusals
#:   rate_limit_rejections  -- typed RateLimitError token-bucket refusals
_STAT_KEYS = ("plan_compiles", "plan_hits", "traces", "launches",
              "requests", "buckets", "shards",
              "payload_points", "padded_points",
              "rejected_requests", "q_fallbacks", "launch_failures",
              "retries", "backend_fallbacks", "bisections",
              "recovered_requests", "failed_requests",
              "admitted_requests", "queue_full_rejections",
              "rate_limit_rejections")

#: the keys above that count SERVER activity (everything except the plan
#: cache, which is module-global like the cache it counts): each
#: GeometryServer keeps its own registry of these, and the module view
#: is their explicit cross-server aggregate
_SERVER_KEYS = tuple(k for k in _STAT_KEYS
                     if k not in ("plan_compiles", "plan_hits", "traces"))

#: the process-wide aggregate registry behind the module ``stats`` view
#: (``obs.export.prometheus_text(REGISTRY)`` is the exposition entry point)
REGISTRY = obsm.MetricsRegistry("serving")

#: the module view: a MutableMapping over REGISTRY counters with plain
#: dict semantics -- ``stats["launches"]`` reads, ``+=`` and resets
stats = obsm.StatsView(REGISTRY, _STAT_KEYS)

_BATCH_PLANS: dict[tuple, "BatchPlan"] = {}


def reset_stats() -> None:
    """Zero the module counters.  They are GLOBAL (shared by every server
    in the process), so ``stats["launches"] == sum(r.launches for r in
    server.reports)`` holds only for one server whose lifetime starts at
    the reset -- ``GeometryServer.reset_stats()`` resets both at once."""
    for k in stats:
        stats[k] = 0


def clear_plan_cache() -> None:
    """Drop all batch plans (benchmarks use this for cold timings)."""
    _BATCH_PLANS.clear()


class Projected(np.ndarray):
    """A projective request's serving result: the projected points as a
    plain ndarray (shape-compatible with ``TransformChain.apply``
    everywhere), with the per-point frustum-cull mask attached as
    ``.mask`` (bool, the request's leading shape; True = inside).  The
    mask rides along so existing consumers that treat results as arrays
    keep working unchanged.  ``.mask`` describes EXACTLY the array
    ``flush`` returned: derived arrays (slices, transposes, sorts, any
    indexing -- same-shaped or not) read ``.mask`` as ``None`` rather
    than inheriting a mask whose rows may no longer line up with
    theirs.  Slice the mask alongside the points instead:
    ``pts[sel], res.mask[sel]``."""

    def __array_finalize__(self, obj):
        # derived arrays NEVER inherit: a shape check cannot detect
        # same-shape reorderings (r[::-1], fancy indexing), so the only
        # honest mask is the one _projected() attaches explicitly
        self._mask = None

    @property
    def mask(self) -> np.ndarray | None:
        """The cull mask ``_projected()`` attached, or None on a view."""
        return self._mask

    @mask.setter
    def mask(self, value: np.ndarray | None) -> None:
        """Attach a cull mask (only ``_projected()`` should set this)."""
        self._mask = value


def _projected(points: np.ndarray, mask: np.ndarray) -> Projected:
    out = np.ascontiguousarray(points).view(Projected)
    out.mask = mask
    return out


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """A bucket executor: ``fn(folded_batch, pts3) -> out``, where
    ``folded_batch`` stacks the bucket's host-folded per-request
    parameters as tensors on the points' device -- (s (B,d), t (B,d)),
    (A (B,d,d), t (B,d)) or (H (B,d+1,d+1), lo (B,d), hi (B,d)).
    Projective plans return ``(projected (B,L,d), inside (B,L))``.
    Fixed-point plans (``qformat`` set) take int16 Qm.n words -- each
    request's fold quantised by ``quantize.quantize_fold`` at pack time
    -- and return int16."""
    kind: str                      # "diag" | "matrix" | "projective"
    dim: int
    backend: str
    fn: typing.Callable
    qformat: str | None = None     # Qm.n name for fixed-point plans


#: plan kind -> the batch kernel family the tuning cache keys it by
_KERNEL_BY_KIND = {"diag": "chain_diag_batch",
                   "matrix": "chain_apply_batch",
                   "projective": "chain_project_batch"}


def _batch_config(kernel: str, backend: str, dtype: str,
                  pts3: torch.Tensor) -> tuning.KernelConfig:
    """A bucket launch's knobs: the tuning cache's winner for the packed
    (B, L) size class when autotuning is enabled, else the defaults (the
    reference looks them up at trace time, the port at every launch).
    Knobs steer the grid only: every config gives the same bits."""
    return tuning.config_for(kernel, backend, dtype,
                             pts3.shape[0] * pts3.shape[1])


def _compile_batch_q(structure: tuple, backend: str,
                     qname: str) -> BatchPlan:
    """A fixed-point bucket executor: the int16 batch kernels with the
    format's fraction count as the requantising shift and the format's
    cached launch knobs.  Projective structures never get here
    (``submit`` rejects chain + qformat)."""
    dim, _ = structure
    kind = tc.plan_kind_of(structure)
    fmt = quantize.as_qformat(qname)
    if kind == "diag":
        def fn(folded, pts3):
            """Q-format diagonal transform over a (B, L) bucket."""
            s, t = folded
            cfg = _batch_config("chain_diag_batch_q", backend, fmt.name,
                                pts3)
            return chain_diag_batch_q(pts3, s, t, n_frac=fmt.n,
                                      backend=backend, config=cfg)
    else:
        def fn(folded, pts3):
            """Q-format matrix transform over a (B, L) bucket."""
            a, t = folded
            cfg = _batch_config("chain_apply_batch_q", backend, fmt.name,
                                pts3)
            return chain_apply_batch_q(pts3, a, t, n_frac=fmt.n,
                                       backend=backend, config=cfg)
    return BatchPlan(kind=kind, dim=dim, backend=backend, fn=fn,
                     qformat=fmt.name)


def _compile_batch(structure: tuple, backend: str) -> BatchPlan:
    dim, _ = structure
    kind = tc.plan_kind_of(structure)
    kernel = _KERNEL_BY_KIND[kind]
    if kind == "diag":
        def fn(folded, pts3):
            """Diagonal transform over a (B, L) bucket."""
            s, t = folded
            cfg = _batch_config(kernel, backend,
                                tuning.dtype_name(pts3.dtype), pts3)
            return chain_diag_batch(pts3, s, t, backend=backend, config=cfg)
    elif kind == "matrix":
        def fn(folded, pts3):
            """Matrix transform over a (B, L) bucket."""
            a, t = folded
            cfg = _batch_config(kernel, backend,
                                tuning.dtype_name(pts3.dtype), pts3)
            return chain_apply_batch(pts3, a, t, backend=backend, config=cfg)
    else:
        def fn(folded, pts3):
            """Projective transform + cull over a (B, L) bucket."""
            h, lo, hi = folded
            cfg = _batch_config(kernel, backend,
                                tuning.dtype_name(pts3.dtype), pts3)
            return chain_project_batch(pts3, h, lo, hi, backend=backend,
                                       config=cfg)
    return BatchPlan(kind=kind, dim=dim, backend=backend, fn=fn)


def get_batch_plan(structure: tuple, backend: str,
                   qname: str | None = None) -> BatchPlan:
    """The cached batch plan for ``structure`` on ``backend`` (``qname``
    selects the fixed-point lane: a distinct plan, as a distinct dtype
    would be); mirrors ``transform_chain._get_plan`` and counts into the
    serving stats, with a ``plan.compile`` or ``plan.hit`` instant when a
    tracer is installed.  ``backend="ref"`` on a CUDA server's tensors is
    the plain version on the card: the recovery ladder's last rung."""
    key = (structure, backend, qname)
    plan = _BATCH_PLANS.get(key)
    trc = obst.active()
    if plan is None:
        stats["plan_compiles"] += 1
        if trc.enabled:
            trc.instant("plan.compile", cache="serving",
                        structure=_structure_tag(structure),
                        backend=backend, q=qname)
        plan = _BATCH_PLANS[key] = \
            _compile_batch_q(structure, backend, qname) \
            if qname is not None else _compile_batch(structure, backend)
    else:
        stats["plan_hits"] += 1
        if trc.enabled:
            trc.instant("plan.hit", cache="serving",
                        structure=_structure_tag(structure),
                        backend=backend, q=qname)
    return plan


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Recovery policy knobs for one ``GeometryServer`` (the JAX
    package's fields, defaults and validation).

    ``max_launch_attempts`` bounds the attempts of a failing launch group
    on each rung of the ladder, the first included; before every attempt
    after a failure the engine sleeps ``backoff_base_s * backoff_factor
    ** (k - 1)`` seconds, capped at ``backoff_cap_s``, where k counts the
    group's failures so far (``backoff_base_s=0.0`` sleeps not at all).
    When a rung's attempts are spent the group degrades to the next rung
    of ``dispatch.fallback_ladder``, then bisects; a group whose kernel
    rung failed other than by an injected fault bisects without
    degrading, so the plain version never hides a failing kernel.

    ``validate_finite`` gates the NaN/Inf checks at submit.
    ``validate_outputs`` gates the check of every float, non-projective
    launch output (on the launch's device, one flag a packed row): a
    launch with any non-finite row raises ``CorruptionError`` as a whole
    -- its inputs were finite at submit -- and recovers like any failed
    launch, re-packed from the clean host copies.  A request whose output
    is non-finite on every attempt (an overflow) is isolated by
    bisection and resolves to a ``LaunchError`` carrying its ticket.

    ``on_q_overflow`` decides what happens when ``quantize.fits`` says a
    q-lane request would wrap int16:

      * ``"fallback"`` (default) -- serve the request through the float32
        lane instead (int16 submissions come back requantised int16, so
        the caller's contract holds); counted in ``stats["q_fallbacks"]``
        and ``BucketReport.q_fallback_requests``.
      * ``"reject"``  -- raise ``QRangeError`` at submit.
      * ``"wrap"``    -- the M1's semantics: no check, arithmetic wraps.
    """
    max_launch_attempts: int = 3   # per ladder rung, first attempt included
    backoff_base_s: float = 0.002  # sleep before retry k: base * factor**k
    backoff_factor: float = 2.0
    backoff_cap_s: float = 0.25
    validate_finite: bool = True   # reject NaN/Inf points/folds at submit
    validate_outputs: bool = True  # non-finite launch output => corruption
    on_q_overflow: str = "fallback"

    def __post_init__(self):
        if self.on_q_overflow not in ("fallback", "reject", "wrap"):
            raise ValueError(f"on_q_overflow must be fallback|reject|wrap, "
                             f"got {self.on_q_overflow!r}")
        if self.max_launch_attempts < 1:
            raise ValueError("max_launch_attempts must be >= 1")


@dataclasses.dataclass
class _Pending:
    ticket: int
    chain: tc.TransformChain
    points: np.ndarray             # original-shape host copy
    n: int                         # flattened point count
    fold: tuple | None = None      # host fold, computed once at submit
    qformat: quantize.QFormat | None = None   # fixed-point lane request
    dequantize: bool = False       # float submitted -> float32 back
    q_fallback: bool = False       # q request rerouted to the float lane
    requant: quantize.QFormat | None = None   # int16 caller: requantise out


class _FailedLaunch:
    """Marker for a staging that raised instead of returning."""

    def __init__(self, err: Exception):
        self.err = err


@dataclasses.dataclass
class _Staged:
    """One launch's operands on the device, with the host buffers they
    were copied from (held until the copy is known to have landed)."""
    params: tuple
    points: torch.Tensor
    ready: torch.cuda.Event | None  # the copy stream's event (CUDA only)
    host: tuple                     # the pinned sources of the copies
    #: under an ambient mesh of several ranks, (mesh, placements) of the
    #: row shard this rank launches on (its outputs are gathered back)
    spread: tuple | None = None


@dataclasses.dataclass
class _Output:
    """One dispatched launch's results on their way to the host."""
    out: torch.Tensor
    mask: torch.Tensor | None = None     # projective launches only
    finite: torch.Tensor | None = None   # (B,) rows all finite, when the
    #                                      outputs are validated
    done: torch.cuda.Event | None = None
    staged: _Staged | None = None        # held until ``done``


@dataclasses.dataclass
class _Launch:
    """One scheduled launch (a whole bucket, or one shard of it), with
    everything recovery needs to re-pack and re-dispatch its requests."""
    structure: tuple
    qname: str | None
    backend: str                   # the rung this flush started on
    lpad: int
    plan: BatchPlan
    stacked: tuple                 # host (pinned on CUDA) batch parameters
    packed: torch.Tensor           # host (pinned on CUDA) (B, lpad, d)
    reqs: list
    report: "BucketReport"
    track: str = ""                # trace track: the bucket signature
    output: _Output | None = None
    error: Exception | None = None


@dataclasses.dataclass
class BucketReport:
    """Per-bucket accounting for one flush (the driver prints these)."""
    structure: str                 # e.g. "2D:TSRT"
    kind: str                      # plan kind: diag | matrix | projective
    lpad: int                      # padded points per request
    requests: int
    payload_points: int
    padded_points: int
    launches: int = 0              # dispatched: 1 unless sharded/recovered
    backend: str = ""              # the rung the bucket started on
    final_backend: str = ""        # the rung its last success landed on
    retries: int = 0
    bisections: int = 0
    backend_fallbacks: int = 0
    recovered_requests: int = 0
    failed_requests: int = 0       # resolved to a typed LaunchError
    q_fallback_requests: int = 0   # q requests served through this float
    #                                bucket because the bound predicted wrap

    @property
    def waste(self) -> float:
        """Fraction of padded points that carried no payload."""
        return 1.0 - self.payload_points / max(1, self.padded_points)

    @property
    def launches_saved(self) -> int:
        """Kernel launches avoided by batching (requests - launches)."""
        return self.requests - self.launches


def _kernel_fault(rung: str, err: Exception) -> bool:
    """Whether ``err`` on ``rung`` is a kernel's own failure: any error of
    a kernel rung that no injector scheduled, a detected corruption
    included.  After one, the plain version must not stand in."""
    return rung != "ref" and not isinstance(err, serrors.InjectedFault)


def _structure_tag(structure: tuple) -> str:
    dim, kinds = structure
    return f"{dim}D:" + "".join(k for k, _ in kinds)


def _bucket_track(structure: tuple, backend: str, dt: str,
                  lpad: int) -> str:
    """The trace track (Perfetto timeline) name of one plan bucket."""
    return f"{_structure_tag(structure)}|{backend}|{dt}|{lpad}"


class GeometryServer:
    """Batched transform-serving engine over the chain compiler.

        server = GeometryServer()                 # the GPU; device="cpu" asks
        tickets = [server.submit(chain_i, points_i) for ...]
        results = server.flush()                  # one launch per bucket

    ``submit`` validates and records the request on the host; ``flush``
    buckets, packs, stages and launches.  Results come back in submission
    order as host numpy arrays with each request's original shape,
    bitwise equal to ``chain_i.apply(points_i)`` on the same device;
    a projective request's result is a ``Projected`` whose ``.mask``
    equals the mask of ``chain_i.project(points_i)``.  A request that
    failed on every rung of the recovery ladder resolves to a typed
    ``LaunchError`` in its slot (``serving.is_error``).

    ``device`` defaults to CUDA and raises without a GPU; ``backend``
    defaults to the kernels on CUDA and the plain versions on the CPU
    (``backend="ref"`` on CUDA runs the plain versions on the card).
    ``fault_config`` holds the recovery policy, the q-overflow policy and
    the output check (see ``FaultConfig``); ``injector`` is an optional
    seeded ``serving.faults.FaultInjector`` (None in production: its
    hooks are then no-ops).
    """

    def __init__(self, *, device: str | torch.device = "cuda",
                 backend: str | None = None,
                 min_len: int | None = None,
                 waste_cap: float | None = None,
                 max_points_per_launch: int | None = None,
                 fault_config: FaultConfig | None = None,
                 injector=None):
        self.device = dispatch.resolve_device(device)
        self.backend = dispatch.backend_for(self.device, backend)
        #: recovery policy (retry/backoff/ladder/q-overflow) -- FaultConfig
        self.fault_config = fault_config or FaultConfig()
        #: optional seeded fault injector (serving.faults.FaultInjector)
        self.injector = injector
        # size-grid knobs: explicit args win; unset knobs come from the
        # tuning cache when autotuning is enabled, else the defaults
        # (bucketing.grid_for).  The explicit args are kept and the grid
        # re-resolves at every flush, so toggling
        # repro_torch.autotune.set_enabled moves a live server's grid.
        self._grid_args = (min_len, waste_cap)
        self.min_len, self.waste_cap, self.grid_source = bucketing.grid_for(
            self.backend, min_len=min_len, waste_cap=waste_cap)
        #: shard cap: a bucket whose packed B*L exceeds this splits into
        #: multiple launches along the batch axis
        self.max_points_per_launch = max_points_per_launch
        self._cuda = self.device.type == "cuda"
        #: the set-1 stream: host->device staging runs here
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        #: this server's own registry: every server-scoped counter is
        #: written here and into the module aggregate (``stats``), so two
        #: servers in one process keep their own numbers; the labelled
        #: bucket dimensions (plan kind, backend, dtype/qformat, size
        #: class) live here too
        self.metrics = obsm.MetricsRegistry("server")
        for k in _SERVER_KEYS:
            self.metrics.counter(k)
        self._pending: list[_Pending] = []
        self._ticket = 0
        self.last_report: list[BucketReport] = []
        #: every BucketReport this server produced; with a stats reset at
        #: the server's start, stats["launches"] == sum of their launches
        #: (recovery launches included)
        self.reports: list[BucketReport] = []
        #: host seconds of the last flush by phase (pack, dispatch, unpack
        #: -- unpack includes waiting for the device -- and recover, when
        #: a launch failed) and, on CUDA, the device milliseconds from the
        #: first copy to the last result copy of the first pass
        self.last_timing: dict[str, float] = {}

    def _bump(self, name: str, n: int = 1) -> None:
        """Count one server-scoped event in this server's registry AND the
        module aggregate (``reset_stats()`` zeroes the aggregate without
        erasing any live server's own history)."""
        stats[name] += n
        self.metrics.counter(name).inc(n)

    # -- request intake ------------------------------------------------------

    def submit(self, chain: tc.TransformChain, points, *,
               qformat=None) -> int:
        """Queue one request; returns its ticket.  The next flush()
        returns results ordered by submission, one per queued request.

        ``qformat`` (a Qm.n name like "q8.7") routes the request through
        the fixed-point lane: it buckets under the format (not the
        submitted dtype), packs as int16 words (float points are
        quantised at pack time, int16 points are taken as Qm.n words),
        and the result comes back dequantised float32 for float
        submissions, int16 for int16 ones.  Affine chains only --
        projective chains are rejected here, exactly as in
        ``TransformChain.apply``.

        Submit is the isolation boundary: a malformed request (bad shape,
        empty point set, float64, NaN/Inf points or parameters, a
        q-format that would wrap under ``on_q_overflow="reject"``) raises
        a typed ``RequestError`` carrying its ticket HERE, before it can
        reach a packed bucket."""
        return self.enqueue(self.validate(chain, points, qformat=qformat))

    def submit_scene(self, scene, name: str, points, *,
                     qformat=None) -> int:
        """Queue one request against a scene node: the chain is the
        node's world chain (``SceneGraph.world_chain``) and the fold is
        the scene's CACHED world fold, resolved through its shared
        ``FoldCache`` instead of refolded here, so requests under a
        common prefix fold that prefix once, not once a request.

        Everything downstream is the ordinary lane: the same bucket key,
        packed kernels, validation boundary and ``qformat=`` routing
        (the cached fold quantises through ``quantize.quantize_fold`` at
        pack time as a per-request fold does).  The cached fold is
        bit-identical to ``chain.fold()`` by the carry-fold construction
        (``transform_chain.fold_carry_extend``), so results are bitwise
        equal to submitting ``scene.world_chain(name)`` through
        ``submit``."""
        chain = scene.world_chain(name)
        fold = scene.world_fold(name) if len(chain) else None
        return self.enqueue(self.validate(chain, points, qformat=qformat,
                                          fold=fold))

    def validate(self, chain: tc.TransformChain, points, *,
                 qformat=None, fold=None) -> _Pending:
        """The intake half of ``submit``: assign a ticket id, run the
        validation boundary, and return the queue entry WITHOUT queueing
        it.  The async front-end (``serving.async_engine``) validates at
        arrival and enqueues when its flush policy schedules the entry,
        so both paths share one boundary and one ticket sequence.
        Rejected submissions burn their id: the id in a typed error is
        never reused.

        ``fold`` injects precomputed folded parameters (the scene
        graph's cached world fold) in place of the ``chain.fold()`` this
        method would otherwise run; it MUST be bit-identical to
        ``chain.fold()`` (the scene cache is, by construction) and
        passes the same finiteness and q-overflow checks either way."""
        ticket = self._ticket
        self._ticket += 1
        trc = obst.active()
        sid = trc.begin("request.validate", ticket=ticket) \
            if trc.enabled else None
        try:
            p = self._validate(chain, points, qformat, ticket, fold=fold)
        except errors.RequestError as e:
            self._bump("rejected_requests")
            if sid is not None:
                trc.end(sid, outcome="rejected",
                        code=getattr(e, "code", type(e).__name__))
            raise
        if sid is not None:
            trc.end(sid, outcome="admitted",
                    kind=tc.plan_kind_of(chain.structure) if len(chain)
                    else "identity",
                    q=p.qformat.name if p.qformat is not None else None,
                    points=p.n)
        return p

    def enqueue(self, p: _Pending) -> int:
        """Queue a ``validate``d entry for the next flush; returns its
        ticket.  ``submit`` is exactly ``enqueue(validate(...))``."""
        self._pending.append(p)
        return p.ticket

    def reset_stats(self) -> None:
        """Zero the module counters, this server's registry AND its report
        history, so ``stats["launches"] == sum(r.launches for r in
        self.reports)`` restarts from a consistent origin."""
        reset_stats()
        self.metrics.reset()
        self.reports = []
        self.last_report = []

    def _validate(self, chain: tc.TransformChain, points, qformat,
                  ticket: int, fold=None) -> _Pending:
        """Build the queue entry, raising the typed taxonomy on anything
        the packed lane could choke on later, and apply the q-overflow
        policy to fixed-point requests.  ``fold`` skips the
        ``chain.fold()`` recompute (scene-cached folds); every check
        downstream of the fold runs on the injected value unchanged."""
        cfg = self.fault_config
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        # a real copy, not a view: the queue must be immune to callers
        # mutating their buffer between submit and flush
        pts = np.array(points, copy=True)
        errors.check_points(pts, chain.dim, ticket=ticket)
        fmt = None
        dequant = False
        if qformat is not None:
            fmt = quantize.as_qformat(qformat)
            quantize.reject_projective(chain.is_projective)
            try:
                dequant = quantize.points_need_quantize(pts.dtype)
            except TypeError as e:
                raise errors.DtypeError(str(e), ticket=ticket) from None
        elif pts.dtype != np.float32:
            raise errors.DtypeError(
                f"serving float lane is float32, got {pts.dtype}; cast "
                "before submit (or pass qformat= for int16)", ticket=ticket)
        if cfg.validate_finite and np.issubdtype(pts.dtype, np.floating) \
                and not np.isfinite(pts).all():
            raise errors.NonFiniteError("points contain NaN/Inf",
                                        ticket=ticket)
        if not len(chain):
            fold = None
        else:
            if fold is None:
                fold = chain.fold()
            # projective folds legitimately carry +/-inf cull bounds
            parts = fold[:1] if chain.is_projective else fold
            if cfg.validate_finite and not all(
                    np.isfinite(np.asarray(f)).all() for f in parts):
                raise errors.NonFiniteError(
                    "chain parameters fold to NaN/Inf", ticket=ticket)
        q_fallback = False
        requant = None
        if fmt is not None and fold is not None \
                and cfg.on_q_overflow != "wrap":
            kind = tc.plan_kind_of(chain.structure)
            x_vals = pts if dequant else fmt.dequantize(pts)
            x_max = float(np.abs(x_vals).max())
            if cfg.on_q_overflow == "reject":
                quantize.ensure_fits(fold, kind, fmt, x_max, ticket=ticket)
            elif not quantize.fits(fold, kind, fmt, x_max):
                # degrade, don't wrap: reroute through the float32 lane;
                # int16 callers still get int16 back (requantised)
                self._bump("q_fallbacks")
                q_fallback = True
                if not dequant:
                    pts = fmt.dequantize(pts)
                    requant = fmt
                fmt = None
                dequant = False
        return _Pending(ticket, chain, pts, pts.size // chain.dim, fold=fold,
                        qformat=fmt, dequantize=dequant,
                        q_fallback=q_fallback, requant=requant)

    def serve(self, items, *, qformat=None) -> list:
        """Convenience: submit an iterable of (chain, points), then flush."""
        for chain, points in items:
            self.submit(chain, points, qformat=qformat)
        return self.flush()

    @property
    def pending(self) -> int:
        """Requests submitted but not yet flushed."""
        return len(self._pending)

    # -- execution -----------------------------------------------------------

    def _bucket_key(self, p: _Pending) -> tuple:
        lpad = bucketing.padded_length(p.n, min_len=self.min_len,
                                       waste_cap=self.waste_cap)
        # fixed-point requests bucket under the FORMAT, not the submitted
        # dtype: float- and int16-submitted q8.7 requests share one batch
        dt = p.qformat.name if p.qformat is not None else p.points.dtype.str
        return (p.chain.structure, self.backend, dt, lpad)

    def _pack(self, reqs: list[_Pending], lpad: int, plan: BatchPlan):
        """Pack one launch: the (B, lpad, d) zero-padded points and the
        stack of each request's host fold, in pinned host memory when the
        server runs on CUDA (so the copy to the device is asynchronous).
        Fixed-point launches pack int16 Qm.n words -- float submissions
        quantise here -- and each fold quantises through the same
        ``quantize.quantize_fold`` the chain compiler's q lane uses.
        Folds come precomputed from submit, so a recovery re-pack is
        bit-identical to the original pack."""
        dim = plan.dim
        fmt = quantize.as_qformat(plan.qformat) if plan.qformat else None
        packed = torch.empty((len(reqs), lpad, dim),
                             dtype=torch.int16 if fmt else torch.float32,
                             pin_memory=self._cuda)
        view = packed.numpy()
        for i, r in enumerate(reqs):
            pts = r.points.reshape(-1, dim)
            view[i, :r.n] = fmt.quantize(pts) if fmt and r.dequantize else pts
            view[i, r.n:] = 0
        folds = [quantize.quantize_fold(r.fold, plan.kind, fmt)
                 for r in reqs] if fmt else [r.fold for r in reqs]
        stacked = tuple(torch.from_numpy(np.stack(part))
                        for part in zip(*folds))
        if self._cuda:
            stacked = tuple(p.pin_memory() for p in stacked)
        return stacked, packed

    def _chunks(self, n_reqs: int, lpad: int) -> list[slice]:
        """Shard an oversized bucket along the batch axis."""
        cap = self.max_points_per_launch
        if cap is None or n_reqs * lpad <= cap:
            return [slice(0, n_reqs)]
        rows = max(1, cap // lpad)
        return [slice(i, min(i + rows, n_reqs))
                for i in range(0, n_reqs, rows)]

    def _stage(self, stacked: tuple, packed: torch.Tensor) -> _Staged:
        """Host->device staging of one launch (the set-1 DMA): the pinned
        buffers are copied on the side stream, and an event marks when
        they have landed.  On the CPU the host tensors are the operands.
        Under an ambient mesh of more than one rank every rank runs the
        same server on the same submissions (SPMD) and stages its row
        shard of the packed bucket, split over the fsdp axes as
        ``batch_specs`` with ``sanitize_specs`` split it (whole when their
        width does not divide the rows); ``_dispatch`` gathers the rows
        back before the unpack."""
        mesh = sharding.ambient_mesh()
        if mesh is not None and mesh.size() > 1:
            return self._stage_shard(stacked, packed, mesh)
        return self._stage_whole(stacked, packed)

    def _stage_shard(self, stacked: tuple, packed: torch.Tensor,
                     mesh) -> _Staged:
        """This rank's rows of a packed bucket and of its parameters (the
        fsdp mesh dims split the rows, the first major, as a DTensor's
        ``Shard(0)``)."""
        spec = sharding.sanitize_specs(
            packed, sharding.batch_specs(packed, mesh, accum_dim=False),
            mesh)
        where = sharding.placements(spec, mesh)
        coord = mesh.get_coordinate()
        index, parts = 0, 1
        for j, p in enumerate(where):
            if p.is_shard():
                index = index * mesh.size(j) + coord[j]
                parts *= mesh.size(j)
        if parts == 1:
            return self._stage_whole(stacked, packed)
        n = packed.shape[0] // parts
        rows = slice(index * n, (index + 1) * n)
        staged = self._stage_whole(tuple(p[rows] for p in stacked),
                                   packed[rows])
        staged.spread = (mesh, where)
        return staged

    def _stage_whole(self, stacked: tuple, packed: torch.Tensor) -> _Staged:
        """``_stage`` of whole operands: the one-device staging."""
        if not self._cuda:
            return _Staged(stacked, packed, None, ())
        with torch.cuda.stream(self._copy_stream):
            pts = packed.to(self.device, non_blocking=True)
            params = tuple(p.to(self.device, non_blocking=True)
                           for p in stacked)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return _Staged(params, pts, ready, (packed, *stacked))

    def _dispatch(self, plan: BatchPlan, staged: _Staged) -> _Output:
        """Run one launch on the compute stream (set 0) and queue its
        device->host copies -- the points, and for a projective launch its
        (B, L) mask -- under one ``done`` event; on the CPU the result is
        already on the host.  The compute stream waits for the staging
        copy and takes the device operands over (``record_stream``)
        before anything here can raise, so a launch that fails leaves no
        buffer to be reused under a queued copy or kernel."""
        params, pts = staged.params, staged.points
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.ready)
            for tensor in (pts, *params):
                tensor.record_stream(compute)
        outs = plan.fn(params, pts)
        projective = plan.kind == "projective"
        if not projective:
            outs = (outs,)
        if staged.spread is not None:      # every rank's rows, in order
            from torch.distributed.tensor import DTensor
            mesh, where = staged.spread
            outs = tuple(DTensor.from_local(o, mesh, where, run_check=False)
                         .full_tensor() for o in outs)
        # the reference's output check, on the device: one flag a packed
        # row, padding included, as the reference checks the whole output
        validate = self.fault_config.validate_outputs \
            and plan.qformat is None and not projective
        if validate:
            outs = (*outs, torch.isfinite(outs[0]).flatten(1).all(dim=1))
        done = None
        if self._cuda:
            hosts = []
            for out in outs:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                hosts.append(host)
            outs = hosts
            done = torch.cuda.Event()
            done.record(compute)
        return _Output(out=outs[0], mask=outs[1] if projective else None,
                       finite=outs[-1] if validate else None, done=done,
                       staged=staged)

    def _contain(self, err: Exception) -> None:
        """Decide whether a caught exception may be contained.  Injected
        faults and detected corruption leave the device as it was; any
        other exception on a CUDA server may be a device fault that broke
        the context, after which every later rung (the plain version on
        the card included) would fail too -- so the device is
        synchronized, and if that raises, ``err`` propagates."""
        if not self._cuda or isinstance(
                err, (serrors.InjectedFault, serrors.CorruptionError)):
            return
        try:
            torch.cuda.synchronize(self.device)
        except Exception as sync_err:
            raise err from sync_err

    def _settle(self) -> None:
        """Launches failed after their staging was queued: wait for the
        copy stream before their pinned sources and device buffers, which
        no ``done`` event covers, are freed."""
        if self._cuda:
            self._copy_stream.synchronize()

    # -- fault-injection hooks (no-ops without an injector) ------------------

    def _check_injected(self, reqs: list, rung_index: int,
                        attempt: int) -> None:
        """Raise ``InjectedFault`` when the seeded injector scheduled a
        launch failure for this (request group, rung, attempt)."""
        if self.injector is not None:
            self.injector.before_launch(
                tuple(r.ticket for r in reqs), rung_index, attempt)

    def _stage_attempt(self, plan: BatchPlan, stacked, packed, reqs: list,
                       rung_index: int, attempt: int) -> _Staged:
        """Staging with the corruption hook: the injector may return a
        corrupted COPY of the pinned packed buffer, which is what goes to
        the device (the launch's own buffer stays clean for a re-pack;
        the copy is held with the staged operands until the launch's
        ``done`` event).  Only float affine buckets are corruptible --
        their outputs are finite-validatable; projective guarded divides
        and int16 words have no such invariant to check against."""
        inj = self.injector
        if inj is not None and plan.qformat is None \
                and plan.kind != "projective":
            packed = inj.corrupt_staging(
                packed, tuple(r.ticket for r in reqs), rung_index, attempt)
        return self._stage(stacked, packed)

    def _count_launch(self, plan: BatchPlan, lpad: int, reqs: list,
                      packed: torch.Tensor, report: BucketReport,
                      rung: int = 0, attempt: int = 0,
                      track: str | None = None) -> None:
        """Bookkeeping for one DISPATCHED launch (called after the
        injector gate: a blocked attempt never reached the device).  The
        ONE place ``stats["launches"]`` moves and the one place ``launch``
        instants come from, so ``count("launch") == stats["launches"]``
        holds by construction.  The instant carries the reference's
        fields: the rung, plan kind, the autotune config's source, the
        opcount HBM bytes this launch moves, and the cost model's
        prediction (kernel, bytes, FLOPs, M1 cycles), attached at
        dispatch time so the profiler folds predicted-vs-observed ratios
        out of the span stream."""
        # the _q suffix keeps the lanes separately countable, as in
        # ``TransformChain``
        nbytes = opcount.packed_chain_bytes(
            len(reqs), lpad, plan.dim, itemsize=packed.element_size(),
            kind=plan.kind)
        opcount.record(
            f"serve_bucket_{plan.kind}{'_q' if plan.qformat else ''}",
            nbytes)
        self._bump("launches")
        report.launches += 1
        trc = obst.active()
        if trc.enabled:
            from repro_torch.autotune import costmodel  # traced path only
            dtype = plan.qformat if plan.qformat is not None \
                else tuning.dtype_name(packed.dtype)
            kernel = _KERNEL_BY_KIND[plan.kind] \
                + ("_q" if plan.qformat else "")
            cfg = tuning.config_for(kernel, plan.backend, dtype,
                                    len(reqs) * lpad)
            pred = costmodel.predict_launch(
                plan.kind, len(reqs), lpad, plan.dim,
                qformat=plan.qformat, itemsize=packed.element_size())
            trc.instant(
                "launch", tickets=tuple(r.ticket for r in reqs),
                track=track, backend=plan.backend, kind=plan.kind,
                q=plan.qformat, rung=rung, attempt=attempt,
                rows=len(reqs), lpad=lpad, kernel=pred.kernel,
                hbm_bytes=nbytes, pred_hbm_bytes=pred.hbm_bytes,
                pred_flops=pred.flops, pred_m1_cycles=pred.m1_cycles,
                config=cfg.source)

    # -- flush: dispatch, unpack, recover ------------------------------------

    def flush(self) -> list:
        """Execute all pending requests; results in submission order.

        Failure containment: a launch that raises (at staging or launch)
        or whose output fails the corruption check is set aside; every
        OTHER launch completes normally, then the failed groups walk the
        recovery ladder (``_recover``).  A request whose recovery
        exhausts resolves to a typed ``LaunchError`` in its result slot,
        so the returned list always lines up 1:1 with submissions."""
        pending, self._pending = self._pending, []
        trc = obst.active()
        fsid = trc.begin("flush", requests=len(pending)) \
            if trc.enabled else None
        # grid lookup keyed by this flush's traffic scale (largest request
        # length): grids are tuned per scale
        self.min_len, self.waste_cap, self.grid_source = bucketing.grid_for(
            self.backend, min_len=self._grid_args[0],
            waste_cap=self._grid_args[1],
            n=max((p.n for p in pending), default=0))
        results: dict[int, typing.Any] = {}
        buckets: dict[tuple, list[_Pending]] = {}
        for p in pending:
            if len(p.chain) == 0:
                results[p.ticket] = p.points   # identity passthrough
                if trc.enabled:
                    trc.instant("request.resolve", ticket=p.ticket,
                                outcome="identity")
            else:                              # (empty sets reject at submit)
                buckets.setdefault(self._bucket_key(p), []).append(p)

        t_pack = time.perf_counter()
        launches: list[_Launch] = []
        self.last_report = []
        for (structure, bk, dt, lpad), reqs in buckets.items():
            qname = reqs[0].qformat.name if reqs[0].qformat is not None \
                else None
            track = _bucket_track(structure, bk, dt, lpad)
            bsid = trc.begin("bucket.assemble", track=track,
                             tickets=tuple(r.ticket for r in reqs),
                             rows=len(reqs), lpad=lpad) \
                if trc.enabled else None
            plan = get_batch_plan(structure, bk, qname)
            chunks = self._chunks(len(reqs), lpad)
            psid = trc.begin("bucket.pack", track=track, rows=len(reqs),
                             lpad=lpad, q=plan.qformat) \
                if trc.enabled else None
            packs = [self._pack(reqs[sl], lpad, plan) for sl in chunks]
            if psid is not None:
                trc.end(psid)
            payload = sum(r.n for r in reqs)
            report = BucketReport(
                structure=_structure_tag(structure), kind=plan.kind,
                lpad=lpad, requests=len(reqs), payload_points=payload,
                padded_points=len(reqs) * lpad, backend=bk,
                final_backend=bk,
                q_fallback_requests=sum(r.q_fallback for r in reqs))
            for sl, (stacked, packed) in zip(chunks, packs):
                launches.append(_Launch(
                    structure=structure, qname=qname, backend=bk,
                    lpad=lpad, plan=plan, stacked=stacked, packed=packed,
                    reqs=reqs[sl], report=report, track=track))
            self.last_report.append(report)
            self.reports.append(report)
            self._bump("buckets")
            self._bump("shards", len(chunks) - 1)
            self._bump("payload_points", payload)
            self._bump("padded_points", len(reqs) * lpad)
            # the labelled serving dimensions -- per server only: the
            # aggregate view stays the flat counter set
            self.metrics.counter(
                "bucket_requests",
                labels=("kind", "backend", "dtype", "size_class"),
            ).labels(kind=plan.kind, backend=bk, dtype=dt,
                     size_class=lpad).inc(len(reqs))
            if bsid is not None:
                trc.end(bsid, kind=plan.kind, shards=len(chunks),
                        payload_points=payload)

        # Phase 1 -- optimistic double-buffered dispatch (set 0 / set 1):
        # stage launch k+1 while launch k computes.  Nothing blocks until
        # unpack; the copy stream runs ahead of the kernels.  A launch
        # that raises is recorded and skipped, never aborting its
        # siblings.  The hooks run in the reference's order: staging
        # (corruption), the injector's gate, the count, the launch.
        t_dispatch = time.perf_counter()
        span = self._device_span_start() if launches else None
        dsid = trc.begin("flush.dispatch", launches=len(launches)) \
            if trc.enabled else None
        held: list[_Staged] = []   # the staged operands of failed launches
        staged = self._stage_first(launches[0]) if launches else None
        for k, L in enumerate(launches):
            try:
                if isinstance(staged, _FailedLaunch):
                    raise staged.err
                self._check_injected(L.reqs, 0, 0)
                self._count_launch(L.plan, L.lpad, L.reqs, L.packed,
                                   L.report, rung=0, attempt=0,
                                   track=L.track)
                L.output = self._dispatch(L.plan, staged)      # set 0
            except Exception as e:
                self._contain(e)
                L.error = e
                if isinstance(staged, _Staged):
                    held.append(staged)
            if k + 1 < len(launches):
                staged = self._stage_first(launches[k + 1])   # set 1
        if span is not None:
            span[1].record(torch.cuda.current_stream(self.device))
        if dsid is not None:
            trc.end(dsid)

        # Phase 2 -- unpack with capture: each launch waits for its own
        # copies and is checked under its own try.
        t_unpack = time.perf_counter()
        usid = trc.begin("flush.unpack") if trc.enabled else None
        failed: list[tuple[_Launch, Exception]] = []
        for L in launches:
            lsid = trc.begin("unpack", track=L.track,
                             tickets=tuple(r.ticket for r in L.reqs)) \
                if trc.enabled else None
            err = L.error
            if err is None:
                try:
                    self._unpack(L.plan, L.reqs, L.output, results)
                except Exception as e:
                    self._contain(e)
                    err = e
            L.output = None
            if err is not None:
                self._bump("launch_failures")
                failed.append((L, err))
            if lsid is not None:
                if err is None:
                    trc.end(lsid, outcome="ok")
                else:
                    trc.end(lsid, outcome="failed",
                            error=type(err).__name__)
        if held:
            self._settle()
            held.clear()
        if usid is not None:
            trc.end(usid, failed=len(failed))
        if span is not None:
            span[1].synchronize()

        # Phase 3 -- sequential recovery of the failed groups (the rare
        # path; overlap no longer matters, determinism and containment do)
        t_recover = time.perf_counter()
        if failed:
            rsid = trc.begin("flush.recover", groups=len(failed)) \
                if trc.enabled else None
            for L, err in failed:
                self._recover(L, list(L.reqs), err, results)
            if rsid is not None:
                trc.end(rsid)

        self._bump("requests", len(pending))
        t_end = time.perf_counter()
        self.last_timing = {"pack_s": t_dispatch - t_pack,
                            "dispatch_s": t_unpack - t_dispatch,
                            "unpack_s": t_recover - t_unpack}
        if failed:
            self.last_timing["recover_s"] = t_end - t_recover
        if span is not None:
            self.last_timing["device_ms"] = span[0].elapsed_time(span[1])
        if fsid is not None:
            trc.end(fsid, buckets=len(buckets), launches=len(launches))
        return [results[p.ticket] for p in pending]

    def _stage_first(self, L: _Launch):
        """Phase 1's staging of a launch at (rung 0, attempt 0): a staging
        failure is a launch failure, recorded instead of raised."""
        try:
            return self._stage_attempt(L.plan, L.stacked, L.packed, L.reqs,
                                       0, 0)
        except Exception as e:
            self._contain(e)
            return _FailedLaunch(e)

    def _device_span_start(self):
        """Timing events around the flush's device work (CUDA only): the
        start is recorded on the copy stream before the first copy, the
        end on the compute stream after the last result copy."""
        if not self._cuda:
            return None
        span = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        span[0].record(self._copy_stream)
        return span

    def _unpack(self, plan: BatchPlan, reqs: list, res: _Output,
                results: dict) -> None:
        """Unpack one launch: wait for its device->host copies, then numpy
        slicing.  Each result is a payload-sized COPY, so no result pins
        the padded batch buffer.  A projective launch's results carry
        their rows of the cull mask as ``Projected.mask``; a fixed-point
        result is dequantised for a float submission, and a float-lane
        fallback requantised for an int16 one.  A launch whose finiteness
        flags (``validate_outputs``) show any non-finite row raises
        ``CorruptionError`` before any result is written: its inputs were
        finite at submit, so the staged buffer or the launch corrupted in
        flight, and recovery re-packs from the clean host copies."""
        if res.done is not None:
            res.done.synchronize()
        if res.finite is not None and not bool(res.finite.numpy().all()):
            raise serrors.CorruptionError(
                f"non-finite values in {plan.kind} launch output "
                f"(B={len(reqs)})")
        host = res.out.numpy()
        mask = None if res.mask is None else res.mask.numpy()
        fmt = quantize.as_qformat(plan.qformat) if plan.qformat else None
        trc = obst.active()
        for i, r in enumerate(reqs):
            out = np.array(host[i, :r.n].reshape(r.points.shape))
            if mask is not None:
                out = _projected(out, np.array(
                    mask[i, :r.n].reshape(r.points.shape[:-1])))
            elif fmt is not None and r.dequantize:
                out = fmt.dequantize(out)
            elif r.requant is not None:
                # q -> float fallback for an int16 caller: requantise so
                # the submit contract (int16 in -> int16 out) holds
                out = r.requant.quantize(out)
            results[r.ticket] = out
            if trc.enabled:
                trc.instant("request.resolve", ticket=r.ticket,
                            outcome="ok")

    def _recover(self, L: _Launch, reqs: list, err: Exception,
                 results: dict, depth: int = 0) -> None:
        """Walk the recovery ladder for one failed launch group:

          1. retry the same rung, bounded exponential backoff between
             attempts (transient faults);
          2. degrade the backend along ``dispatch.fallback_ladder``
             (substrate faults: each rung computes the same function);
          3. bisect -- split the group in half and recover each half with
             a fresh ladder (poison isolation in O(log B) launches).

        The plain version stands in for a kernel only after injected
        faults: once the kernel rung fails in any other way (it raised,
        or its output failed the corruption check), the group skips the
        later rungs and bisects on the kernel alone, so a kernel that
        fails on the card ends in ``LaunchError``s, never in results of
        the plain version.  Each attempt re-packs from the clean host
        copies and runs alone: staged, launched and unpacked (which waits
        for its copies) before the next.  A singleton that exhausts its
        rungs resolves to a typed ``LaunchError`` carrying its ticket:
        the request fails alone, with a name, and nothing is silently
        dropped."""
        cfg = self.fault_config
        rungs = dispatch.fallback_ladder(L.backend)
        # a failure of a kernel rung that no injector scheduled
        kernel_failed = depth == 0 and _kernel_fault(rungs[0], err)
        walked = 0
        trc = obst.active()
        rtrack = f"recovery:{L.track}" if L.track else "recovery"
        gsid = trc.begin("recover", track=rtrack,
                         tickets=tuple(r.ticket for r in reqs),
                         depth=depth, rows=len(reqs),
                         error=type(err).__name__) \
            if trc.enabled else None
        # at depth 0 the optimistic dispatch already burned attempt 0 of
        # rung 0; bisected halves start their ladder fresh
        n_failures = 1 if depth == 0 else 0
        for ri, rung in enumerate(rungs):
            if ri > 0 and kernel_failed:
                break
            walked += 1
            plan = L.plan if ri == 0 \
                else get_batch_plan(L.structure, rung, L.qname)
            start = n_failures if ri == 0 and depth == 0 else 0
            for attempt in range(start, cfg.max_launch_attempts):
                if n_failures:
                    time.sleep(min(cfg.backoff_cap_s, cfg.backoff_base_s *
                                   cfg.backoff_factor ** (n_failures - 1)))
                if attempt > 0:
                    self._bump("retries")
                    L.report.retries += 1
                asid = trc.begin("recover.attempt", track=rtrack,
                                 rung=rung, attempt=attempt) \
                    if trc.enabled else None
                staged = None
                try:
                    stacked, packed = self._pack(reqs, L.lpad, plan)
                    staged = self._stage_attempt(plan, stacked, packed, reqs,
                                                 ri, attempt)
                    self._check_injected(reqs, ri, attempt)
                    self._count_launch(plan, L.lpad, reqs, packed, L.report,
                                       rung=ri, attempt=attempt, track=rtrack)
                    self._unpack(plan, reqs, self._dispatch(plan, staged),
                                 results)
                except Exception as e:
                    self._contain(e)
                    if staged is not None:
                        self._settle()
                    self._bump("launch_failures")
                    err = e
                    kernel_failed |= _kernel_fault(rung, e)
                    n_failures += 1
                    if asid is not None:
                        trc.end(asid, outcome="failed",
                                error=type(e).__name__)
                    continue
                if asid is not None:
                    trc.end(asid, outcome="ok")
                if ri > 0:
                    self._bump("backend_fallbacks")
                    L.report.backend_fallbacks += 1
                    L.report.final_backend = rung
                self._bump("recovered_requests", len(reqs))
                L.report.recovered_requests += len(reqs)
                if gsid is not None:
                    trc.end(gsid, outcome="recovered", rung=rung)
                return
        if len(reqs) > 1:
            self._bump("bisections")
            L.report.bisections += 1
            if trc.enabled:
                trc.instant("recover.bisect", track=rtrack,
                            tickets=tuple(r.ticket for r in reqs),
                            depth=depth, rows=len(reqs))
            if gsid is not None:
                trc.end(gsid, outcome="bisected")
            mid = len(reqs) // 2
            self._recover(L, reqs[:mid], err, results, depth + 1)
            self._recover(L, reqs[mid:], err, results, depth + 1)
            return
        r = reqs[0]
        resolution = errors.LaunchError(
            f"launch failed on every rung of {rungs[:walked]} "
            f"(x{cfg.max_launch_attempts} attempts each): {err}",
            ticket=r.ticket)
        if trc.enabled and trc.recorder is not None:
            # the event window that led here rides on the resolution --
            # a chaos failure is debuggable from the error object alone
            resolution.flight = trc.recorder.snapshot()
        results[r.ticket] = resolution
        self._bump("failed_requests")
        L.report.failed_requests += 1
        if trc.enabled:
            trc.instant("request.resolve", ticket=r.ticket,
                        outcome="launch-error")
        if gsid is not None:
            trc.end(gsid, outcome="failed")

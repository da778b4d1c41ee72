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

Not in this slice: the recovery ladder (retry, backend degradation,
bisection), fault injection, ``submit_scene``, tracing and the
per-server metrics registry come with their own slices; their counters
below stay 0.
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from repro_torch import errors, quantize
from repro_torch.core import transform_chain as tc
from repro_torch.kernels import (chain_apply_batch, chain_apply_batch_q,
                                 chain_diag_batch, chain_diag_batch_q,
                                 chain_project_batch, dispatch, opcount)
from repro_torch.serving import bucketing

#: serving statistics (observable by tests, benchmarks and the driver):
#:   plan_compiles -- batched plans built (one per distinct structure+backend)
#:   plan_hits     -- plans served from the cache
#:   traces        -- jit traces in the JAX package; 0 here (eager PyTorch)
#:   launches      -- batched kernel launches dispatched (shards included)
#:   requests      -- requests served through flush()
#:   buckets       -- plan buckets executed
#:   shards        -- extra launches from splitting oversized buckets
#:   payload_points / padded_points -- real vs padded points moved
#:   rejected_requests -- submissions refused with a typed RequestError
#:   q_fallbacks   -- q requests rerouted to the float lane (would wrap)
#:   failed_requests -- requests resolved to a typed LaunchError (a
#:                    non-finite float output, ``validate_outputs``)
#: the rest are the fault-tolerance and continuous-batching counters of
#: the JAX package; they stay 0 until those slices are ported.
_STAT_KEYS = ("plan_compiles", "plan_hits", "traces", "launches",
              "requests", "buckets", "shards",
              "payload_points", "padded_points",
              "rejected_requests", "q_fallbacks", "launch_failures",
              "retries", "backend_fallbacks", "bisections",
              "recovered_requests", "failed_requests",
              "admitted_requests", "queue_full_rejections",
              "rate_limit_rejections")

#: process-wide counters, shared by every server (the reference's
#: aggregate view; per-server registries arrive with the obs slice)
stats: dict[str, int] = dict.fromkeys(_STAT_KEYS, 0)

_BATCH_PLANS: dict[tuple, "BatchPlan"] = {}


def reset_stats() -> None:
    """Zero the module counters."""
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


def _compile_batch_q(structure: tuple, backend: str,
                     qname: str) -> BatchPlan:
    """A fixed-point bucket executor: the int16 batch kernels with the
    format's fraction count as the requantising shift.  Projective
    structures never get here (``submit`` rejects chain + qformat)."""
    dim, _ = structure
    kind = tc.plan_kind_of(structure)
    fmt = quantize.as_qformat(qname)
    if kind == "diag":
        def fn(folded, pts3):
            """Q-format diagonal transform over a (B, L) bucket."""
            s, t = folded
            return chain_diag_batch_q(pts3, s, t, n_frac=fmt.n,
                                      backend=backend)
    else:
        def fn(folded, pts3):
            """Q-format matrix transform over a (B, L) bucket."""
            a, t = folded
            return chain_apply_batch_q(pts3, a, t, n_frac=fmt.n,
                                       backend=backend)
    return BatchPlan(kind=kind, dim=dim, backend=backend, fn=fn,
                     qformat=fmt.name)


def _compile_batch(structure: tuple, backend: str) -> BatchPlan:
    dim, _ = structure
    kind = tc.plan_kind_of(structure)
    if kind == "diag":
        def fn(folded, pts3):
            """Diagonal transform over a (B, L) bucket."""
            s, t = folded
            return chain_diag_batch(pts3, s, t, backend=backend)
    elif kind == "matrix":
        def fn(folded, pts3):
            """Matrix transform over a (B, L) bucket."""
            a, t = folded
            return chain_apply_batch(pts3, a, t, backend=backend)
    else:
        def fn(folded, pts3):
            """Projective transform + cull over a (B, L) bucket."""
            h, lo, hi = folded
            return chain_project_batch(pts3, h, lo, hi, backend=backend)
    return BatchPlan(kind=kind, dim=dim, backend=backend, fn=fn)


def get_batch_plan(structure: tuple, backend: str,
                   qname: str | None = None) -> BatchPlan:
    """The cached batch plan for ``structure`` on ``backend`` (``qname``
    selects the fixed-point lane: a distinct plan, as a distinct dtype
    would be); mirrors ``transform_chain._get_plan`` and counts into the
    serving stats."""
    key = (structure, backend, qname)
    plan = _BATCH_PLANS.get(key)
    if plan is None:
        stats["plan_compiles"] += 1
        plan = _BATCH_PLANS[key] = \
            _compile_batch_q(structure, backend, qname) \
            if qname is not None else _compile_batch(structure, backend)
    else:
        stats["plan_hits"] += 1
    return plan


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault policy knobs for one ``GeometryServer`` (the JAX package's
    fields and validation).

    ``on_q_overflow`` decides what happens when ``quantize.fits`` says a
    q-lane request would wrap int16:

      * ``"fallback"`` (default) -- serve the request through the float32
        lane instead (int16 submissions come back requantised int16, so
        the caller's contract holds); counted in ``stats["q_fallbacks"]``
        and ``BucketReport.q_fallback_requests``.
      * ``"reject"``  -- raise ``QRangeError`` at submit.
      * ``"wrap"``    -- the M1's semantics: no check, arithmetic wraps.

    ``validate_finite`` gates the NaN/Inf checks at submit.
    ``validate_outputs`` gates the check of every float, non-projective
    launch output (on the launch's device, a flag a packed row): a
    request whose row holds a NaN or Inf resolves to a ``LaunchError``
    carrying its ticket, counted in
    ``stats["failed_requests"]`` and ``BucketReport.failed_requests``, and
    its finite neighbours in the same launch resolve normally -- the
    final state the reference's recovery reaches for a deterministic
    poison.  The retry and backoff fields keep their reference meaning
    for the recovery ladder (retry, degrade, bisect), which comes with
    its own slice; until then they act on nothing, and no retry or
    fallback is run or counted.
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


@dataclasses.dataclass
class _Launch:
    """One scheduled launch (a whole bucket, or one shard of it) and the
    buffers that carry it through staging, the kernel and unpacking."""
    plan: BatchPlan
    lpad: int
    stacked: tuple                 # host (pinned on CUDA) batch parameters
    packed: torch.Tensor           # host (pinned on CUDA) (B, lpad, d)
    reqs: list
    report: "BucketReport"
    host_out: torch.Tensor | None = None
    host_mask: torch.Tensor | None = None   # projective launches only
    host_finite: torch.Tensor | None = None  # (B,) rows all finite, when
    #                                          the outputs are validated
    done: torch.cuda.Event | None = None


@dataclasses.dataclass
class BucketReport:
    """Per-bucket accounting for one flush (the driver prints these).
    The recovery ladder's retry, bisection and fallback fields join with
    the fault-tolerance slice."""
    structure: str                 # e.g. "2D:TSRT"
    kind: str                      # plan kind: diag | matrix | projective
    lpad: int                      # padded points per request
    requests: int
    payload_points: int
    padded_points: int
    launches: int = 0              # dispatched: 1 unless sharded
    backend: str = ""              # the backend the bucket ran on
    q_fallback_requests: int = 0   # q requests served through this float
    #                                bucket because the bound predicted wrap
    failed_requests: int = 0       # resolved to a typed LaunchError

    @property
    def waste(self) -> float:
        """Fraction of padded points that carried no payload."""
        return 1.0 - self.payload_points / max(1, self.padded_points)

    @property
    def launches_saved(self) -> int:
        """Kernel launches avoided by batching (requests - launches)."""
        return self.requests - self.launches


def _structure_tag(structure: tuple) -> str:
    dim, kinds = structure
    return f"{dim}D:" + "".join(k for k, _ in kinds)


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
    equals the mask of ``chain_i.project(points_i)``.

    ``device`` defaults to CUDA and raises without a GPU; ``backend``
    defaults to the kernels on CUDA and the plain versions on the CPU
    (``backend="ref"`` on CUDA runs the plain versions on the card).
    ``fault_config`` holds the q-overflow policy and the output check
    (see ``FaultConfig``).
    """

    def __init__(self, *, device: str | torch.device = "cuda",
                 backend: str | None = None,
                 min_len: int | None = None,
                 waste_cap: float | None = None,
                 max_points_per_launch: int | None = None,
                 fault_config: FaultConfig | None = None):
        self.device = dispatch.resolve_device(device)
        self.backend = dispatch.backend_for(self.device, backend)
        #: fault policy (the q-overflow arm and the output check act)
        self.fault_config = fault_config or FaultConfig()
        self.min_len, self.waste_cap, self.grid_source = bucketing.grid_for(
            min_len=min_len, waste_cap=waste_cap)
        #: shard cap: a bucket whose packed B*L exceeds this splits into
        #: multiple launches along the batch axis
        self.max_points_per_launch = max_points_per_launch
        self._cuda = self.device.type == "cuda"
        #: the set-1 stream: host->device staging runs here
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        self._pending: list[_Pending] = []
        self._ticket = 0
        self.last_report: list[BucketReport] = []
        #: every BucketReport this server produced; with a stats reset at
        #: the server's start, stats["launches"] == sum of their launches
        self.reports: list[BucketReport] = []
        #: host seconds of the last flush by phase (pack, dispatch, unpack
        #: -- unpack includes waiting for the device) and, on CUDA, the
        #: device milliseconds from the first copy to the last result copy
        self.last_timing: dict[str, float] = {}

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

    def validate(self, chain: tc.TransformChain, points, *,
                 qformat=None) -> _Pending:
        """The intake half of ``submit``: assign a ticket id, run the
        validation boundary, and return the queue entry WITHOUT queueing
        it.  Rejected submissions burn their id: the id in a typed error
        is never reused."""
        ticket = self._ticket
        self._ticket += 1
        try:
            return self._validate(chain, points, qformat, ticket)
        except errors.RequestError:
            stats["rejected_requests"] += 1
            raise

    def enqueue(self, p: _Pending) -> int:
        """Queue a ``validate``d entry for the next flush; returns its
        ticket.  ``submit`` is exactly ``enqueue(validate(...))``."""
        self._pending.append(p)
        return p.ticket

    def reset_stats(self) -> None:
        """Zero the module counters AND this server's report history, so
        ``stats["launches"] == sum(r.launches for r in self.reports)``
        restarts from a consistent origin."""
        reset_stats()
        self.reports = []
        self.last_report = []

    def _validate(self, chain: tc.TransformChain, points, qformat,
                  ticket: int) -> _Pending:
        """Build the queue entry, raising the typed taxonomy on anything
        the packed lane could choke on later, and apply the q-overflow
        policy to fixed-point requests."""
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
        fold = None
        if len(chain):
            fold = chain.fold()
            # projective folds legitimately carry +/-inf cull bounds
            parts = fold[:1] if chain.is_projective else fold
            if cfg.validate_finite \
                    and not all(np.isfinite(f).all() for f in parts):
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
                stats["q_fallbacks"] += 1
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
        ``quantize.quantize_fold`` the chain compiler's q lane uses."""
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

    def _stage(self, L: _Launch):
        """Host->device staging of one launch (the set-1 DMA): the pinned
        buffers are copied on the side stream, and an event marks when
        they have landed.  On the CPU the host tensors are the operands."""
        if not self._cuda:
            return L.stacked, L.packed, None
        with torch.cuda.stream(self._copy_stream):
            pts = L.packed.to(self.device, non_blocking=True)
            params = tuple(p.to(self.device, non_blocking=True)
                           for p in L.stacked)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return params, pts, ready

    def _launch(self, L: _Launch, staged) -> None:
        """Run one launch on the compute stream (set 0) and queue its
        device->host copies -- the points, and for a projective launch its
        (B, L) mask -- under one ``done`` event; on the CPU the result is
        already on the host."""
        params, pts, ready = staged
        self._count_launch(L)
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for tensor in (pts, *params):
                tensor.record_stream(compute)
        outs = L.plan.fn(params, pts)
        projective = L.plan.kind == "projective"
        if not projective:
            outs = (outs,)
        # the reference's output check, on the device: one flag a packed
        # row, padding included, as the reference's check of a singleton
        # launch at the same padded length reads it
        validate = self.fault_config.validate_outputs \
            and L.plan.qformat is None and not projective
        if validate:
            outs = (*outs, torch.isfinite(outs[0]).flatten(1).all(dim=1))
        if self._cuda:
            hosts = []
            for out in outs:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                hosts.append(host)
            outs = hosts
            L.done = torch.cuda.Event()
            L.done.record(compute)
        L.host_out = outs[0]
        L.host_mask = outs[1] if projective else None
        L.host_finite = outs[-1] if validate else None

    def _count_launch(self, L: _Launch) -> None:
        """Bookkeeping for one dispatched launch: the ONE place
        ``stats["launches"]`` moves, with the packed HBM bytes it moves
        (the _q suffix keeps the lanes separately countable, as in
        ``TransformChain``)."""
        suffix = "_q" if L.plan.qformat else ""
        opcount.record(f"serve_bucket_{L.plan.kind}{suffix}",
                       opcount.packed_chain_bytes(
                           len(L.reqs), L.lpad, L.plan.dim,
                           itemsize=L.packed.element_size(),
                           kind=L.plan.kind))
        stats["launches"] += 1
        L.report.launches += 1

    def flush(self) -> list:
        """Execute all pending requests; results in submission order."""
        pending, self._pending = self._pending, []
        results: dict[int, typing.Any] = {}
        buckets: dict[tuple, list[_Pending]] = {}
        for p in pending:
            if len(p.chain) == 0:
                results[p.ticket] = p.points   # identity passthrough
            else:                              # (empty sets reject at submit)
                buckets.setdefault(self._bucket_key(p), []).append(p)

        t_pack = time.perf_counter()
        launches: list[_Launch] = []
        self.last_report = []
        for (structure, bk, _dt, lpad), reqs in buckets.items():
            qname = reqs[0].qformat.name if reqs[0].qformat is not None \
                else None
            plan = get_batch_plan(structure, bk, qname)
            chunks = self._chunks(len(reqs), lpad)
            payload = sum(r.n for r in reqs)
            report = BucketReport(
                structure=_structure_tag(structure), kind=plan.kind,
                lpad=lpad, requests=len(reqs), payload_points=payload,
                padded_points=len(reqs) * lpad, backend=bk,
                q_fallback_requests=sum(r.q_fallback for r in reqs))
            for sl in chunks:
                stacked, packed = self._pack(reqs[sl], lpad, plan)
                launches.append(_Launch(plan=plan, lpad=lpad,
                                        stacked=stacked, packed=packed,
                                        reqs=reqs[sl], report=report))
            self.last_report.append(report)
            self.reports.append(report)
            stats["buckets"] += 1
            stats["shards"] += len(chunks) - 1
            stats["payload_points"] += payload
            stats["padded_points"] += len(reqs) * lpad

        # set 0 / set 1: stage launch k+1 while launch k computes.  Nothing
        # blocks until unpack; the copy stream runs ahead of the kernels.
        t_dispatch = time.perf_counter()
        span = self._device_span_start() if launches else None
        staged = self._stage(launches[0]) if launches else None
        for k, L in enumerate(launches):
            self._launch(L, staged)
            if k + 1 < len(launches):
                staged = self._stage(launches[k + 1])
        if span is not None:
            span[1].record(torch.cuda.current_stream(self.device))

        t_unpack = time.perf_counter()
        for L in launches:
            self._unpack(L, results)
        stats["requests"] += len(pending)
        t_end = time.perf_counter()
        self.last_timing = {"pack_s": t_dispatch - t_pack,
                            "dispatch_s": t_unpack - t_dispatch,
                            "unpack_s": t_end - t_unpack}
        if span is not None:
            self.last_timing["device_ms"] = span[0].elapsed_time(span[1])
        return [results[p.ticket] for p in pending]

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

    @staticmethod
    def _unpack(L: _Launch, results: dict) -> None:
        """Unpack one launch: wait for its device->host copies, then numpy
        slicing.  Each result is a payload-sized COPY, so no result pins
        the padded batch buffer.  A projective launch's results carry
        their rows of the cull mask as ``Projected.mask``; a fixed-point
        result is dequantised for a float submission, and a float-lane
        fallback requantised for an int16 one.  A request whose rows the
        launch flagged non-finite (``validate_outputs``) resolves to a
        ``LaunchError``."""
        if L.done is not None:
            L.done.synchronize()
        host = L.host_out.numpy()
        mask = None if L.host_mask is None else L.host_mask.numpy()
        finite = None if L.host_finite is None else L.host_finite.numpy()
        fmt = quantize.as_qformat(L.plan.qformat) if L.plan.qformat else None
        for i, r in enumerate(L.reqs):
            if finite is not None and not finite[i]:
                # inputs are finite at submit: an overflow or a corrupted
                # launch, which the reference's recovery ends in this
                results[r.ticket] = errors.LaunchError(
                    f"non-finite values in {L.plan.kind} launch output",
                    ticket=r.ticket)
                stats["failed_requests"] += 1
                L.report.failed_requests += 1
                continue
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

"""GeometryServer: plan-bucketed batched serving of transform chains.

The port of ``repro/serving/engine.py``.  Dispatching each request through
``TransformChain.apply`` pays one kernel launch per request; this engine
is the server loop, built from the paper's M1 execution discipline:

  1. **Bucket** -- pending requests group by
     ``(TransformChain.structure, backend, dtype, padded_length)``.
     Structure + backend pick one cached batch plan; the size-bucketing
     policy (``bucketing.padded_length``) picks the padded length so the
     padding waste per request stays below the cap.
  2. **Pack** -- each bucket's variable-length point sets pad and stack
     into one (B, L, d) batch in pinned host memory, and each request's
     host fold (computed once at submit, the SAME numpy fold ``apply``
     uses) stacks into the batch parameters.
  3. **Launch** -- the whole bucket runs as ONE kernel launch
     (``kernels.chain_diag_batch`` / ``chain_apply_batch``).  Buckets
     whose packed batch exceeds ``max_points_per_launch`` split into
     shards along the batch axis.
  4. **Overlap** -- the frame-buffer set-0/set-1 discipline on the GPU:
     each launch's pinned host buffers are copied to the device on a side
     stream (set 1, the DMA filling), the compute stream waits on a CUDA
     event before the kernel (set 0, the array computing), and the
     device buffers are ``record_stream``-ed to the compute stream.  So
     bucket k+1's copy overlaps bucket k's kernel.  Each launch's result
     comes back in ONE device->host copy into pinned memory; unpacking is
     numpy slicing, and results are numpy arrays, as in the reference.

Equality contract: a request's fold is bit-identical however it is
dispatched (one shared host fold), and every kernel and plain version
runs the per-request arithmetic in separately rounded ops in one order.
So packed results equal per-request ``apply`` BITWISE on every plan kind
of this slice, on the card and on the CPU, and padded rows never touch
payload rows.

Not in this slice: the recovery ladder (retry, backend degradation,
bisection), fault injection, ``submit_scene``, tracing and the
per-server metrics registry come with their own slices; the fault
counters below stay 0.  A projective chain or ``qformat=`` at ``submit``
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from repro_torch import errors
from repro_torch.core import transform_chain as tc
from repro_torch.kernels import (chain_apply_batch, chain_diag_batch,
                                 dispatch, opcount)
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


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """A bucket executor: ``fn(folded_batch, pts3) -> out``, where
    ``folded_batch`` stacks the bucket's host-folded per-request
    parameters as tensors on the points' device -- (s (B,d), t (B,d)) or
    (A (B,d,d), t (B,d))."""
    kind: str                      # "diag" | "matrix"
    dim: int
    backend: str
    fn: typing.Callable


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
        raise NotImplementedError(tc.PROJECTIVE_LATER)
    return BatchPlan(kind=kind, dim=dim, backend=backend, fn=fn)


def get_batch_plan(structure: tuple, backend: str) -> BatchPlan:
    """The cached batch plan for ``structure`` on ``backend``; mirrors
    ``transform_chain._get_plan`` and counts into the serving stats."""
    key = (structure, backend)
    plan = _BATCH_PLANS.get(key)
    if plan is None:
        stats["plan_compiles"] += 1
        plan = _BATCH_PLANS[key] = _compile_batch(structure, backend)
    else:
        stats["plan_hits"] += 1
    return plan


@dataclasses.dataclass
class _Pending:
    ticket: int
    chain: tc.TransformChain
    points: np.ndarray             # original-shape host copy
    n: int                         # flattened point count
    fold: tuple | None = None      # host fold, computed once at submit


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
    done: torch.cuda.Event | None = None


@dataclasses.dataclass
class BucketReport:
    """Per-bucket accounting for one flush (the driver prints these).
    The recovery ladder's fields join with the fault-tolerance slice."""
    structure: str                 # e.g. "2D:TSRT"
    kind: str                      # plan kind: diag | matrix
    lpad: int                      # padded points per request
    requests: int
    payload_points: int
    padded_points: int
    launches: int = 0              # dispatched: 1 unless sharded
    backend: str = ""              # the backend the bucket ran on

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
    bitwise equal to ``chain_i.apply(points_i)`` on the same device.

    ``device`` defaults to CUDA and raises without a GPU; ``backend``
    defaults to the kernels on CUDA and the plain versions on the CPU
    (``backend="ref"`` on CUDA runs the plain versions on the card).
    """

    def __init__(self, *, device: str | torch.device = "cuda",
                 backend: str | None = None,
                 min_len: int | None = None,
                 waste_cap: float | None = None,
                 max_points_per_launch: int | None = None):
        self.device = dispatch.resolve_device(device)
        self.backend = dispatch.backend_for(self.device, backend)
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

        Submit is the isolation boundary: a malformed request (bad shape,
        empty point set, float64, NaN/Inf points or parameters) raises a
        typed ``RequestError`` carrying its ticket HERE, before it can
        reach a packed bucket.  ``qformat=`` and projective chains raise
        ``NotImplementedError`` (later slices)."""
        return self.enqueue(self.validate(chain, points, qformat=qformat))

    def validate(self, chain: tc.TransformChain, points, *,
                 qformat=None) -> _Pending:
        """The intake half of ``submit``: assign a ticket id, run the
        validation boundary, and return the queue entry WITHOUT queueing
        it.  Rejected submissions burn their id: the id in a typed error
        is never reused."""
        if qformat is not None:
            raise NotImplementedError(tc.QLANE_LATER)
        if chain.is_projective:
            raise NotImplementedError(tc.PROJECTIVE_LATER)
        ticket = self._ticket
        self._ticket += 1
        try:
            return self._validate(chain, points, ticket)
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

    def _validate(self, chain: tc.TransformChain, points,
                  ticket: int) -> _Pending:
        """Build the queue entry, raising the typed taxonomy on anything
        the packed lane could choke on later."""
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        # a real copy, not a view: the queue must be immune to callers
        # mutating their buffer between submit and flush
        pts = np.array(points, copy=True)
        errors.check_points(pts, chain.dim, ticket=ticket)
        if pts.dtype != np.float32:
            raise errors.DtypeError(
                f"serving float lane is float32, got {pts.dtype}; cast "
                "before submit", ticket=ticket)
        if not np.isfinite(pts).all():
            raise errors.NonFiniteError("points contain NaN/Inf",
                                        ticket=ticket)
        fold = None
        if len(chain):
            fold = chain.fold()
            if not all(np.isfinite(f).all() for f in fold):
                raise errors.NonFiniteError(
                    "chain parameters fold to NaN/Inf", ticket=ticket)
        return _Pending(ticket, chain, pts, pts.size // chain.dim, fold=fold)

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
        return (p.chain.structure, self.backend, p.points.dtype.str, lpad)

    def _pack(self, reqs: list[_Pending], lpad: int, plan: BatchPlan):
        """Pack one launch: the (B, lpad, d) zero-padded points and the
        stack of each request's host fold, in pinned host memory when the
        server runs on CUDA (so the copy to the device is asynchronous)."""
        dim = plan.dim
        packed = torch.empty((len(reqs), lpad, dim), dtype=torch.float32,
                             pin_memory=self._cuda)
        view = packed.numpy()
        for i, r in enumerate(reqs):
            view[i, :r.n] = r.points.reshape(-1, dim)
            view[i, r.n:] = 0.0
        stacked = tuple(torch.from_numpy(np.stack(part))
                        for part in zip(*(r.fold for r in reqs)))
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
        """Run one launch on the compute stream (set 0) and queue its one
        device->host copy; on the CPU the result is already on the host."""
        params, pts, ready = staged
        self._count_launch(L)
        if not self._cuda:
            L.host_out = L.plan.fn(params, pts)
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(ready)
        for tensor in (pts, *params):
            tensor.record_stream(compute)
        out = L.plan.fn(params, pts)
        L.host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        L.host_out.copy_(out, non_blocking=True)
        L.done = torch.cuda.Event()
        L.done.record(compute)

    def _count_launch(self, L: _Launch) -> None:
        """Bookkeeping for one dispatched launch: the ONE place
        ``stats["launches"]`` moves, with the packed HBM bytes it moves."""
        opcount.record(f"serve_bucket_{L.plan.kind}",
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
            plan = get_batch_plan(structure, bk)
            chunks = self._chunks(len(reqs), lpad)
            payload = sum(r.n for r in reqs)
            report = BucketReport(
                structure=_structure_tag(structure), kind=plan.kind,
                lpad=lpad, requests=len(reqs), payload_points=payload,
                padded_points=len(reqs) * lpad, backend=bk)
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
        """Unpack one launch: wait for its device->host copy, then numpy
        slicing.  Each result is a payload-sized COPY, so no result pins
        the padded batch buffer."""
        if L.done is not None:
            L.done.synchronize()
        host = L.host_out.numpy()
        for i, r in enumerate(L.reqs):
            results[r.ticket] = np.array(host[i, :r.n].reshape(r.points.shape))

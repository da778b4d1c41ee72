"""Batched transform serving of the port (plan-bucketed scheduling).

Heterogeneous transform requests bucket by chain structure + backend (+
dtype or Qm.n format + padded size class); every bucket runs as ONE
batched kernel launch against one cached plan, and bucket k+1's
host->device copy overlaps bucket k's kernel (the paper's frame-buffer
set-0/set-1 discipline, as a side copy stream and CUDA events).  See
``serving.engine``.

Fault tolerance: ``submit`` rejects malformed requests with the typed
``serving.errors`` taxonomy; ``flush`` contains per-launch failures
behind a retry / backend-degradation / bisection ladder so no request is
ever silently lost; ``serving.faults`` is the seeded fault-injection
harness (``run_chaos_soak``).

Continuous batching: ``AsyncGeometryServer`` is the async front-end over
the same engine -- ``submit_async`` returns awaitable ``Ticket`` objects,
admission control (``serving.admission``: bounded queue depth,
per-tenant fair share + token buckets) sheds load at the intake boundary
with typed rejections, and a flush policy coupling the ``SLOConfig``
max-wait deadline to bucket fill decides when each plan bucket launches.
All its timing flows through the injectable ``serving.clock.Clock``
(``VirtualClock`` for deterministic tests, ``MonotonicClock`` for real
traffic).
"""
from repro_torch.serving import errors
from repro_torch.serving.admission import (AdmissionConfig,
                                           AdmissionController,
                                           QueueFullError, RateLimitError,
                                           TokenBucket)
from repro_torch.serving.async_engine import (AsyncGeometryServer,
                                              SLOConfig, Ticket)
from repro_torch.serving.bucketing import padded_length, waste_fraction
from repro_torch.serving.clock import (Clock, MonotonicClock, VirtualClock,
                                       percentile)
from repro_torch.serving.engine import (BatchPlan, BucketReport,
                                        FaultConfig, GeometryServer,
                                        Projected, clear_plan_cache,
                                        get_batch_plan, reset_stats, stats)
from repro_torch.serving.errors import (CorruptionError, InjectedFault,
                                        LaunchError, RequestError, is_error)
from repro_torch.serving.faults import (ChaosReport, FaultInjector, malform,
                                        run_chaos_soak)
from repro_torch.serving.workload import (AFFINE_TEMPLATES, TEMPLATES,
                                          chain_for, mixed_lane_workload,
                                          random_workload)

__all__ = [
    "AFFINE_TEMPLATES", "AdmissionConfig", "AdmissionController",
    "AsyncGeometryServer", "BatchPlan", "BucketReport", "ChaosReport",
    "Clock", "CorruptionError", "FaultConfig", "FaultInjector",
    "GeometryServer", "InjectedFault", "LaunchError", "MonotonicClock",
    "Projected", "QueueFullError", "RateLimitError",
    "RequestError", "SLOConfig", "TEMPLATES", "Ticket", "TokenBucket",
    "VirtualClock", "chain_for", "clear_plan_cache", "errors",
    "get_batch_plan", "is_error", "malform", "mixed_lane_workload",
    "padded_length", "percentile", "random_workload", "reset_stats",
    "run_chaos_soak", "stats", "waste_fraction",
]

"""Batched transform serving of the port (plan-bucketed scheduling).

Heterogeneous transform requests bucket by chain structure + backend (+
dtype or Qm.n format + padded size class); every bucket runs as ONE batched kernel launch
against one cached plan, and bucket k+1's host->device copy overlaps
bucket k's kernel (the paper's frame-buffer set-0/set-1 discipline, as a
side copy stream and CUDA events).  See ``serving.engine``.
"""
from repro_torch.serving import errors
from repro_torch.serving.bucketing import padded_length, waste_fraction
from repro_torch.serving.engine import (BatchPlan, BucketReport,
                                        FaultConfig, GeometryServer,
                                        Projected,
                                        clear_plan_cache, get_batch_plan,
                                        reset_stats, stats)
from repro_torch.serving.errors import (CorruptionError, LaunchError,
                                        RequestError, is_error)
from repro_torch.serving.workload import (AFFINE_TEMPLATES, TEMPLATES,
                                          chain_for, mixed_lane_workload,
                                          random_workload)

__all__ = [
    "AFFINE_TEMPLATES", "BatchPlan", "BucketReport", "CorruptionError",
    "FaultConfig", "GeometryServer", "LaunchError", "Projected", "RequestError",
    "TEMPLATES",
    "chain_for", "clear_plan_cache", "errors", "get_batch_plan",
    "is_error", "mixed_lane_workload", "padded_length", "random_workload",
    "reset_stats", "stats", "waste_fraction",
]

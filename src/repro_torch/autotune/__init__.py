"""Autotune: analytic cost models + on-device search for the port.

The port of ``repro/autotune``.  Every tunable kernel (the chain kernels,
``matmul``, ``rmsnorm``) and the serving engine's size-bucket grid can be
driven from a persisted tuning cache, the TPU's launch knobs become
Hopper's (a block's threads and the grid's waves for the chain kernels,
``matmul_2d``'s wgmma tile width and ring stages, ``rmsnorm_2d``'s warps
a row):

    candidate space --analytic prune--> survivors --timer on the card-->
    winner --JSON cache--> consulted at every launch

Three layers:

  * ``costmodel``  -- closed-form HBM-byte / FLOP / launch / wave-tail
    models sharing the ``kernels.opcount`` accounting, printable in the
    paper's table format and cross-checked against the MorphoSys cycle
    emulator;
  * ``search`` + ``cache`` -- candidate generation, pruning, the
    best-of-iters timer (CUDA events on the card), and the JSON winners
    cache keyed by (kernel, backend, dtype, size-class);
  * integration -- ``core.transform_chain`` plans, the serving engine's
    batch plans and size grid, and ``kernels.matmul``/``kernels.rmsnorm``
    consult ``config_for`` when tuning is enabled.

Tuning is OFF by default: ``config_for`` then returns the deterministic
``DEFAULTS`` (the launches of before the knobs), so nothing changes until
``repro_torch.autotune.set_enabled(True)`` (or ``REPRO_TORCH_AUTOTUNE=1``).
The committed ``default_cache.json`` holds the ``cuda`` winners of one
smoke search on an H100.  CLI::

    python -m repro_torch.autotune --smoke            # on the GPU
    python -m repro_torch.autotune --smoke --check --device cpu
"""
from __future__ import annotations

from repro_torch.autotune.cache import (DEFAULT_CACHE_PATH, DEFAULTS,
                                        KernelConfig, TuningCache, cache_key,
                                        config_for, enabled, set_cache,
                                        set_cache_path, size_class, the_cache)

__all__ = [
    "DEFAULT_CACHE_PATH", "DEFAULTS", "KernelConfig", "TuningCache",
    "cache_key", "config_for", "enabled", "set_cache", "set_cache_path",
    "set_enabled", "size_class", "the_cache", "smoke_search", "tune_chain",
    "tune_chain_batch", "tune_serving_grid", "tune_matmul", "tune_rmsnorm",
]

_SEARCH = ("smoke_search", "tune_chain", "tune_chain_batch",
           "tune_serving_grid", "tune_matmul", "tune_rmsnorm")


def set_enabled(on: bool | None) -> None:
    """Enable/disable cache consultation process-wide AND drop the chain
    and serving plan caches, as the JAX package's does (there a compiled
    plan captures its config at trace time)."""
    from repro_torch.autotune import cache as _cache
    _cache.set_enabled(on)
    from repro_torch.core import transform_chain
    from repro_torch.serving import engine
    transform_chain.clear_plan_cache()
    engine.clear_plan_cache()


def __getattr__(name: str):
    # search (and through it the kernels) loads lazily so that importing
    # repro_torch.autotune.cache from kernel ops modules stays cycle-free
    if name in _SEARCH:
        from repro_torch.autotune import search
        return getattr(search, name)
    if name in ("costmodel", "search"):
        import importlib
        return importlib.import_module(f"repro_torch.autotune.{name}")
    raise AttributeError(f"module 'repro_torch.autotune' has no attribute "
                         f"{name!r}")

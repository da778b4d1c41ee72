"""Tuning cache: persisted launch-parameter winners + deterministic defaults.

The port of ``repro/autotune/cache.py`` (a copy: the port imports nothing
of the JAX package), with the TPU's launch knobs replaced by Hopper's:

  * ``KernelConfig`` -- one kernel's launch parameters: the block size and
    grid waves of the chain kernels, ``matmul_2d``'s wgmma tile width and
    ring depth, ``rmsnorm_2d``'s warps a row, and the serving size-grid
    knobs.  Every field the kernels read is optional; ``None`` means "use
    the kernel's built-in choice", which is exactly what the launches did
    before the knobs existed (a wrapper passes it to its C entry as 0).
  * ``DEFAULTS`` -- the deterministic configuration used whenever tuning
    is disabled or the cache has no entry: an explicit value where the
    kernels had a constant (256 threads a block, 4 stages), ``None``
    where they had a heuristic (the grid caps, ``matmul_2d``'s choice of
    BN by SM fill, ``rmsnorm_2d``'s warps for the row).  Tuning disabled
    is the launch of before, bit for bit.
  * ``TuningCache`` -- a JSON-persisted map from
    ``(kernel, backend, dtype, size-class)`` to a winning config.  The
    port commits ``default_cache.json``: the ``cuda`` winners of one
    ``python -m repro_torch.autotune --smoke --write-default`` run on an
    H100 (PERF.md names the card).  A winners file of the JAX package
    holds TPU fields (``block_rows``, ``lane_target``, ``bm``, ``bk``)
    that no Hopper kernel reads, and ``TuningCache.load`` refuses it.

Size classes are power-of-two buckets of the problem size (``p<k>`` holds
sizes in (2^(k-1), 2^k]), the granularity the serving engine buckets
request lengths at; lookups fall back to the nearest tuned class before
falling back to the default config.

This module is stdlib-only on purpose: kernel ``ops.py`` entries import it
at module load, and it must never import back into ``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
import json
import os

#: env switches (read at every lookup until ``set_enabled`` overrides),
#: named apart from the JAX package's so that a process holding both
#: packages never enables one through the other:
#:   REPRO_TORCH_AUTOTUNE=1        -- consult the tuning cache
#:   REPRO_TORCH_AUTOTUNE_CACHE=p  -- load winners from ``p`` instead of
#:                                    the committed default_cache.json
ENV_ENABLE = "REPRO_TORCH_AUTOTUNE"
ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"

DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "default_cache.json")

#: kernels the tuner knows how to search, and what each tunes:
#:   chain_diag / chain_apply / chain_project -- block threads + grid waves
#:   chain_diag_q / chain_apply_q       -- same knobs, int16 Qm.n lane
#:                                         (cached under the format name
#:                                         as the dtype, e.g. "q8.7")
#:   chain_diag_batch / chain_apply_batch / chain_project_batch
#:   chain_diag_batch_q / chain_apply_batch_q
#:                                      -- grid waves (16-byte kernels),
#:                                         block threads + waves (scalar)
#:   matmul                             -- wgmma tile width BN + ring stages
#:   rmsnorm                            -- warps a row (16-byte kernel)
#:   serving_grid                       -- size-bucket grid floor + waste cap
TUNABLE_KERNELS = ("chain_diag", "chain_apply", "chain_project",
                   "chain_diag_q", "chain_apply_q",
                   "chain_diag_batch", "chain_apply_batch",
                   "chain_project_batch", "chain_diag_batch_q",
                   "chain_apply_batch_q", "matmul", "rmsnorm",
                   "serving_grid")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Launch parameters for one kernel family.  ``None`` fields defer to
    the kernel's built-in choice; only the fields a kernel reads are
    meaningful for it.  ``source`` records where the config came from:
    ``default`` (deterministic fallback), ``tuned`` (fresh search winner
    this process), or ``cached`` (loaded winners file)."""
    kernel: str
    block_threads: int | None = None   # scalar chain kernels: a block
    waves: int | None = None           # chain kernels: grid cap in waves
    bn: int | None = None              # matmul_2d wgmma tile width
    stages: int | None = None          # matmul_2d shared-memory ring depth
    row_warps: int | None = None       # rmsnorm_2d 16-byte kernel: a row
    grid_min_len: int | None = None    # serving size grid: floor
    grid_waste_cap: float | None = None  # serving size grid: padding cap
    source: str = "default"

    def key_fields(self) -> dict:
        """The tunable payload (everything except kernel/source) with
        ``None`` fields dropped -- what gets persisted and compared."""
        d = dataclasses.asdict(self)
        del d["kernel"], d["source"]
        return {k: v for k, v in d.items() if v is not None}

    def describe(self) -> str:
        """Compact ``k=v`` summary for reports."""
        fields = self.key_fields()
        body = ",".join(f"{k}={v}" for k, v in sorted(fields.items()))
        return f"{self.source}({body})" if body else self.source


#: the fields a winners file may hold (the payload of ``key_fields``)
_FIELDS = frozenset(f.name for f in dataclasses.fields(KernelConfig)) \
    - {"kernel", "source"}

#: the deterministic defaults: the launches of before the knobs.  Tuning
#: disabled == this table.
DEFAULTS: dict[str, KernelConfig] = {
    # the scalar chain kernels launched repro::kThreads = 256 threads a
    # block (csrc/launch.cuh); their grid caps are heuristics (None)
    "chain_diag": KernelConfig("chain_diag", block_threads=256),
    "chain_apply": KernelConfig("chain_apply", block_threads=256),
    "chain_project": KernelConfig("chain_project", block_threads=256),
    "chain_diag_q": KernelConfig("chain_diag_q", block_threads=256),
    "chain_apply_q": KernelConfig("chain_apply_q", block_threads=256),
    # batch kernels: the scalar kernel's 256 threads; the 16-byte kernels'
    # block (kVecThreads) is no knob, their one-wave grid a heuristic
    "chain_diag_batch": KernelConfig("chain_diag_batch", block_threads=256),
    "chain_apply_batch": KernelConfig("chain_apply_batch",
                                      block_threads=256),
    "chain_project_batch": KernelConfig("chain_project_batch",
                                        block_threads=256),
    "chain_diag_batch_q": KernelConfig("chain_diag_batch_q",
                                       block_threads=256),
    "chain_apply_batch_q": KernelConfig("chain_apply_batch_q",
                                        block_threads=256),
    # matmul_2d's wgmma ring held 4 stages; its BN is chosen by SM fill
    "matmul": KernelConfig("matmul", stages=4),
    # rmsnorm_2d's warps a row come from the row's width (warps_for)
    "rmsnorm": KernelConfig("rmsnorm"),
    "serving_grid": KernelConfig("serving_grid", grid_min_len=8,
                                 grid_waste_cap=0.5),
}


def size_class(n: int) -> str:
    """Power-of-two size-class label: ``p<k>`` holds n in (2^(k-1), 2^k].
    The serving engine buckets request lengths at the same granularity, so
    one tuned entry covers one padded-length class."""
    return f"p{max(0, int(n - 1).bit_length())}" if n > 0 else "p0"


def _class_index(label: str) -> int:
    return int(label[1:])


def cache_key(kernel: str, backend: str, dtype: str, n: int = 0) -> str:
    """The cache's key of (kernel, backend, dtype, size class of n)."""
    return f"{kernel}|{backend}|{dtype}|{size_class(n)}"


class TuningCache:
    """A map from cache keys to winning ``KernelConfig``s with JSON
    persistence.  Entries are stored sorted so the same winners always
    serialize to the same bytes (the determinism tests diff files)."""

    def __init__(self, entries: dict[str, KernelConfig] | None = None):
        self.entries: dict[str, KernelConfig] = dict(entries or {})

    # -- lookup --------------------------------------------------------------

    def get(self, kernel: str, backend: str, dtype: str = "float32",
            n: int = 0) -> KernelConfig | None:
        """Exact-key lookup, then nearest tuned size-class for the same
        (kernel, backend, dtype), else None."""
        exact = self.entries.get(cache_key(kernel, backend, dtype, n))
        if exact is not None:
            return exact
        prefix = f"{kernel}|{backend}|{dtype}|"
        want = _class_index(size_class(n))
        best = None
        for key, cfg in self.entries.items():
            if not key.startswith(prefix):
                continue
            dist = abs(_class_index(key.rsplit("|", 1)[1]) - want)
            # deterministic tie-break: prefer the smaller class
            rank = (dist, _class_index(key.rsplit("|", 1)[1]))
            if best is None or rank < best[0]:
                best = (rank, cfg)
        return best[1] if best else None

    def put(self, kernel: str, backend: str, dtype: str, n: int,
            config: KernelConfig) -> None:
        """Store ``config`` under n's size class."""
        self.entries[cache_key(kernel, backend, dtype, n)] = config

    def __len__(self) -> int:
        return len(self.entries)

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        """The canonical winners file: sorted keys, ``version: 1``."""
        payload = {key: dict(sorted(cfg.key_fields().items()))
                   for key, cfg in sorted(self.entries.items())}
        return json.dumps({"version": 1, "entries": payload}, indent=1,
                          sort_keys=True) + "\n"

    def save(self, path: str) -> None:
        """Write ``to_json()`` to ``path``."""
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        """Read a winners file; raises ``ValueError`` on a field no
        Hopper kernel reads (a TPU winners file is never GPU winners)."""
        with open(path) as f:
            doc = json.load(f)
        entries = {}
        for key, fields in doc.get("entries", {}).items():
            unknown = sorted(set(fields) - _FIELDS)
            if unknown:
                raise ValueError(
                    f"{path}: entry {key!r} holds {unknown}, which no "
                    f"kernel of the port reads (its knobs are "
                    f"{sorted(_FIELDS)}); a winners file of the JAX "
                    "package's TPU kernels is not one of these")
            kernel = key.split("|", 1)[0]
            entries[key] = KernelConfig(kernel=kernel, source="cached",
                                        **fields)
        return cls(entries)


# -- module state: the process-wide cache + enable switch --------------------

_ENABLED: bool | None = None          # None -> read env on every lookup
_CACHE: TuningCache | None = None
_CACHE_PATH: str | None = None        # None -> env or committed default


def enabled() -> bool:
    """Whether lookups consult the cache: ``set_enabled``'s value, else
    ``$REPRO_TORCH_AUTOTUNE``."""
    if _ENABLED is not None:
        return _ENABLED
    return os.environ.get(ENV_ENABLE, "") in ("1", "true", "yes")


def set_enabled(on: bool | None) -> None:
    """Flip cache consultation on/off (``None`` re-reads the env var).
    Use ``repro_torch.autotune.set_enabled``, which also clears the plan
    caches, as the JAX package's does."""
    global _ENABLED
    _ENABLED = on


def set_cache_path(path: str | None) -> None:
    """Point the process at a different winners file (``None`` -> env /
    committed default) and drop the loaded cache."""
    global _CACHE_PATH, _CACHE
    _CACHE_PATH = path
    _CACHE = None


def set_cache(cache: TuningCache | None) -> None:
    """Install an in-memory cache directly (tests, fresh tuning runs)."""
    global _CACHE
    _CACHE = cache


def the_cache() -> TuningCache:
    """The process-wide winners cache, loaded lazily from (in order)
    ``set_cache_path``, ``$REPRO_TORCH_AUTOTUNE_CACHE``, the committed
    ``default_cache.json``, else empty."""
    global _CACHE
    if _CACHE is None:
        path = _CACHE_PATH or os.environ.get(ENV_CACHE) or DEFAULT_CACHE_PATH
        _CACHE = TuningCache.load(path) if os.path.exists(path) \
            else TuningCache()
    return _CACHE


def config_for(kernel: str, backend: str, dtype: str = "float32",
               n: int = 0) -> KernelConfig:
    """THE lookup the integrated consumers call: the cached winner for
    (kernel, backend, dtype, size-class) when tuning is enabled, else the
    deterministic default.  Unknown kernels get an all-``None`` config
    (every field defers to the kernel's own choice)."""
    default = DEFAULTS.get(kernel, KernelConfig(kernel))
    if not enabled():
        return default
    hit = the_cache().get(kernel, backend, dtype, n)
    return hit if hit is not None else default


def merge(fallback: KernelConfig, override: KernelConfig) -> KernelConfig:
    """``override`` with its ``None`` fields filled from ``fallback``."""
    fields = {f.name: getattr(override, f.name)
              if getattr(override, f.name) is not None
              else getattr(fallback, f.name)
              for f in dataclasses.fields(KernelConfig)
              if f.name not in ("kernel", "source")}
    return KernelConfig(kernel=override.kernel, source=override.source,
                        **fields)


def dtype_name(dtype) -> str:
    """The cache's name of a tensor dtype: ``torch.float32`` ->
    ``"float32"``, the name the JAX package's keys carry."""
    return str(dtype).removeprefix("torch.")

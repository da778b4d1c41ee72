"""Content-hash fold CSE: digests of chain content + the shared FoldCache.

A copy of the JAX package's ``scene/cache.py`` on the port's
``obs.metrics``: the digests are the same bytes, so a cache key names
the same content in both packages.

The scene graph never keys a fold on an object identity or an insertion
order -- it keys on WHAT is being folded: a ``blake2b`` digest over the
chain structure (dim + primitive kinds) and the float32-canonical bytes
of every parameter leaf.  Two subchains with equal content digest fold to
bit-identical carries (the fold casts parameters to float32 first, so
float32-canonical bytes are exactly the fold's input domain), which is
what makes a cache entry reusable across nodes, scenes, requests and
processes: the digest is a pure function of content, never of
``PYTHONHASHSEED``, id(), or construction history.

A node's WORLD digest chains its parent's world digest with its local
digest, so it names the whole root->node prefix; the cache key adds the
fold kind (``plan_kind_of`` of the full chain being resolved -- the same
prefix folds to a different carry under a diag vs a matrix loop, see
``transform_chain.fold_carry_extend``).

Counters (module ``stats``, a ``StatsView`` over the ``scene`` registry,
exported by Prometheus/profiler like the serving counters):

  folds        -- ``fold_carry_extend`` executions (cache-miss work; the
                  bench gate's "folds per frame == changed nodes" counts
                  exactly this)
  cache_misses -- lookups that missed; every miss is followed by exactly
                  one fold + store, so ``cache_misses == folds`` always
  cse_hits     -- lookups served from the cache: a subchain folded for
                  one node/request reused by another
  refolds      -- folds for a (node, kind) that had folded before, i.e.
                  dirty-driven recomputation rather than first contact
  dirtied      -- nodes invalidated by ``SceneGraph.set_local``
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.obs import metrics as obsm

_STAT_KEYS = ("folds", "cache_misses", "cse_hits", "refolds", "dirtied")

#: the scene registry behind the module ``stats`` view
#: (``obs.export.prometheus_text(REGISTRY)`` exposes it)
REGISTRY = obsm.MetricsRegistry("scene")

#: dict-facade over the counters above, same discipline as
#: ``serving.stats``
stats = obsm.StatsView(REGISTRY, _STAT_KEYS)


def reset_stats() -> None:
    """Zero the module counters (cache CONTENTS are separate state --
    ``FoldCache.clear`` / ``shared_cache().clear`` for those)."""
    for k in stats:
        stats[k] = 0


def _leaf_bytes(x, h) -> None:
    """Feed one parameter leaf (or nested tuple of leaves) to the digest
    in float32-canonical form -- the exact value domain the host fold
    reads -- with shape framing so (2,) and (1, 2) never collide."""
    if isinstance(x, (tuple, list)):
        h.update(b"(%d" % len(x))
        for e in x:
            _leaf_bytes(e, h)
        h.update(b")")
        return
    a = np.asarray(x, np.float32)
    h.update(b"[%d" % a.ndim)
    h.update(np.asarray(a.shape, np.int64).tobytes())
    h.update(a.tobytes())
    h.update(b"]")


def chain_digest(dim: int, kinds: tuple, params: tuple) -> bytes:
    """Content digest of one (sub)chain: a pure function of dim, the
    primitive kind/axis sequence, and float32-canonical parameter bytes.
    Equal digests imply bit-identical folds; stable across processes and
    hash seeds (``blake2b``, not built-in ``hash``)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"chain:%d:" % dim)
    for k, axis in kinds:
        h.update(b"%s%d;" % (k.encode(), axis))
    _leaf_bytes(params, h)
    return h.digest()


def path_digest(parent_world: bytes | None, local: bytes) -> bytes:
    """World digest of a node: chain the parent's world digest with the
    node's local digest, naming the whole root->node prefix by content.
    ``None`` parent marks a root (an explicit tag, so a root chain and a
    child of an empty-digest parent cannot collide)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"root:" if parent_world is None else b"path:" + parent_world)
    h.update(local)
    return h.digest()


class FoldCache:
    """The shared fold store: (world digest, fold kind) -> fold carry.

    Deliberately dumb -- lookup, store, clear -- so the CSE policy lives
    in one place (``SceneGraph``) and a cache object can be shared by any
    number of scenes: a subchain folded while resolving one scene's node
    is served to every other scene that names the same content.  Folded
    carries are immutable by convention (the fold constructs fresh
    arrays; nothing mutates them after store)."""

    def __init__(self):
        """Start empty; share one instance across scenes for CSE (the
        module's ``shared_cache()`` is the default everyone gets)."""
        self._carries: dict[tuple[bytes, str], tuple] = {}

    def __len__(self) -> int:
        """Number of cached (subchain, kind) fold entries."""
        return len(self._carries)

    def lookup(self, key: tuple[bytes, str]):
        """Return the cached carry for ``key`` or None; counts the
        module ``cse_hits`` / ``cache_misses`` counters."""
        c = self._carries.get(key)
        if c is None:
            stats["cache_misses"] += 1
        else:
            stats["cse_hits"] += 1
        return c

    def store(self, key: tuple[bytes, str], carry: tuple) -> None:
        """Save a freshly folded carry under its content key."""
        self._carries[key] = carry

    def clear(self) -> None:
        """Drop every entry (counters are ``reset_stats``'s job)."""
        self._carries.clear()


_SHARED = FoldCache()


def shared_cache() -> FoldCache:
    """The process-wide default ``FoldCache`` -- every ``SceneGraph``
    built without an explicit cache shares it, which is what makes the
    CSE *cross-request*: request handlers building scenes independently
    still fold each shared subchain once per process."""
    return _SHARED

"""Scene graph over the chain compiler: shared prefixes fold once.

The port of the JAX package's ``scene`` package (``cache.py`` and
``graph.py`` are copies on the port's ``transform_chain`` and ``obs``;
the scene graph is host numpy and imports no kernel).

Real transform traffic is a hierarchy, not independent chains -- the
companion graphics paper's pipelines (world -> camera -> projection ->
viewport) hang thousands of leaf payloads off a handful of shared
stages.  This package is the IR for that shape:

  * ``SceneGraph`` / ``SceneNode`` (``graph.py``) -- named nodes with
    local ``TransformChain``s, parent links and per-node dirty bits; a
    node's world chain is the root -> node concatenation.
  * ``FoldCache`` + content digests (``cache.py``) -- world folds are
    cached under (content digest of the prefix, fold kind) in a cache
    shared across scenes and requests, so a subchain folded for one
    node is never refolded for another; editing a node dirties exactly
    its subtree and the next resolution folds O(changed nodes).

The bitwise contract: a cached world fold extends the parent's saved
fold state through the SAME loop ``fold_structure`` runs
(``transform_chain.fold_carry_extend``), so it is bit-identical to
folding the node's whole world chain from scratch -- which is why
``GeometryServer.submit_scene`` can hand the cached fold straight to the
packed serving lane (float32 and Qm.n both) without weakening the
engine's packed-vs-apply equality.  Counters (``scene.stats``: folds,
cse_hits, cache_misses, refolds, dirtied) and trace instants
(``scene.fold`` / ``scene.cse_hit`` / ``scene.refold``) make the CSE
exactly gateable: ``tests/test_torch_scene.py`` holds them equal to the
JAX package's through the same edit script, and ``chip_smoke.py``'s
scene phase gates ``folds == dirtied`` every frame on the card.
"""
from repro_torch.scene.cache import (FoldCache, REGISTRY, chain_digest,
                               path_digest, reset_stats, shared_cache,
                               stats)
from repro_torch.scene.graph import SceneGraph, SceneNode

__all__ = [
    "FoldCache", "REGISTRY", "SceneGraph", "SceneNode", "chain_digest",
    "path_digest", "reset_stats", "shared_cache", "stats",
]

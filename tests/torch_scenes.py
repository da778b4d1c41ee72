"""The scene benchmark's two animated scenes, for the port's scene tests and
``chip_smoke.py``'s scene phase: a copy of ``benchmarks/scene_bench.py``'s
builders (world -> camera -> B branch roots -> L leaves a branch, one
branch root re-posed a frame), written against whichever package's
``scene`` and ``transform_chain`` modules the caller passes, so one
script builds the same scene in the JAX package and in the port.  It
imports neither.

The scene counters (``folds``, ``cache_misses``, ``cse_hits``,
``refolds``, ``dirtied``) depend on the tree and the edit script, never
on the points: ``resolve_frames`` runs the script with the world-fold
lookups that ``submit_scene`` makes, and ``CARD_COUNTERS`` pins what it
gives at the card's tree shape (``tests/test_torch_scene.py`` holds the
JAX package and the port to it; ``chip_smoke.py`` holds the card's serve
to it).
"""
from __future__ import annotations

import numpy as np

#: the reference's smoke row (``scene_bench.run(smoke=True)``)
SMOKE = dict(frames=6, branches=4, leaves=4, points=64)
#: the card's scene phase: 8 branches of 64 leaves (512 leaves), 16 384
#: points a leaf (the mixed serve's median request), 30 frames
CARD = dict(frames=30, branches=8, leaves=64, points=16384)
#: seed of the leaves' points (``scene_bench.SCENE_SEED``)
SCENE_SEED = 3104
#: world-fold resolutions a leaf a frame: each frame serves every leaf
#: twice through ``submit_scene`` (q8.7 and float32), beside a plain
#: ``submit`` of its world chain
PER_LEAF = 2

_KEYS = ("folds", "cache_misses", "cse_hits", "refolds", "dirtied")


def _f(x) -> np.float32:
    return np.float32(x)


def branch_pose(tc, branch: int, frame: int):
    """The animated 2D branch-root local: frame-indexed float32 content,
    so every edit is fresh content (never a revert to a cached fold)."""
    return (tc.TransformChain.identity(2)
            .scale(_f(1.0 + 0.125 * branch))
            .translate(_f(0.25 * frame + branch), _f(0.5 * branch)))


def build_diag_scene(sc, tc, branches: int, leaves: int):
    """World -> camera -> branches -> leaves, all translate/scale/affine
    locals (diagonal plans); returns (graph, leaf names)."""
    g = sc.SceneGraph(2, cache=sc.FoldCache())
    g.add("world", tc.TransformChain.identity(2).translate(_f(0.5),
                                                           _f(-0.25)))
    g.add("camera", tc.TransformChain.identity(2)
          .affine((_f(0.5), _f(0.5)), (_f(1.0), _f(2.0))), parent="world")
    names = []
    for b in range(branches):
        g.add(f"b{b}", branch_pose(tc, b, 0), parent="camera")
        for leaf in range(leaves):
            names.append(g.add(
                f"b{b}/l{leaf}",
                tc.TransformChain.identity(2)
                .affine(_f(1.0 + 0.0625 * leaf), (_f(0.125 * leaf), _f(b))),
                parent=f"b{b}"))
    return g, names


def pose3(tc, branch: int, frame: int):
    """The animated 3D branch-root local."""
    return (tc.TransformChain.identity(3)
            .scale(_f(1.0 + 0.0625 * branch))
            .translate(_f(0.0625 * frame), _f(0.125 * branch), _f(0.0)))


def build_matrix_scene(sc, tc, branches: int, leaves: int):
    """The same tree in 3D under a rotating camera: every leaf's world
    chain is matrix kind; returns (graph, leaf names)."""
    g = sc.SceneGraph(3, cache=sc.FoldCache())
    g.add("world", tc.TransformChain.identity(3)
          .translate(_f(0.25), _f(0.0), _f(0.5)))
    g.add("camera", tc.TransformChain.identity(3)
          .rotate(_f(0.4), axis=1).translate(_f(0.0), _f(0.0), _f(-2.0)),
          parent="world")
    names = []
    for b in range(branches):
        g.add(f"b{b}", pose3(tc, b, 0), parent="camera")
        for leaf in range(leaves):
            names.append(g.add(
                f"b{b}/l{leaf}",
                tc.TransformChain.identity(3)
                .affine(_f(0.5), (_f(0.125 * leaf), _f(0.0625 * b),
                                  _f(0.0))),
                parent=f"b{b}"))
    return g, names


BUILD = {"diag": (build_diag_scene, branch_pose),
         "matrix": (build_matrix_scene, pose3)}


def leaf_points(rng: np.random.Generator, n_leaves: int, n_points: int,
                dim: int) -> list:
    """Each leaf's float32 points, uniform in [-2, 2)."""
    return [rng.uniform(-2, 2, (n_points, dim)).astype(np.float32)
            for _ in range(n_leaves)]


def edit(sc, tc, g, kind: str, frame: int, branches: int) -> int:
    """Frame ``frame`` (from 1)'s edit: re-pose branch (frame - 1) mod B;
    returns the nodes it dirtied."""
    b = (frame - 1) % branches
    return g.set_local(f"b{b}", BUILD[kind][1](tc, b, frame))


def resolve_frames(sc, tc, kind: str, *, frames: int, branches: int,
                   leaves: int, **_) -> tuple[list, dict]:
    """The scene phase's edit script without points: build the scene,
    resolve every leaf once (the warm frame), zero the counters, then
    each frame edit one branch root and resolve every leaf's world fold
    ``PER_LEAF`` times, as that many ``submit_scene`` calls do.
    Returns ([(dirtied, folds)] a frame, the counters)."""
    g, names = BUILD[kind][0](sc, tc, branches, leaves)
    for n in names:
        g.world_fold(n)
    sc.reset_stats()
    per_frame = []
    for frame in range(1, frames + 1):
        before = sc.stats["folds"]
        dirtied = edit(sc, tc, g, kind, frame, branches)
        for n in names:
            for _ in range(PER_LEAF):
                g.world_fold(n)
        per_frame.append((dirtied, sc.stats["folds"] - before))
    return per_frame, {k: sc.stats[k] for k in _KEYS}


#: the counters at the card's tree shape (CARD), either scene, as the
#: JAX package gives them (``tests/test_torch_scene.py``): a frame dirties
#: and refolds one branch root and its 64 leaves (30 x 65), and each of
#: the 2 x 512 leaf resolutions a frame ends in one cache hit, its own key
#: or its nearest clean ancestor's (30 x 1024)
CARD_COUNTERS = {"folds": 1950, "cache_misses": 1950, "cse_hits": 30720,
                 "refolds": 1950, "dirtied": 1950}

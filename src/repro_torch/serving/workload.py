"""Synthetic mixed serving workloads (shared by tests, benchmarks, drivers).

The port of ``repro/serving/workload.py``: the same templates and the same
numpy draws in the same order, so a seed gives the same requests in both
packages (the chains are the port's ``TransformChain``).

A workload draws from a bounded pool of chain *structures* (the thing the
engine buckets by) while every request gets fresh parameter values and a
fresh variable-length point set -- the serving hot path the plan cache was
built for: many requests, few structures.  ``timed`` is the one shared
wall-clock helper, so the benchmark rows and the driver's printed numbers
cannot measure differently.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.transform_chain import TransformChain


def timed(fn) -> float:
    """Seconds for one call of ``fn()``, including the device work it
    queued: CUDA is synchronised before the clock stops (when CUDA is in
    use in this process)."""
    t0 = time.perf_counter()
    fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0

#: structure templates: (dim, kind string).  A workload samples a subset,
#: mixing diagonal (TS/A-only), general (R/M), and projective (P/C --
#: graphics viewing pipelines) chains across 2D and 3D.  New templates
#: append at the END so seeded prefixes (``TEMPLATES[:k]``) stay
#: bit-reproducible across PRs.
TEMPLATES: tuple[tuple[int, str], ...] = (
    (2, "TSRT"),          # the paper's translate/scale/rotate composite
    (2, "TST"),           # diagonal: folds to one affine (s, t) plan
    (2, "R"),             # bare rotation
    (2, "ASM"),           # affine + scale + custom matrix
    (3, "TRS"),           # 3D pipeline (rotation about a random axis)
    (3, "SAT"),           # 3D diagonal
    (3, "RMRT"),          # 3D general with custom matrix
    (2, "TTSS"),          # diagonal, exercises translate/scale folding
    (3, "TSRP"),          # model affines + perspective projection
    (3, "MPC"),           # camera (look-at affine) + projection + cull
    (2, "TSP"),           # 2D projective touch-up
)

#: the affine-only template subset: structures the fixed-point (Qm.n)
#: lane can execute (projective primitives P/C have no q form)
AFFINE_TEMPLATES: tuple[tuple[int, str], ...] = tuple(
    t for t in TEMPLATES if not set(t[1]) & {"P", "C"})


def random_projective(rng: np.random.Generator, dim: int) -> np.ndarray:
    """A well-conditioned random (d+1, d+1) projective matrix: a gentle
    perspective column keeps w = 1 + p.c positive for typical workload
    points (outliers get culled by the w > 0 mask, which is itself part
    of what the serving path must reproduce).  The ONE recipe for served
    traffic (``chain_for``)."""
    m = np.eye(dim + 1, dtype=np.float32)
    m[:dim, :dim] += rng.uniform(-0.3, 0.3, (dim, dim))
    m[dim, :dim] = rng.uniform(-1, 1, dim)
    m[:dim, dim] = rng.uniform(-0.05, 0.05, dim)
    return m


def chain_for(rng: np.random.Generator, dim: int, kinds: str) -> TransformChain:
    """A chain with the given structure and fresh random parameters."""
    chain = TransformChain.identity(dim)
    for kind in kinds:
        if kind == "T":
            chain = chain.translate(*rng.uniform(-3, 3, dim).tolist())
        elif kind == "S":
            chain = chain.scale(*rng.uniform(0.2, 2.0, dim).tolist())
        elif kind == "R":
            theta = float(rng.uniform(-np.pi, np.pi))
            chain = chain.rotate(theta) if dim == 2 else \
                chain.rotate(theta, axis=int(rng.integers(3)))
        elif kind == "A":
            chain = chain.affine(rng.uniform(0.2, 2.0, dim).tolist(),
                                 rng.uniform(-2, 2, dim).tolist())
        elif kind == "M":
            m = np.eye(dim + 1, dtype=np.float32)
            m[:dim, :dim] += rng.uniform(-0.4, 0.4, (dim, dim))
            m[dim, :dim] = rng.uniform(-2, 2, dim)
            chain = chain.matrix(m)
        elif kind == "P":
            chain = chain.projective(random_projective(rng, dim))
        elif kind == "C":
            chain = chain.cull(float(rng.uniform(-6, -3)),
                               float(rng.uniform(3, 6)))
        else:
            raise ValueError(f"unknown primitive kind {kind!r}")
    return chain


def random_workload(rng: np.random.Generator | int | None = None,
                    n_requests: int | None = None, *, seed: int | None = None,
                    templates=TEMPLATES, max_points: int = 512,
                    min_points: int = 1, sigma: float = 0.7):
    """``n_requests`` (chain, points) pairs: structures cycle through the
    template pool, parameters are random per request, and point counts are
    lognormal around sqrt(min*max) -- serving traffic concentrates around
    a typical request size rather than spreading uniformly, which is what
    makes size-bucketed packing effective.

    Randomness is seedable end-to-end: pass ``seed=`` (or an int / fresh
    Generator as ``rng``) and every draw -- structure parameters, point
    counts, point coordinates -- comes from that one stream, so two calls
    with the same seed and arguments produce bit-identical request mixes,
    here and in the JAX package."""
    if n_requests is None:
        raise ValueError("random_workload needs n_requests")
    if rng is None:
        if seed is None:
            raise ValueError("random_workload needs rng= or seed=")
        rng = seed
    elif seed is not None:
        raise ValueError("pass rng= or seed=, not both")
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    median = max(1.0, np.sqrt(max(1, min_points) * max_points))
    requests = []
    for i in range(n_requests):
        dim, kinds = templates[i % len(templates)]
        n = int(np.clip(rng.lognormal(np.log(median), sigma),
                        min_points, max_points))
        pts = rng.standard_normal((n, dim)).astype(np.float32)
        requests.append((chain_for(rng, dim, kinds), pts))
    return requests


def mixed_lane_workload(seed: int, n_requests: int, *,
                        q_fraction: float = 0.25, qformat: str = "q8.7",
                        max_points: int = 256):
    """``n_requests`` (chain, points, qformat-or-None) triples mixing the
    float lane (affine + projective structures) with the fixed-point lane
    (every ~1/q_fraction-th AFFINE request is tagged with ``qformat``) --
    the traffic shape the fault-model soak runs, exercising all three
    plan kinds plus both dtype lanes in one flush.  Seed-deterministic
    end-to-end, same contract as ``random_workload``."""
    rng = np.random.default_rng([0x50AC, seed])
    base = random_workload(rng, n_requests, max_points=max_points)
    out = []
    for chain, pts in base:
        use_q = (not chain.is_projective) and q_fraction > 0 \
            and rng.random() < q_fraction
        out.append((chain, pts, qformat if use_q else None))
    return out

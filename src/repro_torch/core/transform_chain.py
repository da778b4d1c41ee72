"""Fused transform-chain compiler: the paper's one-pass composite.

The port of ``repro/core/transform_chain.py``.  ``TransformChain`` is the
same small compiler:

  1. **IR** -- builder calls (``translate``/``scale``/``rotate``/``affine``/
     ``matrix``, and the projective ``projective``/``cull``) record
     primitives only; nothing runs until ``apply``.
  2. **Fold** -- the recorded chain folds host-side in numpy float32 to
     one plan: (s, t) for pure-diagonal chains, (A, t) for general affine
     chains, (H, lo, hi) for projective ones.  The fold functions are the
     JAX package's, copied verbatim, so a chain folds to bit-identical
     parameters in both packages.
  3. **Lower** -- the folded chain runs as ONE fused kernel over the flat
     point buffer: ``kernels.chain_diag`` for diagonal plans and
     ``kernels.chain_apply`` for general plans -- hand-written CUDA on a
     CUDA tensor, the plain PyTorch version on a CPU tensor.
  4. **Plan cache** -- plans are cached by chain structure + backend; a
     plan takes the folded values as arguments, so a hot path with one
     chain shape and fresh parameters builds nothing.

Not in this slice: projective plans execute in the graphics slice
(``apply``/``project`` on a projective chain raise ``NotImplementedError``;
the projective FOLD is here, because serving validation needs it), the
Qm.n fixed-point lane (``dtype=``) comes with the int16 kernels, and the
carry-fold API with the scene graph.  There is no traced-parameter fold:
PyTorch runs eagerly and parameters are concrete values.

Byte economy vs. sequential primitive dispatch (k-long chain over N points
of dim d, itemsize 4): sequential moves ~2*k*N*d*4 bytes; the fused plan
moves 2*N*d*4 + O(1).  ``kernels.opcount`` records it.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch import convert, errors
from repro_torch.kernels import chain_apply as _k_chain_apply
from repro_torch.kernels import chain_diag as _k_chain_diag
from repro_torch.kernels import dispatch, opcount

# primitive kinds: T translate, S scale, R rotate, A affine(s, t), M matrix,
# P projective (full homogeneous matrix), C cull (axis-aligned bounds)
_DIAG_KINDS = frozenset("TSA")
_PROJ_KINDS = frozenset("PC")
_AXES = {"x": 0, "y": 1, "z": 2}

#: plan-cache statistics (observable by tests and benchmarks):
#:   compiles -- plans built (structure-level cache misses)
#:   hits     -- plans served from the cache
#:   traces   -- kept for parity with the JAX package, where it counts jit
#:               traces of a plan body; eager PyTorch has no trace step,
#:               so it stays 0
stats = {"compiles": 0, "hits": 0, "traces": 0}

_PLAN_CACHE: dict[tuple, "Plan"] = {}

#: what this slice leaves to later ones
PROJECTIVE_LATER = ("projective chains execute in the graphics slice of "
                    "the port (the chain_project kernels); only their fold "
                    "is ported so far")
QLANE_LATER = ("the Qm.n fixed-point lane (dtype=) comes with the int16 "
               "kernels in a later slice of the port")


def clear_plan_cache() -> None:
    """Drop all plans (benchmarks use this to measure cold cost)."""
    _PLAN_CACHE.clear()


def reset_stats() -> None:
    """Zero every chain counter (benchmarks snapshot deltas from here)."""
    for k in stats:
        stats[k] = 0


# -- folding (host-side numpy float32) ---------------------------------------
#
# The fold runs on the host, in numpy.  One shared host fold means a
# request folds to bit-identical composed parameters whether it is applied
# alone or packed into a serving bucket, and whether the port or the JAX
# package folds it: the functions below are that package's, verbatim
# (their ``carry`` argument serves the scene graph's incremental folds,
# which arrive with that slice).

def _vec(v, dim: int) -> np.ndarray:
    v = np.asarray(v, np.float32)
    if v.ndim == 0:
        v = np.broadcast_to(v, (dim,))
    return v.reshape(dim)


def _rot(dim: int, axis: int, theta) -> np.ndarray:
    """Right-multiply (row-vector) rotation matrix: q = p @ R."""
    c = np.cos(np.float32(theta), dtype=np.float32)
    s = np.sin(np.float32(theta), dtype=np.float32)
    if dim == 2:
        return np.array([[c, s], [-s, c]], np.float32)
    r = np.eye(3, dtype=np.float32)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]   # rotation plane for axis x/y/z
    r[i, i] = r[j, j] = c
    r[i, j], r[j, i] = s, -s
    return r


def _mat_parts(val, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Split a custom-matrix param into (A (d,d), t (d,)); accepts a (d, d)
    linear matrix or a (d+1, d+1) AFFINE homogeneous one (row-vector
    convention).  A homogeneous matrix with a nontrivial perspective
    column is rejected -- silently dropping that column would compute the
    wrong transform; such matrices belong in ``projective``."""
    m = np.asarray(val, np.float32)
    if m.shape == (dim + 1, dim + 1):
        # tolerance scaled to the matrix magnitude: computed affines may
        # carry round-off residue in the perspective column, which is
        # numerically irrelevant; a REAL perspective column is orders of
        # magnitude above it
        tol = 1e-6 * max(1.0, float(np.abs(m).max()))
        if np.any(np.abs(m[:dim, dim]) > tol) or abs(m[dim, dim] - 1.0) > tol:
            raise ValueError(
                "matrix() requires an affine homogeneous matrix (last "
                f"column [0, ..., 0, 1]); got last column {m[:, dim]} -- "
                "use projective() for perspective matrices")
        return m[:dim, :dim], m[dim, :dim]
    if m.shape == (dim, dim):
        return m, np.zeros((dim,), np.float32)
    raise ValueError(f"matrix must be ({dim},{dim}) or "
                     f"({dim + 1},{dim + 1}); got {m.shape}")


def _fold_diag(dim: int, kinds, params,
               carry=None) -> tuple[np.ndarray, np.ndarray]:
    """Fold a pure-diagonal chain to (s, t) with q = s (.) p + t.

    ``carry`` resumes the fold from a saved (s, t) state instead of the
    identity -- the loop body is shared, so resuming is bit-identical to
    folding the concatenated chain in one call (see ``fold_carry_extend``).
    """
    if carry is None:
        s = np.ones((dim,), np.float32)
        t = np.zeros((dim,), np.float32)
    else:
        s, t = carry
    for (kind, _), val in zip(kinds, params):
        if kind == "T":
            t = t + _vec(val, dim)
        elif kind == "S":
            v = _vec(val, dim)
            s, t = s * v, t * v
        else:                                   # "A": y = v*y + u
            v, u = _vec(val[0], dim), _vec(val[1], dim)
            s, t = s * v, t * v + u
    return s, t


def _fold_matrix(dim: int, kinds, params,
                 carry=None) -> tuple[np.ndarray, np.ndarray]:
    """Fold a general chain to (A, t) with q = p @ A + t.

    ``carry`` resumes the fold from a saved (A, t) state (same loop body
    as the from-identity fold, hence bit-identical -- see
    ``fold_carry_extend``)."""
    if carry is None:
        a = np.eye(dim, dtype=np.float32)
        t = np.zeros((dim,), np.float32)
    else:
        a, t = carry
    for (kind, axis), val in zip(kinds, params):
        if kind == "T":
            t = t + _vec(val, dim)
        elif kind == "S":
            v = _vec(val, dim)
            a, t = a * v[None, :], t * v
        elif kind == "A":
            v, u = _vec(val[0], dim), _vec(val[1], dim)
            a, t = a * v[None, :], t * v + u
        elif kind == "R":
            r = _rot(dim, axis, val)
            a, t = a @ r, t @ r
        else:                                   # "M"
            m, u = _mat_parts(val, dim)
            a, t = a @ m, t @ m + u
    return a, t


def _homo(dim: int, a: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Embed an affine (A, t) as a (d+1, d+1) homogeneous row-vector
    matrix: [p, 1] @ H = [p @ A + t, 1]."""
    h = np.zeros((dim + 1, dim + 1), np.float32)
    h[:dim, :dim] = a
    h[dim, :dim] = t
    h[dim, dim] = 1.0
    return h


def _map_bounds(lo: np.ndarray, hi: np.ndarray, s: np.ndarray,
                t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Push axis-aligned [lo, hi] bounds through a per-coordinate affine
    y = s*x + t (negative scales swap the endpoints).  Only called once a
    cull has been recorded, so the bounds are finite."""
    a, b = s * lo + t, s * hi + t
    return np.minimum(a, b), np.maximum(a, b)


def _fold_projective(dim: int, kinds, params, carry=None):
    """Fold a projective chain to (H (d+1, d+1), lo (d,), hi (d,)) with
    q = divide([p, 1] @ H) and an inclusive axis-aligned cull against
    [lo, hi] in the OUTPUT space (+-inf where no cull was recorded).

    The homogeneous composition collapses everything around the divide:
    a divide is a projective equivalence ([q/w, 1] ~ [q, w]), so affines
    and projectives on either side all fold into one H with one divide at
    the end.  Cull bounds are recorded in the coordinate space where the
    ``cull`` primitive sits and pushed forward through later diagonal
    primitives (a viewport map); a rotation, custom matrix, or projective
    AFTER a cull would need non-axis-aligned bounds and is rejected.

    Returns the full carry (h, lo, hi, culled); ``fold_structure`` strips
    the ``culled`` flag.  ``carry`` resumes from a saved state (same loop
    body, hence bit-identical -- see ``fold_carry_extend``); the carried
    ``culled`` flag keeps the after-cull primitive restrictions exact
    across the resume boundary.
    """
    if carry is None:
        h = np.eye(dim + 1, dtype=np.float32)
        lo = np.full((dim,), -np.inf, np.float32)
        hi = np.full((dim,), np.inf, np.float32)
        culled = False
    else:
        h, lo, hi, culled = carry
    for (kind, axis), val in zip(kinds, params):
        if kind == "C":
            lo = np.maximum(lo, _vec(val[0], dim))
            hi = np.minimum(hi, _vec(val[1], dim))
            culled = True
            continue
        if kind == "T":
            t = _vec(val, dim)
            hk = _homo(dim, np.eye(dim, dtype=np.float32), t)
            if culled:
                lo, hi = lo + t, hi + t
        elif kind == "S":
            s = _vec(val, dim)
            hk = _homo(dim, np.diag(s), np.zeros((dim,), np.float32))
            if culled:
                lo, hi = _map_bounds(lo, hi, s, np.float32(0.0))
        elif kind == "A":
            s, t = _vec(val[0], dim), _vec(val[1], dim)
            hk = _homo(dim, np.diag(s), t)
            if culled:
                lo, hi = _map_bounds(lo, hi, s, t)
        elif kind in ("R", "M"):
            if culled:
                raise ValueError(
                    "only translate/scale/affine may follow cull() in a "
                    f"projective chain (got {kind!r}): axis-aligned cull "
                    "bounds cannot fold through a rotation or custom matrix")
            if kind == "R":
                hk = _homo(dim, _rot(dim, axis, val),
                           np.zeros((dim,), np.float32))
            else:
                hk = _homo(dim, *_mat_parts(val, dim))
        else:                                   # "P"
            if culled:
                raise ValueError("a projective primitive cannot follow "
                                 "cull(): record the cull after the last "
                                 "projection instead")
            hk = np.asarray(val, np.float32)
            if hk.shape != (dim + 1, dim + 1):
                raise ValueError(f"projective matrix must be "
                                 f"({dim + 1},{dim + 1}); got {hk.shape}")
        h = (h @ hk).astype(np.float32)
    return h, lo, hi, culled


def structure_is_diagonal(structure: tuple) -> bool:
    """True if ``structure`` (a ``TransformChain.structure`` value) folds to
    a diagonal (s, t) plan -- translate/scale/affine primitives only."""
    _, kinds = structure
    return all(k in _DIAG_KINDS for k, _ in kinds)


def structure_is_projective(structure: tuple) -> bool:
    """True if ``structure`` folds to a projective (H, lo, hi) plan --
    it contains a projective matrix or a cull primitive."""
    _, kinds = structure
    return any(k in _PROJ_KINDS for k, _ in kinds)


def plan_kind_of(structure: tuple) -> str:
    """The plan-kind lattice resolution for a structure: the cheapest of
    diag < matrix < projective that can express it."""
    if structure_is_projective(structure):
        return "projective"
    return "diag" if structure_is_diagonal(structure) else "matrix"


def fold_structure(structure: tuple, params) -> tuple[np.ndarray, ...]:
    """Fold ONE parameter set for ``structure``: float32 (s, t) if the
    structure is diagonal, (A, t) if it is a general affine, and
    (H, lo, hi) if it is projective.  Shared by ``TransformChain.apply``
    and the serving engine's bucket packing, so a request's composed
    parameters are bit-identical however it is dispatched.  It runs the
    op sequence of the JAX package's ``fold_structure`` (a fold from the
    identity), so the two packages agree bit for bit."""
    kind = plan_kind_of(structure)
    dim, kinds = structure
    if kind == "diag":
        return _fold_diag(dim, kinds, params)
    if kind == "matrix":
        return _fold_matrix(dim, kinds, params)
    return _fold_projective(dim, kinds, params)[:3]


# -- plans -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """A chain plan: ``fn(folded, flat_points_2d) -> out``, where
    ``folded`` is the host-folded (s, t) / (A, t) tuple as tensors on the
    points' device."""
    kind: str                      # "diag" | "matrix"
    dim: int
    backend: str
    fn: typing.Callable


def _compile(structure: tuple, backend: str) -> Plan:
    dim, _ = structure
    kind = plan_kind_of(structure)
    if kind == "diag":
        def fn(folded, pts2):
            """Diagonal scale+translate over (N, dim)."""
            s, t = folded
            return _k_chain_diag(pts2, s, t, backend=backend)
    elif kind == "matrix":
        def fn(folded, pts2):
            """Fused matmul+translate over (N, dim)."""
            a, t = folded
            return _k_chain_apply(pts2, a, t, backend=backend)
    else:
        raise NotImplementedError(PROJECTIVE_LATER)
    return Plan(kind=kind, dim=dim, backend=backend, fn=fn)


def _get_plan(structure: tuple, backend: str) -> Plan:
    key = (structure, backend)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        stats["compiles"] += 1
        plan = _PLAN_CACHE[key] = _compile(structure, backend)
    else:
        stats["hits"] += 1
    return plan


# -- the chain IR ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformChain:
    """Lazy composite-transform IR.  Builder methods append primitives
    without any tensor work; ``apply`` folds + lowers through the plan cache.

        chain = (TransformChain.identity(dim=2)
                 .scale(2.0, 0.5).rotate(0.3).translate(1.0, -2.0))
        q = chain.apply(points)            # one fused kernel launch
    """
    dim: int
    kinds: tuple = ()              # ((kind, axis), ...) -- the structure
    params: tuple = ()             # raw per-primitive parameter values

    @staticmethod
    def identity(dim: int = 2) -> "TransformChain":
        """An empty chain in ``dim`` dimensions (2 or 3)."""
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        return TransformChain(dim=dim)

    def _push(self, kind: str, axis: int, param) -> "TransformChain":
        return TransformChain(self.dim, self.kinds + ((kind, axis),),
                              self.params + (param,))

    def _vec_arg(self, name: str, args):
        if len(args) == 1:
            return args[0]
        if len(args) != self.dim:
            raise ValueError(f"{name} takes 1 or {self.dim} components, "
                             f"got {len(args)}")
        return tuple(args)

    def translate(self, *t) -> "TransformChain":
        """Append q = p + t (scalar broadcast or one component per dim)."""
        return self._push("T", -1, self._vec_arg("translate", t))

    def scale(self, *s) -> "TransformChain":
        """Append q = s (.) p (scalar or per-dim factors)."""
        return self._push("S", -1, self._vec_arg("scale", s))

    def rotate(self, theta, axis=None) -> "TransformChain":
        """Append a rotation by ``theta`` (radians).  3D chains name the
        axis (0/1/2 or "x"/"y"/"z"); 2D chains take none."""
        if self.dim == 2:
            if axis is not None:
                raise ValueError("2D rotations take no axis")
            return self._push("R", -1, theta)
        if axis is None:
            raise ValueError("3D rotations need axis= (0/1/2 or x/y/z)")
        ax = _AXES.get(axis, axis)
        if ax not in (0, 1, 2):
            raise ValueError(f"bad rotation axis {axis!r}")
        return self._push("R", ax, theta)

    def affine(self, s, t) -> "TransformChain":
        """Append the fused q = s (.) p + t (scalars or per-dim vectors)."""
        return self._push("A", -1, (s, t))

    def matrix(self, m) -> "TransformChain":
        """Append a custom (d, d) linear or (d+1, d+1) homogeneous matrix
        (row-vector convention: q = [p, 1] @ M).  The matrix must be
        affine (last column [0, ..., 0, 1]); use ``projective`` for a
        matrix with a nontrivial perspective column."""
        return self._push("M", -1, m)

    def projective(self, m) -> "TransformChain":
        """Append a full (d+1, d+1) projective matrix (row-vector
        convention) -- a perspective or orthographic projection.  The
        chain becomes *projective*: it folds in homogeneous space and its
        plan ends in ONE in-kernel perspective divide (consecutive
        projective/affine primitives keep collapsing into a single H --
        the divide is a projective equivalence)."""
        return self._push("P", -1, m)

    def cull(self, lo=-1.0, hi=1.0) -> "TransformChain":
        """Append an inclusive axis-aligned cull against [lo, hi]^d in the
        CURRENT coordinate space (the NDC frustum cull of a viewing
        pipeline; scalars broadcast, or pass per-dim vectors).  The chain
        becomes projective; its plan emits a per-point inside/outside mask
        (see ``project``).  Only translate/scale/affine (e.g. a viewport
        map) may follow a cull -- the bounds fold through those exactly."""
        return self._push("C", -1, (lo, hi))

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.kinds)

    @property
    def structure(self) -> tuple:
        """Hashable plan-cache key component: dims + primitive kinds/axes
        (parameter *values* are plan operands, not part of the key)."""
        return (self.dim, self.kinds)

    @property
    def is_diagonal(self) -> bool:
        """True if the folded chain is diagonal (an (s, t) plan)."""
        return all(k in _DIAG_KINDS for k, _ in self.kinds)

    @property
    def is_projective(self) -> bool:
        """True if the chain contains a projective/cull primitive: it
        folds in homogeneous space and its plan ends in a divide."""
        return any(k in _PROJ_KINDS for k, _ in self.kinds)

    @property
    def plan_kind(self) -> str:
        """The plan class this structure lowers to -- the cheapest rung of
        the diag < matrix < projective lattice that can express it:
        "diag" (fused per-coordinate affine), "matrix" (q = p @ A + t),
        or "projective" (homogeneous product + divide + cull mask)."""
        return plan_kind_of(self.structure)


    def fold(self) -> tuple[np.ndarray, ...]:
        """The host fold this chain's plan consumes: float32 (s, t) for
        diagonal structures, (A, t) for general affine ones, (H, lo, hi)
        for projective ones."""
        return fold_structure(self.structure, self.params)

    # -- execution -----------------------------------------------------------

    def apply(self, points, *, backend: str | None = None,
              dtype: str | None = None,
              device: str | torch.device = "cuda") -> torch.Tensor:
        """Apply the folded chain to (..., d) points in one fused pass.

        A tensor runs where it lies: a CUDA tensor launches the kernel, a
        CPU tensor runs the plain version (``backend="ref"`` asks for the
        plain version on the card).  Anything else (a numpy array) is
        copied to ``device`` first -- the GPU unless the caller passes
        ``device="cpu"``; without a GPU that default raises.

        Malformed points raise the typed ``repro_torch.errors`` taxonomy
        at this boundary (``ShapeError`` / ``EmptyPointsError`` /
        ``DtypeError``).  Projective chains and ``dtype=`` (the Qm.n
        lane) raise ``NotImplementedError``: later slices bring them."""
        if dtype is not None:
            raise NotImplementedError(QLANE_LATER)
        errors.check_points(points, self.dim)
        if not isinstance(points, torch.Tensor):
            points = torch.as_tensor(points,
                                     device=dispatch.resolve_device(device))
        if not self.kinds:
            return points
        if self.is_projective:
            raise NotImplementedError(PROJECTIVE_LATER)
        d = points.shape[-1]
        flat = points.reshape(-1, d)
        plan = _get_plan(self.structure,
                         dispatch.backend_for(points.device, backend))
        opcount.record(f"chain_fused_{plan.kind}",
                       opcount.fused_chain_bytes(flat.shape[0], d,
                                                 kind=plan.kind,
                                                 itemsize=flat.element_size()))
        out = plan.fn(convert.folded_to_torch(self.fold(), points.device), flat)
        return out.reshape(points.shape)

    def project(self, points, *, backend: str | None = None,
                dtype: str | None = None,
                device: str | torch.device = "cuda"):
        """The projected points and the frustum-cull mask.  Affine chains
        project trivially (``apply``, mask all True); projective chains
        execute in the graphics slice and raise ``NotImplementedError``."""
        if self.is_projective:
            raise NotImplementedError(PROJECTIVE_LATER)
        out = self.apply(points, backend=backend, dtype=dtype, device=device)
        return out, torch.ones(out.shape[:-1], dtype=torch.bool,
                               device=out.device)

    def apply_many(self, points, *, backend: str | None = None,
                   dtype: str | None = None,
                   device: str | torch.device = "cuda") -> torch.Tensor:
        """Map one plan over a leading batch axis: (B, ..., d) in,
        (B, ..., d) out, still a single fused kernel launch (the batch is
        part of the flattened point buffer, not a loop of launches)."""
        if points.ndim < 3:
            raise ValueError("apply_many expects (B, ..., d) with ndim >= 3")
        return self.apply(points, backend=backend, dtype=dtype, device=device)

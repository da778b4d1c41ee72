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
     point buffer: ``kernels.chain_diag`` for diagonal plans,
     ``kernels.chain_apply`` for general plans and
     ``kernels.chain_project`` for projective plans (homogeneous product,
     in-kernel perspective divide and cull mask) -- hand-written CUDA on a
     CUDA tensor, the plain PyTorch version on a CPU tensor.
  4. **Plan cache** -- plans are cached by chain structure + backend
     (+ the Qm.n format name for the fixed-point lane); a plan takes the
     folded values as arguments, so a hot path with one chain shape and
     fresh parameters builds nothing.

``apply(..., dtype="q8.7")`` runs the M1-faithful int16 fixed-point lane:
the same host fold, quantised once per request by
``quantize.quantize_fold``, lowered to ``kernels.chain_diag_q`` /
``chain_apply_q`` (int32 accumulation, one requantising shift, int16
wrap), at half the bytes per point.  Affine chains only.

``folded()`` and ``as_homogeneous()`` hand the host fold back as tensors
(``Transform2D.matrix`` is ``as_homogeneous``).

Not in this slice: the carry-fold API comes with the scene graph.  There
is no traced-parameter fold (the JAX package's ``_fold_jnp``, which
``folded`` takes for traced parameters): PyTorch runs eagerly and
parameters are concrete values.

Byte economy vs. sequential primitive dispatch (k-long chain over N points
of dim d, itemsize 4): sequential moves ~2*k*N*d*4 bytes; the fused plan
moves 2*N*d*4 + O(1).  ``kernels.opcount`` records it.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch import convert, errors, quantize
from repro_torch.autotune import cache as tuning
from repro_torch.kernels import chain_apply as _k_chain_apply
from repro_torch.kernels import chain_apply_q as _k_chain_apply_q
from repro_torch.kernels import chain_diag as _k_chain_diag
from repro_torch.kernels import chain_diag_q as _k_chain_diag_q
from repro_torch.kernels import chain_project as _k_chain_project
from repro_torch.kernels import dispatch, opcount
from repro_torch.obs import trace as obst

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
#:               so it stays 0, and no ``plan.trace`` instant is emitted
#: with a tracer installed (``obs.trace``), each compile and hit is also a
#: ``plan.compile`` / ``plan.hit`` instant, as in the JAX package
stats = {"compiles": 0, "hits": 0, "traces": 0}

_PLAN_CACHE: dict[tuple, "Plan"] = {}


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
    ``folded`` is the host-folded (s, t) / (A, t) / (H, lo, hi) tuple as
    tensors on the points' device.  Projective plans return
    ``(projected, mask)``.  Fixed-point plans (``qformat`` set) take
    int16 Qm.n words instead -- the folded parameters quantised once per
    request by ``quantize.quantize_fold`` -- and return int16."""
    kind: str                      # "diag" | "matrix" | "projective"
    dim: int
    backend: str
    fn: typing.Callable
    qformat: str | None = None     # Qm.n name for fixed-point plans


def _compile_q(structure: tuple, backend: str, qname: str) -> Plan:
    """A fixed-point plan: one fused int16 ``chain_*_q`` kernel with the
    format's fraction count as the requantising shift, its launch knobs
    looked up as the float plans' are (cached under the format's name).
    Only affine structures get here -- ``TransformChain`` rejects
    projective + dtype before the lookup."""
    dim, _ = structure
    kind = plan_kind_of(structure)
    fmt = quantize.as_qformat(qname)
    if kind == "diag":
        def fn(folded_q, pts2):
            """Q-format diagonal scale+translate over (N, dim)."""
            s, t = folded_q
            cfg = tuning.config_for("chain_diag_q", backend, fmt.name,
                                    pts2.shape[0])
            return _k_chain_diag_q(pts2, s, t, n_frac=fmt.n, backend=backend,
                                   config=cfg)
    else:
        def fn(folded_q, pts2):
            """Q-format fused matmul+translate over (N, dim)."""
            a, t = folded_q
            cfg = tuning.config_for("chain_apply_q", backend, fmt.name,
                                    pts2.shape[0])
            return _k_chain_apply_q(pts2, a, t, n_frac=fmt.n,
                                    backend=backend, config=cfg)
    return Plan(kind=kind, dim=dim, backend=backend, fn=fn,
                qformat=fmt.name)


def _config(kernel: str, backend: str, pts2: torch.Tensor):
    """The launch knobs of a plan's kernel at these points: the tuning
    cache's winner for their size class when autotuning is enabled, else
    the defaults (the JAX package looks them up at trace time, the port
    at every call).  Knobs steer the grid only: every config gives the
    same bits."""
    return tuning.config_for(kernel, backend, tuning.dtype_name(pts2.dtype),
                             pts2.shape[0])


def _compile(structure: tuple, backend: str) -> Plan:
    dim, _ = structure
    kind = plan_kind_of(structure)
    if kind == "diag":
        def fn(folded, pts2):
            """Diagonal scale+translate over (N, dim)."""
            s, t = folded
            return _k_chain_diag(pts2, s, t, backend=backend,
                                 config=_config("chain_diag", backend, pts2))
    elif kind == "matrix":
        def fn(folded, pts2):
            """Fused matmul+translate over (N, dim)."""
            a, t = folded
            return _k_chain_apply(pts2, a, t, backend=backend,
                                  config=_config("chain_apply", backend,
                                                 pts2))
    else:
        def fn(folded, pts2):
            """Homography apply + perspective divide + cull over (N, dim)."""
            h, lo, hi = folded
            return _k_chain_project(pts2, h, lo, hi, backend=backend,
                                    config=_config("chain_project", backend,
                                                   pts2))
    return Plan(kind=kind, dim=dim, backend=backend, fn=fn)


def _get_plan(structure: tuple, backend: str,
              qname: str | None = None) -> Plan:
    key = (structure, backend, qname)
    plan = _PLAN_CACHE.get(key)
    trc = obst.active()
    if plan is None:
        stats["compiles"] += 1
        if trc.enabled:
            trc.instant("plan.compile", cache="chain", backend=backend,
                        q=qname, length=len(structure))
        plan = _PLAN_CACHE[key] = _compile_q(structure, backend, qname) \
            if qname is not None else _compile(structure, backend)
    else:
        stats["hits"] += 1
        if trc.enabled:
            trc.instant("plan.hit", cache="chain", backend=backend,
                        q=qname, length=len(structure))
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

    def folded(self, device: str | torch.device = "cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The composed (A (d, d), t (d,)) pair of the host fold, float32 on
        ``device`` (the GPU unless the caller passes ``device="cpu"``); a
        diagonal fold's s becomes diag(s).  Projective chains have no
        affine form -- use ``fold``/``as_homogeneous``."""
        if self.is_projective:
            raise ValueError("projective chains have no (A, t) form; use "
                             "fold() or as_homogeneous()")
        dev = dispatch.resolve_device(device)
        return tuple(torch.as_tensor(f, device=dev)
                     for f in self._affine_fold())

    def _affine_fold(self) -> tuple[np.ndarray, np.ndarray]:
        """The host fold of an affine chain as (A, t); diag(s) for s."""
        a, t = self.fold()
        return (np.diag(a) if self.is_diagonal else a), t

    def as_homogeneous(self, device: str | torch.device = "cuda"
                       ) -> torch.Tensor:
        """The composed (d+1, d+1) homogeneous float32 matrix (row-vector
        form) on ``device``.  For projective chains this is the folded H
        (the cull bounds are not representable in the matrix; see
        ``fold``).  Built from the same numpy fold as the JAX package's,
        so the two are bit for bit equal."""
        dev = dispatch.resolve_device(device)
        h = self.fold()[0] if self.is_projective \
            else _homo(self.dim, *self._affine_fold())
        return torch.as_tensor(h, device=dev)

    # -- execution -----------------------------------------------------------

    def _plan(self, points: torch.Tensor, backend: str | None,
              qname: str | None = None) -> Plan:
        return _get_plan(self.structure,
                         dispatch.backend_for(points.device, backend), qname)

    @staticmethod
    def _record_fused(plan: Plan, flat: torch.Tensor) -> None:
        # one shared table (opcount) for parameter words and HBM passes
        # per plan kind, the same the serving engine records per packed
        # launch; fixed-point plans move 2-byte words throughout (the
        # suffix keeps the lanes separately countable)
        suffix = "_q" if plan.qformat else ""
        opcount.record(f"chain_fused_{plan.kind}{suffix}",
                       opcount.fused_chain_bytes(flat.shape[0], flat.shape[1],
                                                 kind=plan.kind,
                                                 itemsize=flat.element_size()))

    def _run(self, points: torch.Tensor, backend: str | None):
        """The shared body of ``apply`` and ``project`` on the float lane:
        ONE plan launch over the flat points with its HBM bytes recorded."""
        flat = points.reshape(-1, points.shape[-1])
        plan = self._plan(points, backend)
        self._record_fused(plan, flat)
        return plan.fn(convert.folded_to_torch(self.fold(), points.device),
                       flat)

    def _apply_q(self, points: torch.Tensor, fmt,
                 backend: str | None) -> torch.Tensor:
        """The fixed-point lane of ``apply``: fold in float (the SAME host
        fold), quantise the folded parameters once, and run the int16
        ``chain_*_q`` plan.  Float points are quantised where they lie
        (saturating, ``QFormat.quantize_torch`` -- bit-identical to the
        host quantiser) and the result is dequantised back to float32;
        int16 points are taken as Qm.n words and come back as int16."""
        fmt = quantize.as_qformat(fmt)
        quantize.reject_projective(self.is_projective)
        # the shared numpy intake rule, on the tensor's numpy dtype
        from_float = quantize.points_need_quantize(
            torch.empty(0, dtype=points.dtype).numpy().dtype)
        pts_q = fmt.quantize_torch(points) if from_float else points
        flat = pts_q.reshape(-1, points.shape[-1])
        plan = self._plan(points, backend, fmt.name)
        self._record_fused(plan, flat)
        folded_q = quantize.quantize_fold(self.fold(), plan.kind, fmt)
        out = plan.fn(convert.folded_to_torch(folded_q, points.device,
                                              np.int16),
                      flat).reshape(points.shape)
        return fmt.dequantize_torch(out) if from_float else out

    def apply(self, points, *, backend: str | None = None,
              dtype: str | None = None,
              device: str | torch.device = "cuda") -> torch.Tensor:
        """Apply the folded chain to (..., d) points in one fused pass.

        A tensor runs where it lies: a CUDA tensor launches the kernel, a
        CPU tensor runs the plain version (``backend="ref"`` asks for the
        plain version on the card).  Anything else (a numpy array) is
        copied to ``device`` first -- the GPU unless the caller passes
        ``device="cpu"``; without a GPU that default raises.  Projective
        chains return the projected points; use ``project`` to also get
        the frustum-cull mask.

        ``dtype`` selects the execution lane: ``None`` is the float32
        lane; a Qm.n name ("q8.7") runs the M1-faithful int16 fixed-point
        lane -- same fold, parameters quantised once per request, half the
        bytes per point.  Float points come back dequantised float32,
        int16 points (Qm.n words) as int16.  Affine chains only: a
        projective chain with ``dtype`` raises ``ValueError``.

        Malformed points raise the typed ``repro_torch.errors`` taxonomy
        at this boundary (``ShapeError`` / ``EmptyPointsError`` /
        ``DtypeError``)."""
        errors.check_points(points, self.dim)
        points = dispatch.place(points, device)
        if not self.kinds:
            return points
        if dtype is not None:
            return self._apply_q(points, dtype, backend)
        out = self._run(points, backend)
        if self.is_projective:
            out = out[0]
        return out.reshape(points.shape)

    def project(self, points, *, backend: str | None = None,
                dtype: str | None = None,
                device: str | torch.device = "cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Apply the chain and return ``(projected (..., d), inside (...,)
        bool)`` -- the perspective-divided points plus the frustum-cull
        mask, still ONE fused kernel launch (the divide, the cull test and
        the per-point mask all happen in-kernel).  Affine chains project
        trivially: the same result as ``apply``, mask all True.  ``dtype``
        (the fixed-point lane) is affine-only, exactly as in ``apply``: a
        projective chain with ``dtype`` is rejected by the delegated
        ``apply`` -- one intake rule, one spelling."""
        if dtype is not None or not self.is_projective:
            out = self.apply(points, backend=backend, dtype=dtype,
                             device=device)
            return out, torch.ones(out.shape[:-1], dtype=torch.bool,
                                   device=out.device)
        errors.check_points(points, self.dim)
        points = dispatch.place(points, device)
        out, mask = self._run(points, backend)
        return out.reshape(points.shape), mask.reshape(points.shape[:-1])

    def apply_many(self, points, *, backend: str | None = None,
                   dtype: str | None = None,
                   device: str | torch.device = "cuda") -> torch.Tensor:
        """Map one plan over a leading batch axis: (B, ..., d) in,
        (B, ..., d) out, still a single fused kernel launch (the batch is
        part of the flattened point buffer, not a loop of launches)."""
        if points.ndim < 3:
            raise ValueError("apply_many expects (B, ..., d) with ndim >= 3")
        return self.apply(points, backend=backend, dtype=dtype, device=device)

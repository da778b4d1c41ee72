"""Transform engine -- the paper's "graphics acceleration library".

The port of ``repro/core/transform_engine.py``: the three primitive
classes of sections 5.1-5.3 (vector-vector, vector-scalar, matrix) as
eager functions, and the composite builders ``Transform2D`` /
``Transform3D`` over ``TransformChain``.

Primitives run eagerly, one kernel launch per call -- the per-primitive
baseline the paper's one-pass composite is measured against:

  * ``translate``/``scale``/``affine`` -> ``kernels.affine`` (the
    ``affine_2d`` kernel; ``scale`` is affine(s, 0), ``translate``
    affine(1, t));
  * ``rotate`` -> ``kernels.rotate2d`` (the ``matmul_2d`` kernel with a
    2x2 rotation, row-vector form q = p @ R);
  * ``vecadd`` -> ``kernels.vecadd`` (the ``vecadd_2d`` kernel).

Composites are compiled, not interpreted: ``then_*`` builder calls only
append to the chain IR, and ``apply`` folds the chain host-side and runs
it as ONE fused launch (``TransformChain.apply``): one read and one
write of the points for the whole chain, against one read and one write
a primitive.  ``.matrix`` materialises the composed homogeneous matrix
on demand.

Devices: a tensor runs where it lies (a CUDA tensor launches the
kernels, a CPU tensor runs the plain versions); anything else (a numpy
array) is copied to ``device`` first -- the GPU unless the caller passes
``device="cpu"``.  A ``Transform2D``/``Transform3D`` carries the device
its ``.matrix`` is built on and its numpy inputs go to.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.transform_chain import TransformChain
from repro_torch.kernels import affine as k_affine
from repro_torch.kernels import dispatch
from repro_torch.kernels import rotate2d as k_rotate2d
from repro_torch.kernels import scale as k_scale
from repro_torch.kernels import translate as k_translate
from repro_torch.kernels import vecadd as k_vecadd


# -- primitive transforms (paper sections 5.1-5.3) ---------------------------

def translate(points, t, *, backend: str | None = None,
              device: str | torch.device = "cuda") -> torch.Tensor:
    """q = p + t (vector-vector; Table 1)."""
    return k_translate(dispatch.place(points, device), t, backend=backend)


def scale(points, s, *, backend: str | None = None,
          device: str | torch.device = "cuda") -> torch.Tensor:
    """q = S x p, diagonal S (vector-scalar; Table 2)."""
    return k_scale(dispatch.place(points, device), s, backend=backend)


def rotate(points, theta, *, backend: str | None = None,
           device: str | torch.device = "cuda") -> torch.Tensor:
    """q = p @ R(theta), row-vector form (matrix algorithm; section 5.3)."""
    return k_rotate2d(dispatch.place(points, device), theta, backend=backend)


def affine(points, s, t, *, backend: str | None = None,
           device: str | torch.device = "cuda") -> torch.Tensor:
    """q = S x p + t fused (beyond-paper fusion of 5.1 + 5.2)."""
    return k_affine(dispatch.place(points, device), s, t, backend=backend)


def vecadd(u, v, *, backend: str | None = None,
           device: str | torch.device = "cuda") -> torch.Tensor:
    """Elementwise u + v, the raw Table 1 op (v goes to u's device)."""
    return k_vecadd(dispatch.place(u, device), v, backend=backend)


# -- composite transforms (paper's "General Composite Algorithm") ------------

@dataclasses.dataclass(frozen=True)
class Transform2D:
    """Composite 2D transform: ``then_*`` builders append in application
    order (first call applied first -- under the row-vector convention
    that IS the paper's right-multiplied matrix chain).  Builders are lazy
    (IR append only); ``apply`` runs the folded chain as one fused kernel
    launch through the plan cache."""
    chain: TransformChain
    device: str = "cuda"

    @staticmethod
    def identity(device: str = "cuda") -> "Transform2D":
        """The empty 2D composite; ``device`` as in the module docstring."""
        return Transform2D(TransformChain.identity(2), device)

    @staticmethod
    def from_matrix(m, device: str = "cuda") -> "Transform2D":
        """Wrap an explicit (3, 3) homogeneous matrix (row-vector form)."""
        return Transform2D(TransformChain.identity(2).matrix(m), device)

    def then_translate(self, tx, ty) -> "Transform2D":
        """Append q = p + (tx, ty)."""
        return Transform2D(self.chain.translate(tx, ty), self.device)

    def then_scale(self, sx, sy) -> "Transform2D":
        """Append q = (sx, sy) (.) p."""
        return Transform2D(self.chain.scale(sx, sy), self.device)

    def then_rotate(self, theta) -> "Transform2D":
        """Append a rotation by ``theta`` radians."""
        return Transform2D(self.chain.rotate(theta), self.device)

    @property
    def matrix(self) -> torch.Tensor:
        """The composed (3, 3) homogeneous float32 matrix on ``device``
        (materialised on demand; it is not part of the apply path)."""
        return self.chain.as_homogeneous(self.device)

    def apply(self, points, *, backend: str | None = None) -> torch.Tensor:
        """points (..., 2) -> (..., 2) in one fused launch."""
        return self.chain.apply(points, backend=backend, device=self.device)


@dataclasses.dataclass(frozen=True)
class Transform3D:
    """3D homogeneous composite on (..., 3) points; the same lazy chain IR
    and fused one-pass lowering as :class:`Transform2D`."""
    chain: TransformChain
    device: str = "cuda"

    @staticmethod
    def identity(device: str = "cuda") -> "Transform3D":
        """The empty 3D composite; ``device`` as in the module docstring."""
        return Transform3D(TransformChain.identity(3), device)

    @staticmethod
    def from_matrix(m, device: str = "cuda") -> "Transform3D":
        """Wrap an explicit (4, 4) homogeneous matrix (row-vector form)."""
        return Transform3D(TransformChain.identity(3).matrix(m), device)

    def then_translate(self, tx, ty, tz) -> "Transform3D":
        """Append q = p + (tx, ty, tz)."""
        return Transform3D(self.chain.translate(tx, ty, tz), self.device)

    def then_scale(self, sx, sy, sz) -> "Transform3D":
        """Append q = (sx, sy, sz) (.) p."""
        return Transform3D(self.chain.scale(sx, sy, sz), self.device)

    def then_rotate(self, theta, axis) -> "Transform3D":
        """Append a rotation by ``theta`` radians about ``axis`` (0/1/2 or
        "x"/"y"/"z")."""
        return Transform3D(self.chain.rotate(theta, axis=axis), self.device)

    @property
    def matrix(self) -> torch.Tensor:
        """The composed (4, 4) homogeneous float32 matrix on ``device``."""
        return self.chain.as_homogeneous(self.device)

    def apply(self, points, *, backend: str | None = None) -> torch.Tensor:
        """points (..., 3) -> (..., 3) in one fused launch."""
        return self.chain.apply(points, backend=backend, device=self.device)

"""Camera models for the projective viewing pipeline (row-vector form).

The port of ``repro/graphics/camera.py``, copied: numpy only, so both
packages build bit-identical matrices.

The graphics companion paper (*2D and 3D Computer Graphics Algorithms
under MorphoSys*) maps full viewing chains -- world transform, camera,
projection -- onto the same RC array as the source paper's affine
primitives.  This module provides those stages as plain numpy matrices in
the repo's row-vector homogeneous convention (q_h = [p, 1] @ H), ready to
drop into a ``TransformChain`` via ``matrix`` (affine camera) and
``projective`` (projection): the chain compiler folds the whole pipeline
into one (H, lo, hi) plan executed as a single fused kernel launch.

Conventions (right-handed, OpenGL-style clip space):

  * the camera looks down its local -z axis; ``up`` seeds local +y;
  * a perspective projection maps the frustum between ``near`` and
    ``far`` (both positive distances in front of the eye) to NDC
    [-1, 1]^3 with w = +(distance in front of the eye), so the in-kernel
    w > 0 test culls everything behind the eye;
  * orthographic projections are affine (w stays 1) but still route
    through the projective plan so the frustum cull mask applies.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _unit(v: np.ndarray, name: str) -> np.ndarray:
    n = float(np.linalg.norm(v))
    if n < 1e-12:
        raise ValueError(f"{name} is degenerate (zero length)")
    return v / n


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World -> camera affine as a (4, 4) row-vector homogeneous matrix.

    The camera sits at ``eye`` looking toward ``target``; ``up`` seeds the
    local +y axis.  ``[p, 1] @ H`` yields camera-space coordinates with
    the view direction along -z."""
    eye = np.asarray(eye, np.float32)
    z = _unit(eye - np.asarray(target, np.float32), "eye - target")
    x = _unit(np.cross(np.asarray(up, np.float32), z), "up x view")
    y = np.cross(z, x)
    a = np.stack([x, y, z], axis=1).astype(np.float32)   # columns = axes
    h = np.eye(4, dtype=np.float32)
    h[:3, :3] = a
    h[3, :3] = -eye @ a
    return h


def perspective(fov_y: float, aspect: float, near: float,
                far: float) -> np.ndarray:
    """Perspective projection as a (4, 4) row-vector projective matrix.

    ``fov_y`` is the full vertical field of view in radians; ``near`` /
    ``far`` are positive distances in front of the eye.  Camera-space
    z = -near / -far map to NDC z = -1 / +1, and w = -z_cam > 0 exactly
    for points in front of the eye."""
    if not 0.0 < fov_y < np.pi:
        raise ValueError(f"fov_y must be in (0, pi), got {fov_y}")
    if not 0.0 < near < far:
        raise ValueError(f"need 0 < near < far, got {near}, {far}")
    f = 1.0 / np.tan(fov_y / 2.0)
    h = np.zeros((4, 4), np.float32)
    h[0, 0] = f / aspect
    h[1, 1] = f
    h[2, 2] = (near + far) / (near - far)
    h[2, 3] = -1.0
    h[3, 2] = 2.0 * near * far / (near - far)
    return h


def orthographic(left: float, right: float, bottom: float, top: float,
                 near: float, far: float) -> np.ndarray:
    """Orthographic projection as a (4, 4) row-vector matrix (affine --
    w stays 1, so nothing is culled by the w > 0 test; the NDC frustum
    cull still applies)."""
    h = np.eye(4, dtype=np.float32)
    h[0, 0] = 2.0 / (right - left)
    h[1, 1] = 2.0 / (top - bottom)
    h[2, 2] = -2.0 / (far - near)
    h[3, 0] = -(right + left) / (right - left)
    h[3, 1] = -(top + bottom) / (top - bottom)
    h[3, 2] = -(far + near) / (far - near)
    return h


@dataclasses.dataclass(frozen=True)
class Camera:
    """A look-at camera with an optional intrinsic projection.

        cam = Camera(eye=(3, 2, 6), target=(0, 0, 0),
                     fov_y=np.pi / 3, near=0.5, far=50.0)
        cam.view_matrix()        # (4, 4) affine (world -> camera)
        cam.projection_matrix()  # (4, 4) perspective (camera -> clip)

    ``fov_y=None`` makes ``projection_matrix`` orthographic over
    [-ortho_half, ortho_half]^2 at the same near/far range."""
    eye: tuple = (0.0, 0.0, 5.0)
    target: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_y: float | None = np.pi / 3
    aspect: float = 1.0
    near: float = 0.1
    far: float = 100.0
    ortho_half: float = 1.0

    def view_matrix(self) -> np.ndarray:
        """The (4, 4) world -> camera affine (``look_at``)."""
        return look_at(self.eye, self.target, self.up)

    def projection_matrix(self) -> np.ndarray:
        """The (4, 4) camera -> clip projection: perspective, or
        orthographic when ``fov_y`` is None."""
        if self.fov_y is None:
            s = self.ortho_half
            return orthographic(-s * self.aspect, s * self.aspect,
                                -s, s, self.near, self.far)
        return perspective(self.fov_y, self.aspect, self.near, self.far)

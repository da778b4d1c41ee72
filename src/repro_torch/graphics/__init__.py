"""Projective graphics pipeline: homogeneous viewing chains fused into
single launches.

The port of ``repro/graphics``: the same numpy camera, projection and
viewport matrices (copied, not imported), assembled on the port's
``TransformChain``.

The source paper's geometrical transformations are the affine half of a
viewing pipeline; its graphics companion (*2D and 3D Computer Graphics
Algorithms under MorphoSys*, Damaj, Majzoub & Diab) maps the rest --
rotation, projection, full 2D/3D viewing chains -- onto the same RC
array.  This package is that companion mapped onto the chain compiler:

  * ``Camera`` / ``look_at`` / ``perspective`` / ``orthographic`` -- the
    view and projection stages as row-vector homogeneous matrices;
  * ``Viewport`` -- the NDC -> screen diagonal affine (the one stage that
    may follow the frustum cull);
  * ``viewing_chain`` -- assembles model -> camera -> projection -> cull
    -> viewport as ONE projective ``TransformChain``, which the compiler
    folds to a single (H, lo, hi) plan and executes as a single fused
    kernel launch (in-kernel perspective divide + cull mask; see
    ``repro_torch.kernels.projective``).

Serve many viewing chains through
``repro_torch.serving.GeometryServer`` -- projective structures bucket
like any other chain structure, so mixed affine + projective traffic
batches into few launches.
"""
from repro_torch.graphics.camera import (Camera, look_at, orthographic,
                                         perspective)
from repro_torch.graphics.pipeline import viewing_chain
from repro_torch.graphics.viewport import Viewport

__all__ = ["Camera", "Viewport", "look_at", "orthographic", "perspective",
           "viewing_chain"]

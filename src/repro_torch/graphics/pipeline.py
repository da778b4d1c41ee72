"""Viewing-chain assembly: camera + projection + cull + viewport as ONE
projective ``TransformChain``.

``viewing_chain`` is the subsystem's front door: it strings the pipeline
stages (model/world affines, look-at camera, perspective or orthographic
projection, NDC frustum cull, viewport map) onto the chain IR, and the
chain compiler folds the whole thing to a single (H, lo, hi) plan --
every point makes ONE trip through HBM, the perspective divide and the
cull mask never leave the kernel, and
``repro_torch.serving.GeometryServer`` buckets many such chains into
single launches (the structure is hashable like any other chain
structure).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.transform_chain import TransformChain
from repro_torch.graphics.camera import Camera
from repro_torch.graphics.viewport import Viewport


def viewing_chain(dim: int = 3, *, model: TransformChain | None = None,
                  camera: Camera | None = None, projection=None,
                  viewport: Viewport | None = None,
                  cull: bool = True) -> TransformChain:
    """Assemble a full viewing pipeline as one projective chain.

    Stages, in order (all optional):

      * ``model``   -- an existing ``TransformChain`` of world/model
        affines (its primitives are reused verbatim);
      * ``camera``  -- a ``Camera``; appends its look-at view affine, and
        its intrinsic projection when ``projection`` is not given;
      * ``projection`` -- an explicit (d+1, d+1) projective matrix
        (overrides the camera intrinsics), or ``False`` to suppress the
        camera intrinsics entirely -- with ``cull=False`` the pipeline
        then stays AFFINE (one matrix plan);
      * ``cull``    -- the NDC frustum cull against [-1, 1]^d (emitted as
        the chain's in-kernel mask; on by default);
      * ``viewport`` -- a ``Viewport``; appends the NDC -> screen
        diagonal affine (the cull bounds fold through it).

    The result folds to ONE (H, lo, hi) plan: a single fused kernel
    launch however many stages were stacked.

    A chain with a projection or cull is *projective* and runs float32
    only (the in-kernel perspective divide has no single-shift Qm.n
    form).  An AFFINE viewing chain (model + camera + viewport with
    ``projection=False, cull=False``) folds to a plain matrix plan like
    any other affine chain.
    """
    chain = model if model is not None else TransformChain.identity(dim)
    if model is not None and model.dim != dim:
        raise ValueError(f"model chain is {model.dim}D, pipeline is {dim}D")
    if camera is not None:
        if dim != 3:
            raise ValueError("Camera is 3D; build 2D pipelines from "
                             "explicit matrices")
        chain = chain.matrix(camera.view_matrix())
        if projection is None:
            projection = camera.projection_matrix()
    if projection is not None and projection is not False:
        chain = chain.projective(np.asarray(projection, np.float32))
    if cull:
        chain = chain.cull(-1.0, 1.0)
    if viewport is not None:
        s, t = viewport.scale_offset(dim)
        chain = chain.affine(s, t)
    return chain

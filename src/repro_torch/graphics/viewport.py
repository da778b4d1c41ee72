"""Viewport mapping: NDC [-1, 1]^d to screen/depth coordinates.

The port of ``repro/graphics/viewport.py``, copied (numpy only).

The viewport map is the diagonal-affine tail of a viewing pipeline -- the
one stage allowed to FOLLOW the frustum cull, because axis-aligned cull
bounds fold exactly through a per-coordinate affine (the chain compiler
pushes the recorded [-1, 1] bounds forward into output space, so the
in-kernel cull tests final screen coordinates against screen-space
bounds: one comparison, no second pass).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Viewport:
    """A screen rectangle (plus depth range in 3D).

    NDC x in [-1, 1] maps to [x, x + width], y to [y, y + height], and --
    for 3D chains -- NDC z to ``depth`` (the z-buffer range)."""
    x: float = 0.0
    y: float = 0.0
    width: float = 1.0
    height: float = 1.0
    depth: tuple = (0.0, 1.0)

    def scale_offset(self, dim: int) -> tuple[tuple, tuple]:
        """The per-coordinate affine (s, t) with screen = ndc * s + t."""
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        s = [self.width / 2.0, self.height / 2.0]
        t = [self.x + self.width / 2.0, self.y + self.height / 2.0]
        if dim == 3:
            d0, d1 = self.depth
            s.append((d1 - d0) / 2.0)
            t.append((d0 + d1) / 2.0)
        return tuple(np.float32(v) for v in s), \
            tuple(np.float32(v) for v in t)

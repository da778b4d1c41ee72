"""Public entry points of the matmul family: ``matmul``, ``rotate2d`` and
the general (matrix) chain ops.  Backend dispatch as in ``affine/ops.py``.

``matmul`` takes the wgmma regime's launch knobs, ``bn`` and ``stages``,
in place of the JAX package's ``bm``/``bn``/``bk`` TPU tile: explicit
knobs win, then ``config``, then the tuning cache when autotuning is
enabled, else the kernel's own choice (BN by SM fill, 4 stages).  The
ring's stages never change a result; BN changes the order of the tensor
cores' sums (within ``matmul_bound``).  The chain ops take ``config`` as
in ``affine/ops.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.autotune import cache as tuning
from repro_torch.autotune.cache import KernelConfig
from repro_torch.kernels import dispatch, opcount
from repro_torch.kernels.matmul import matmul as K
from repro_torch.kernels.matmul import ref


def matmul(x: torch.Tensor, y: torch.Tensor, *, backend: str | None = None,
           out_dtype: torch.dtype | None = None, bn: int | None = None,
           stages: int | None = None,
           config: KernelConfig | None = None) -> torch.Tensor:
    """C = X @ Y with float32 accumulation; x (..., K) of rank >= 2 (the
    leading dims are batched by reshape), y (K, N).  ``out_dtype`` is
    x's dtype by default.  Operands of two dtypes are both widened to
    the wider one first (exact for bfloat16 to float32).  Lowered to the
    ``matmul_2d`` kernel, its knobs as the module docstring says."""
    out_dtype = out_dtype or x.dtype
    out_elems = x.shape[:-1].numel() * y.shape[-1]
    opcount.record("matmul", x.nbytes + y.nbytes
                   + out_elems * out_dtype.itemsize)
    b = dispatch.backend_for(x.device, backend)
    if b == "ref":
        return ref.matmul(x, y, out_dtype=out_dtype)
    if x.dtype != y.dtype:
        common = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(common), y.to(common)
    cfg = config or tuning.config_for(
        "matmul", b, tuning.dtype_name(x.dtype), out_elems)
    out = K.matmul_2d(x.contiguous().reshape(-1, x.shape[-1]),
                      y.contiguous(), out_dtype=out_dtype,
                      bn=bn or cfg.bn, stages=stages or cfg.stages)
    return out.reshape(*x.shape[:-1], y.shape[-1])


def rotate2d(points: torch.Tensor, theta, *,
             backend: str | None = None) -> torch.Tensor:
    """Rotate (..., 2) points by angle ``theta`` -- the paper's rotation
    as a 2x2 matmul, right-multiply form [[c, s], [-s, c]] in the points'
    dtype.  c and s are computed in float64 and rounded once to float32
    (XLA's float32 cos/sin may differ from them by an ulp)."""
    c = np.float32(np.cos(np.float64(theta)))
    s = np.float32(np.sin(np.float64(theta)))
    rot = torch.tensor(np.array([[c, s], [-s, c]], np.float32),
                       device=points.device).to(points.dtype)
    out = matmul(points.reshape(-1, 2), rot, backend=backend)
    return out.reshape(points.shape)


def chain_apply(points: torch.Tensor, a, t, *, backend: str | None = None,
                config: KernelConfig | None = None) -> torch.Tensor:
    """Folded transform chain q = p @ A + t in one fused pass.

    ``points`` is (..., d); ``a`` is the composed (d, d) linear part and
    ``t`` the composed (d,) translation.  Lowered to the
    ``chain_matrix_1d`` kernel: one read of the points, one write."""
    b = dispatch.backend_for(points.device, backend)
    d = points.shape[-1]
    a = dispatch.param_tensor(a, (d, d), points)
    t = dispatch.param_tensor(t, (d,), points)
    if b == "ref":
        return ref.chain_matrix(points, a, t)
    cfg = config or KernelConfig("chain_apply")
    out = K.chain_matrix_1d(points.contiguous().reshape(-1), a, t, d=d,
                            block_threads=cfg.block_threads, waves=cfg.waves)
    return out.reshape(points.shape)


def chain_apply_batch(pts3: torch.Tensor, a, t, *,
                      backend: str | None = None,
                      config: KernelConfig | None = None) -> torch.Tensor:
    """Batched folded general chains: q[b] = p[b] @ A[b] + t[b].

    ``pts3`` is a packed (B, L, d) batch; ``a`` (B, d, d) / ``t`` (B, d)
    are per-request folded parameters.  One launch serves the batch."""
    b = dispatch.backend_for(pts3.device, backend)
    bsz, _, d = pts3.shape
    a = dispatch.param_tensor(a, (bsz, d, d), pts3)
    t = dispatch.param_tensor(t, (bsz, d), pts3)
    if b == "ref":
        return ref.chain_matrix_batch(pts3, a, t)
    cfg = config or KernelConfig("chain_apply_batch")
    return K.chain_matrix_batch_2d(pts3.contiguous(), a, t,
                                   block_threads=cfg.block_threads,
                                   waves=cfg.waves)

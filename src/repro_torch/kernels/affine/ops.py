"""Public entry points of the affine family: the eager primitives
(``affine``/``scale``/``translate``/``vecadd``) and the diagonal chain ops.

Backend dispatch per ``repro_torch.kernels.dispatch``: a CUDA tensor
launches the kernel, a CPU tensor runs the plain version, and
``backend="ref"`` asks for the plain version on any device.  ``vecadd``
(the model's residual add) launches ``vecadd_2d`` through
``kernels.grad.VecAdd`` when autograd records the call; every other
kernel here raises on a CUDA input that requires grad.  The eager
primitives take inputs of any rank, flattened to (M, N) with N the
trailing dim, and scalar or (N,) row parameters; each records its HBM
bytes through ``opcount`` with the JAX package's formulas, so sequential
and fused byte counts compare.  Chain-level byte accounting happens in
``TransformChain.apply`` and in the serving engine.  The chain ops take
``config`` (an ``autotune.KernelConfig``): its launch knobs steer the
kernel's grid, never its arithmetic, and the plain version ignores them.
"""
from __future__ import annotations

import torch

from repro_torch.autotune.cache import KernelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch, grad, opcount
from repro_torch.kernels.affine import affine as K
from repro_torch.kernels.affine import ref


def affine(x: torch.Tensor, s, t, *,
           backend: str | None = None) -> torch.Tensor:
    """y = s*x + t -- the fused translation+scaling composite.

    ``s``/``t`` are scalars or (N,) vectors over the trailing dim of x,
    cast to x's dtype.  Lowered to the ``affine_2d`` kernel over x viewed
    as (M, N): one read of x, one write."""
    n = x.shape[-1]
    opcount.record("affine", 2 * x.nbytes + 2 * n * x.element_size())
    b = dispatch.backend_for(x.device, backend)
    s = dispatch.param_tensor(s, (n,), x)
    t = dispatch.param_tensor(t, (n,), x)
    if b == "ref":
        return ref.affine(x, s, t)
    return K.affine_2d(x.contiguous().reshape(-1, n), s, t).reshape(x.shape)


def scale(x: torch.Tensor, s, *, backend: str | None = None) -> torch.Tensor:
    """q = S x p, diagonal S (paper section 5.2 vector-scalar op): exactly
    ``affine(x, s, 0)``, so x*s = -0.0 comes out +0.0."""
    return affine(x, s, 0.0, backend=backend)


def translate(x: torch.Tensor, t, *,
              backend: str | None = None) -> torch.Tensor:
    """q = p + t (paper section 5.1 vector-vector op, broadcast form):
    exactly ``affine(x, 1, t)``."""
    return affine(x, 1.0, t, backend=backend)


def vecadd(x: torch.Tensor, z, *, backend: str | None = None) -> torch.Tensor:
    """y = x + z elementwise (Table 1), z cast to x's dtype first.  On
    DTensors the kernel adds the local shards, z first placed as x."""
    if sharding.any_dtensor(x, z):
        every = tuple(range(x.dim()))
        return sharding.local_call(
            lambda a, c: vecadd(a, c, backend=backend), (x, z),
            (every, every))
    z = torch.as_tensor(z, device=x.device).to(x.dtype)
    if z.shape != x.shape:
        raise ValueError(f"vecadd wants operands of one shape, got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    opcount.record("vecadd", 3 * x.nbytes)
    b = dispatch.backend_for(x.device, backend)
    if b == "ref":
        return ref.vecadd(x, z)
    n = x.shape[-1]
    x2, z2 = x.contiguous().reshape(-1, n), z.contiguous().reshape(-1, n)
    if grad.wanted(x2, z2):
        out = grad.VecAdd.apply("vecadd_2d", K.vecadd_2d, ref.vecadd, x2, z2)
    else:
        out = K.vecadd_2d(x2, z2)
    return out if out.shape == x.shape else out.reshape(x.shape)


def chain_diag(points: torch.Tensor, s, t, *, backend: str | None = None,
               config: KernelConfig | None = None) -> torch.Tensor:
    """Folded diagonal transform chain q = s (.) p + t in one fused pass.

    ``points`` is (..., d); ``s``/``t`` are scalars or (d,) per-coordinate
    parameters.  Lowered to the ``chain_diag_1d`` kernel over the flat
    buffer: one read of the points, one write.  ``config`` carries its
    launch knobs (None: the kernel's own choice); every config gives the
    same bits."""
    b = dispatch.backend_for(points.device, backend)
    d = points.shape[-1]
    s = dispatch.param_tensor(s, (d,), points)
    t = dispatch.param_tensor(t, (d,), points)
    if b == "ref":
        return ref.chain_diag(points, s, t)
    cfg = config or KernelConfig("chain_diag")
    out = K.chain_diag_1d(points.contiguous().reshape(-1), s, t, d=d,
                          block_threads=cfg.block_threads, waves=cfg.waves)
    return out.reshape(points.shape)


def chain_diag_batch(pts3: torch.Tensor, s, t, *,
                     backend: str | None = None,
                     config: KernelConfig | None = None) -> torch.Tensor:
    """Batched folded diagonal chains: q[b] = s[b] (.) p[b] + t[b].

    ``pts3`` is a packed (B, L, d) batch -- one serving request per row,
    padded to a common length L; ``s``/``t`` are (B, d) per-request
    folded parameters.  One launch serves the whole batch, its launch
    knobs from ``config``."""
    b = dispatch.backend_for(pts3.device, backend)
    bsz, _, d = pts3.shape
    s = dispatch.param_tensor(s, (bsz, d), pts3)
    t = dispatch.param_tensor(t, (bsz, d), pts3)
    if b == "ref":
        return ref.chain_diag_batch(pts3, s, t)
    cfg = config or KernelConfig("chain_diag_batch")
    return K.chain_diag_batch_2d(pts3.contiguous(), s, t,
                                 block_threads=cfg.block_threads,
                                 waves=cfg.waves)

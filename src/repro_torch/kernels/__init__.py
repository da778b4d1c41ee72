"""Kernel families of the port: the eager primitives (``affine``,
``scale``, ``translate``, ``vecadd``, ``matmul``, ``rotate2d``) and the
chain ops.

Each family keeps a plain PyTorch version (``ref.py``), the wrappers of
its hand-written CUDA kernels (``affine.py`` / ``matmul.py`` /
``projective.py`` / ``fixedpoint.py``, sources in ``csrc/``) and the
dispatching ops (``ops.py``).  Importing this package builds nothing: a kernel is
compiled at its first launch.

As in the JAX package, ``repro_torch.kernels.affine`` and ``.matmul`` are
the eager ops here; the family subpackages stay importable by their full
names (``from repro_torch.kernels.affine import affine`` is the module of
CUDA wrappers, ``... import ref`` the plain versions).
"""
from repro_torch.kernels.affine import chain_diag, chain_diag_batch
from repro_torch.kernels.affine.ops import affine, scale, translate, vecadd
from repro_torch.kernels.fixedpoint import (chain_apply_batch_q,
                                            chain_apply_q,
                                            chain_diag_batch_q, chain_diag_q)
from repro_torch.kernels.matmul import chain_apply, chain_apply_batch
from repro_torch.kernels.matmul.ops import matmul, rotate2d
from repro_torch.kernels.projective import chain_project, chain_project_batch

__all__ = ["affine", "scale", "translate", "vecadd", "matmul", "rotate2d",
           "chain_diag", "chain_diag_batch", "chain_apply",
           "chain_apply_batch", "chain_project", "chain_project_batch",
           "chain_diag_q", "chain_apply_q", "chain_diag_batch_q",
           "chain_apply_batch_q"]

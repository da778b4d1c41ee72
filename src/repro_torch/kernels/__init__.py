"""Kernel families of the port: the eager primitives (``affine``,
``scale``, ``translate``, ``vecadd``, ``matmul``, ``rotate2d``), the
chain ops, and the model stack's ops (``rmsnorm``, ``rope``/
``rope_tables``, ``attention``, ``ssd_intra``).

Each family keeps a plain PyTorch version (``ref.py``), the wrappers of
its hand-written CUDA kernels (``affine.py`` / ``matmul.py`` /
``projective.py`` / ``fixedpoint.py`` / ``rmsnorm.py`` / ``rope.py`` /
``flash_attention.py`` / ``ssd.py``, sources in ``csrc/``) and the
dispatching ops (``ops.py``).  Importing this package builds nothing: a kernel is
compiled at its first launch.  The model stack's kernels run under
autograd through ``grad.py`` (the kernel forward, the plain version's
vjp backward); every other kernel raises on an input that requires
grad.

As in the JAX package, ``repro_torch.kernels.affine``, ``.matmul``,
``.rmsnorm`` and ``.rope`` are the eager ops here; the family
subpackages stay importable by their full names (``from
repro_torch.kernels.affine import affine`` is the module of CUDA
wrappers, ``... import ref`` the plain versions).
"""
from repro_torch.kernels.affine import chain_diag, chain_diag_batch
from repro_torch.kernels.affine.ops import affine, scale, translate, vecadd
from repro_torch.kernels.fixedpoint import (chain_apply_batch_q,
                                            chain_apply_q,
                                            chain_diag_batch_q, chain_diag_q)
from repro_torch.kernels.matmul import chain_apply, chain_apply_batch
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.matmul.ops import matmul, rotate2d
from repro_torch.kernels.projective import chain_project, chain_project_batch
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rope.ops import rope, rope_tables
from repro_torch.kernels.ssd.ops import ssd_intra

__all__ = ["affine", "scale", "translate", "vecadd", "matmul", "rotate2d",
           "chain_diag", "chain_diag_batch", "chain_apply",
           "chain_apply_batch", "chain_project", "chain_project_batch",
           "chain_diag_q", "chain_apply_q", "chain_diag_batch_q",
           "chain_apply_batch_q", "rmsnorm", "rope", "rope_tables",
           "attention", "ssd_intra"]

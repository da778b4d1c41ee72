"""Kernel families of the port and their public chain ops.

Each family keeps a plain PyTorch version (``ref.py``), the wrappers of
its hand-written CUDA kernels (``affine.py`` / ``matmul.py``, sources in
``csrc/``) and the dispatching ops (``ops.py``).  Importing this package
builds nothing: a kernel is compiled at its first launch.
"""
from repro_torch.kernels.affine import chain_diag, chain_diag_batch
from repro_torch.kernels.matmul import chain_apply, chain_apply_batch

__all__ = ["chain_diag", "chain_diag_batch", "chain_apply",
           "chain_apply_batch"]

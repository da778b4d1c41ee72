"""PyTorch/CUDA port of the ``repro`` transform-chain system for Hopper.

The package mirrors ``repro``'s layout (``repro_torch/x/y.py`` is the port
of ``repro/x/y.py``) and keeps its public names:

  * ``repro_torch.core.transform_chain.TransformChain`` -- the chain IR,
    the shared host fold and the plan cache (``stats``);
  * ``repro_torch.serving.GeometryServer`` / ``BucketReport`` / ``stats``
    -- plan-bucketed batched serving;
  * ``repro_torch.kernels.chain_diag`` / ``chain_apply`` (and their
    ``_batch`` forms) -- the fused chain ops over hand-written CUDA
    kernels for ``sm_90a``.

Importing this package loads nothing but this docstring: the subpackages
import ``torch`` and numpy only, and never ``jax`` or ``repro``.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

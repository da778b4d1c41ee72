"""PyTorch/CUDA port of the ``repro`` transform-chain system for Hopper.

The package mirrors ``repro``'s layout (``repro_torch/x/y.py`` is the port
of ``repro/x/y.py``) and keeps its public names:

  * ``repro_torch.core.transform_chain.TransformChain`` -- the chain IR,
    the shared host fold and the plan cache (``stats``);
  * ``repro_torch.serving.GeometryServer`` / ``BucketReport`` /
    ``Projected`` / ``FaultConfig`` / ``stats`` -- plan-bucketed batched
    serving, on the float lane and the int16 Qm.n lane (``qformat=``);
  * ``repro_torch.quantize`` -- ``QFormat`` ("q8.7"), ``quantize_fold``,
    ``error_bound``/``fits``: the fixed-point lane's formats and bounds;
  * ``repro_torch.kernels.chain_diag`` / ``chain_apply`` /
    ``chain_project`` (and their ``_batch`` forms), and the int16
    ``chain_diag_q`` / ``chain_apply_q`` (and ``_batch_q``) -- the fused
    chain ops over hand-written CUDA kernels for ``sm_90a``;
  * ``repro_torch.graphics`` -- ``Camera`` / ``Viewport`` /
    ``viewing_chain``: projective viewing pipelines as one chain;
  * ``repro_torch.core.transform_engine`` -- the paper's eager
    primitives (``translate``/``scale``/``rotate``/``affine``/``vecadd``,
    one launch each, over ``repro_torch.kernels.affine``/``scale``/
    ``translate``/``vecadd``/``matmul``/``rotate2d``) and the
    ``Transform2D``/``Transform3D`` composite builders;
  * ``repro_torch.core.morphosys`` / ``repro_torch.core.analysis`` -- the
    M1 emulator (the cycle oracle) and the paper's table arithmetic,
    numpy copies of the JAX package's.

Importing this package loads nothing but this docstring: the subpackages
import ``torch`` and numpy only, and never ``jax`` or ``repro``.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

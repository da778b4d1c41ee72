"""Projective chain family: q = divide([p, 1] @ H) + cull mask (plain
versions, CUDA wrappers, ops)."""
from repro_torch.kernels.projective.ops import (chain_project,
                                                chain_project_batch)

__all__ = ["chain_project", "chain_project_batch"]

"""General chain family: q = p @ A + t (plain versions, CUDA wrappers, ops)."""
from repro_torch.kernels.matmul.ops import chain_apply, chain_apply_batch

__all__ = ["chain_apply", "chain_apply_batch"]

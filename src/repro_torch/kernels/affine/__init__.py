"""Diagonal chain family: q = s (.) p + t (plain versions, CUDA wrappers, ops)."""
from repro_torch.kernels.affine.ops import chain_diag, chain_diag_batch

__all__ = ["chain_diag", "chain_diag_batch"]

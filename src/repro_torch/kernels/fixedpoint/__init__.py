"""Fixed-point chain family: the int16 Qm.n forms of the diag and matrix
plans (plain versions and the numpy Q oracle, CUDA wrappers, ops)."""
from repro_torch.kernels.fixedpoint.ops import (chain_apply_batch_q,
                                                chain_apply_q,
                                                chain_diag_batch_q,
                                                chain_diag_q)

__all__ = ["chain_diag_q", "chain_apply_q", "chain_diag_batch_q",
           "chain_apply_batch_q"]

"""Carry state across from the JAX package.

This system has no model weights: a chain's recorded primitives and its
host fold are the state both packages must share.  A reference chain is
handed over as its plain attributes (``dim``, ``kinds``, ``params`` --
numbers, tuples, lists and numpy arrays), so this module never imports
the JAX package; the folds then agree bit for bit, because both packages
run the same numpy fold.
"""
from __future__ import annotations

import numpy as np
import torch


def chain_from_reference(dim: int, kinds, params):
    """The port's ``TransformChain`` for a reference chain's attributes:
    ``chain_from_reference(c.dim, c.kinds, c.params)``."""
    from repro_torch.core.transform_chain import TransformChain
    kinds = tuple((str(k), int(axis)) for k, axis in kinds)
    params = tuple(params)
    if len(kinds) != len(params):
        raise ValueError(f"{len(kinds)} primitives but {len(params)} "
                         "parameter sets")
    chain = TransformChain.identity(int(dim))
    return TransformChain(chain.dim, kinds, params)


def folded_to_torch(folded, device: str | torch.device,
                    dtype=np.float32) -> tuple[torch.Tensor, ...]:
    """Folded numpy parameters -- (s, t), (A, t) or (H, lo, hi), single
    or stacked over a batch -- as tensors on ``device``: float32, or the
    int16 Qm.n words of ``quantize_fold`` with ``dtype=np.int16``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(f, dtype),
                                 device=device) for f in folded)

"""Plain PyTorch SSD intra-chunk core, the port of the JAX package's
``kernels/ssd/ref.py`` and the function of the ``ssd_intra`` kernel.

Per (chunk, head), in float32:

    G     = C B^T                                    (lc, lc)
    att   = G * exp(mask(cum_i - cum_j))             j <= i, else exp(-inf) = 0
    y     = att @ xdt                                (lc, p)
    S_c   = (xdt * exp(cum_last - cum))^T B          (p, n)

The exponent is masked before ``exp``: for j > i it is positive and can
overflow.
"""
from __future__ import annotations

import torch


def ssd_intra(xdt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
              cum: torch.Tensor):
    """xdt (BC, lc, h, p), b_in/c_in (BC, lc, n), cum (BC, lc, h) ->
    (y_intra (BC, lc, h, p) float32, s_c (BC, h, p, n) float32)."""
    xdt = xdt.float()
    b_in = b_in.float()
    c_in = c_in.float()
    cum = cum.float()
    lc = xdt.shape[1]
    g = torch.einsum("cin,cjn->cij", c_in, b_in)
    diff = cum[:, :, None, :] - cum[:, None, :, :]      # (BC, i, j, h)
    ii = torch.arange(lc, device=xdt.device)
    mask = (ii[:, None] >= ii[None, :])[None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, torch.full((), float("-inf"),
                                                         device=xdt.device)))
    att = g[..., None] * decay
    y = torch.einsum("cijh,cjhp->cihp", att, xdt)
    sdecay = torch.exp(cum[:, -1:, :] - cum)            # (BC, lc, h)
    w = xdt * sdecay[..., None]
    s_c = torch.einsum("cjhp,cjn->chpn", w, b_in)
    return y, s_c

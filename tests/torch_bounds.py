"""Float bounds of the port's checks, in one place (a helper module, not a
test file): the projective contract between the port and the JAX
package, and the bounds between the model stack's kernels and their
plain versions.  The parity tests import it, and so does
``chip_smoke.py``, which holds the kernels to these bounds on the card.

The projective contract.  For a float32 fold (H, lo, hi) and (..., d)
points p, with v and w the float64 values of the fold, each projected
element may differ by

    4 eps32 [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| + |H_dd|)] / |w|

where w > 0, and by 4 eps32 (sum_m |p_m H_mc| + |H_dc|) where w <= 0
(the guarded divide by 1), because XLA:CPU rounds in another order than
the port's one-op-at-a-time version.  Values are compared wherever w's
margin to 0 exceeds its own bound; masks wherever every margin (w to 0,
each coordinate to lo and hi) exceeds the bound.

The model kernels.  ``rmsnorm_2d``, ``flash_attention_3d`` and
``ssd_intra`` sum in another order than their plain PyTorch versions (a
strided and shuffled sum, an online softmax over tiles, a row loop in
place of einsums), so each agrees with its plain version to a bound, not
bit for bit.  ``rope_3d`` rounds as its plain version does and equals it
bit for bit.  Each bound is per element, a worst case from the float32
error of a sum of k terms, at most k * eps32 * (the sum of their
magnitudes) for two summation orders, plus a few ulp for
``rsqrtf``/``expf``; a bfloat16 output adds one bfloat16 ulp, the most
a float32 difference that small can move a rounding.

The tensor-core (wgmma) paths.  ``matmul_2d`` on bfloat16 inputs (not
the skinny K <= 8, N <= 8 ones, which stay bitwise),
``flash_attention_3d`` and ``ssd_intra`` on bfloat16 inputs sum on
Hopper's tensor cores,
whose fp32 accumulation runs in the hardware's own order and need not
round to nearest inside an MMA.  So ``matmul_bound`` allows
2 K eps32 sum_k |x_ik y_kj| per element: K eps32 for each of the two
orders (the tensor cores' and the plain k-ascending sum), the products
being exact in float32 for bfloat16 inputs.  ``flash_bound`` doubles its
ds and T eps32 terms for bfloat16 inputs and adds p_bf16 = 2**-8 max|v|:
the kernel rounds P to bfloat16 (unit roundoff 2**-9) before P V while
l sums the float32 p, so an output moves by at most 2**-9 sum_j p_j |v_j|
/ l <= 2**-9 max|v|, doubled.  That is the trade the reference makes on
its own chip: the TPU kernel's float32 ``dot_general`` calls set no
``precision``, and a TPU's matrix unit at default precision takes
bfloat16 operands.  ``ssd_bounds(..., tensor_cores=True)`` doubles its
eps32 terms for bfloat16 inputs and adds 2**-8 of the magnitude sums:
the kernel rounds att = G exp(cum_i - cum_j) and w = xdt exp(cum_last -
cum) to bfloat16 before att @ xdt and w^T B, each term moving by at
most 2**-9 of its magnitude, doubled -- the rounding the JAX package's
own bfloat16 path applies (``models/ssm.py``: ``att`` and ``w`` cast to
the compute dtype).  Without ``tensor_cores`` (the plain versions held
to the JAX package) it stays the float32 bound.  The float32 paths keep
their bounds as they were.
"""
import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)


def margins(pts, h, lo, hi):
    """(element bound (N, d), w's margin clear (N,), every margin clear
    (N,)) for the (..., d) points ``pts`` under the fold (h, lo, hi)."""
    d = pts.shape[-1]
    p = pts.reshape(-1, d).astype(np.float64)
    h, lo, hi = (np.asarray(f, np.float64) for f in (h, lo, hi))
    qh = p @ h[:d] + h[d]
    mag = np.abs(p) @ np.abs(h[:d]) + np.abs(h[d])
    w = qh[:, d]
    safe = np.where(w > 0, w, 1.0)[:, None]
    v = qh[:, :d] / safe
    bound = 4 * EPS32 * np.where(w[:, None] > 0,
                                 (mag[:, :d] + np.abs(v) * mag[:, d:]) / safe,
                                 mag[:, :d])
    w_clear = np.abs(w) > 4 * EPS32 * mag[:, d]
    clear = w_clear & np.all((np.abs(v - lo) > bound)
                             & (np.abs(v - hi) > bound), axis=-1)
    return bound, w_clear, clear


def check_projective(pts, folded, out, mask, jout, jmask) -> int:
    """Assert the contract between the port's (out, mask) and the
    reference's (jout, jmask) for one chain's fold; returns the number
    of points whose masks were compared."""
    d = pts.shape[-1]
    out, mask = np.asarray(out), np.asarray(mask)
    assert out.shape == pts.shape and out.dtype == np.float32
    assert mask.shape == pts.shape[:-1] and mask.dtype == np.bool_
    assert np.isfinite(out).all()
    bound, w_clear, clear = margins(pts, *folded)
    err = np.abs(out.reshape(-1, d).astype(np.float64)
                 - np.asarray(jout).reshape(-1, d))
    assert np.all((err <= bound)[w_clear])
    assert np.array_equal(mask.reshape(-1)[clear],
                          np.asarray(jmask).reshape(-1)[clear])
    return int(clear.sum())



def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each |v| (8 significand bits; normal range)."""
    a = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _out_ulp(want: torch.Tensor) -> torch.Tensor | float:
    return bf16_ulp(want) if want.dtype == torch.bfloat16 else 0.0


def rmsnorm_bound(want: torch.Tensor, n: int) -> torch.Tensor:
    """|kernel - plain| per element for rows of width n: the mean of n
    squares in two orders differs by at most (n - 1) eps32 relative,
    rsqrt halves that and adds 2 ulp, and the two products round once
    each: (n / 2 + 4) eps32 |y|, plus one bfloat16 ulp of y."""
    return (n / 2 + 4) * EPS32 * want.float().abs() + _out_ulp(want)


def matmul_bound(x: torch.Tensor, y: torch.Tensor,
                 want: torch.Tensor) -> torch.Tensor:
    """|kernel - plain| per element of the tensor-core ``matmul_2d``
    (bfloat16 inputs) for x (M, K), y (K, N): 2 K eps32 sum_k |x_ik y_kj|,
    plus one bfloat16 ulp for a bfloat16 output."""
    k = x.shape[-1]
    mag = torch.matmul(x.float().abs(), y.float().abs())
    return 2 * k * EPS32 * mag + _out_ulp(want)


def flash_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, want: torch.Tensor) -> torch.Tensor:
    """|kernel - plain| per element of attention over T keys of width D:
    a score, a sum of D products, differs by at most
    ds = D eps32 scale max|q| max|k| (2-norms, Cauchy-Schwarz) between the
    two orders; the probabilities then by 2 ds + 4 eps32 relative (exp and
    the max shift), and the value sum and the denominator over T terms
    by T eps32 each: (4 ds + (2 T + 8) eps32) max|v|, plus one bfloat16
    ulp.  bfloat16 inputs (the tensor-core kernel): (8 ds + (4 T + 8)
    eps32 + 2**-8) max|v|, plus one bfloat16 ulp (module docstring)."""
    d, t = q.shape[-1], k.shape[-2]
    qn = q.float().norm(dim=-1).max()
    kn = k.float().norm(dim=-1).max()
    ds = d * EPS32 * scale * qn * kn
    vmax = v.float().abs().max()
    if q.dtype == torch.bfloat16:
        err = (8 * ds + (4 * t + 8) * EPS32 + 2.0 ** -8) * vmax
    else:
        err = (4 * ds + (2 * t + 8) * EPS32) * vmax
    return err + _out_ulp(want) + torch.zeros_like(want, dtype=torch.float32)


def ssd_bounds(xdt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
               cum: torch.Tensor, plain, *, tensor_cores: bool = False):
    """(|dy| bound, |dS_c| bound) per element for chunks of lc rows and
    state size n: each y element is a sum over lc rows of products whose
    G factor is itself a sum of n, so (n + lc + 8) eps32 times the same
    sums over the magnitudes (the plain version on |xdt|, |B|, |C|);
    each S_c element a sum over lc rows: (lc + 8) eps32 times its
    magnitude sum.  ``plain`` is the plain ``ssd_intra``.

    ``tensor_cores`` with bfloat16 inputs (the wgmma kernel): the eps32
    terms doubled, for the tensor cores' own accumulation order, plus
    2**-8 y_abs and 2**-8 s_abs, since the kernel rounds att and w to
    bfloat16 (unit roundoff 2**-9, doubled) before the products they
    feed, as the JAX package's bfloat16 path does (module docstring).
    The float32 bound is unchanged."""
    lc, n = xdt.shape[1], b_in.shape[-1]
    y_abs, s_abs = plain(xdt.abs(), b_in.abs(), c_in.abs(), cum)
    if tensor_cores and xdt.dtype == torch.bfloat16:
        return ((2 * (n + lc + 8) * EPS32 + 2.0 ** -8) * y_abs,
                (2 * (lc + 8) * EPS32 + 2.0 ** -8) * s_abs)
    return (n + lc + 8) * EPS32 * y_abs, (lc + 8) * EPS32 * s_abs

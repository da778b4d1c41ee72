"""The projective float contract between the port and the JAX package,
shared by the port's parity tests (a helper module, not a test file).

For a float32 fold (H, lo, hi) and (..., d) points p, with v and w the
float64 values of the fold, each projected element may differ by

    4 eps32 [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| + |H_dd|)] / |w|

where w > 0, and by 4 eps32 (sum_m |p_m H_mc| + |H_dc|) where w <= 0
(the guarded divide by 1), because XLA:CPU rounds in another order than
the port's one-op-at-a-time version.  Values are compared wherever w's
margin to 0 exceeds its own bound; masks wherever every margin (w to 0,
each coordinate to lo and hi) exceeds the bound.
"""
import numpy as np

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

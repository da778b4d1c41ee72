"""Fixed-point (Qm.n) execution lane: formats, converters, error bounds.

The port of ``repro.quantize``, the M1-faithful int16 lane in three
layers:

  * ``qformat``  -- ``QFormat`` descriptors ("q8.7"), saturating
    float->int16 quantisers (host numpy + tensor twins, one rounding
    story);
  * ``chains``   -- folded-chain quantisation (``quantize_fold``: the one
    place float32 folds become Qm.n words) and the per-chain error-bound
    model;
  * execution    -- ``repro_torch.kernels.fixedpoint`` (int32-accumulate
    CUDA kernels + the plain versions and the numpy Q oracle), reached
    through ``TransformChain.apply(..., dtype="q8.7")`` and
    ``GeometryServer.submit(..., qformat="q8.7")``.
"""
from repro_torch.quantize.chains import (QUANTIZABLE_KINDS, ensure_fits,
                                         error_bound, fits,
                                         points_need_quantize, quantize_fold,
                                         reject_projective)
from repro_torch.quantize.qformat import (Q8_7, Q15_0, QFormat, as_qformat,
                                          is_qformat)

__all__ = [
    "QFormat", "Q8_7", "Q15_0", "as_qformat", "is_qformat",
    "quantize_fold", "error_bound", "fits", "ensure_fits",
    "QUANTIZABLE_KINDS", "points_need_quantize", "reject_projective",
]

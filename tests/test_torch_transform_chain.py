"""The port's chain compiler against the JAX package's.

Folds are compared BITWISE (both packages run the same numpy fold);
applied results within |port - jax| <= 4 eps32 (sum_m |p_m A_mc| + |t_c|)
per element, against the reference's ``ref`` and ``interpret`` backends
(XLA:CPU contracts some multiply-adds into FMAs; the port never does).
The int16 Qm.n lane (``dtype=``) is compared BITWISE: its arithmetic is
integer, exact and order-independent.  Inputs come from numpy seeds
through both packages' ``chain_for``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro.core import transform_chain as jtc
from repro.kernels import opcount as jopcount
from repro.serving import workload as jworkload
from repro_torch import convert, errors
from repro_torch.core import transform_chain as tc
from repro_torch.kernels import opcount
from repro_torch.kernels.fixedpoint import ref as q_ref
from repro_torch.quantize import Q8_7, quantize_fold
from repro_torch.serving import workload

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def reference_q_plans():
    """Tests that run the JAX package's q lane compile its plans; drop
    them AFTER the test, so a reference test later in the same worker
    that counts its own q8.7 plan compiles (``tests/test_fixedpoint.py``)
    finds the cache as it would alone."""
    yield
    jtc.clear_plan_cache()


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _bound(chain, pts):
    """4 eps32 (sum_m |p_m A_mc| + |t_c|) per element of chain(pts)."""
    p = np.abs(pts.reshape(-1, chain.dim).astype(np.float64))
    folded = [np.abs(f.astype(np.float64)) for f in chain.fold()]
    mag = p * folded[0] if chain.is_diagonal else p @ folded[0]
    return (4 * EPS32 * (mag + folded[1])).reshape(pts.shape)


@pytest.mark.parametrize("seed", [0, 1, 7, 1904])
def test_fold_bitwise_equals_reference_over_every_template(seed):
    """Every ``TEMPLATES`` structure, projective ones included: the port's
    ``chain_for`` draws the same parameters from the same seed, and its
    fold is the reference's, bit for bit."""
    jrng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for dim, kinds in workload.TEMPLATES:
        ref = jworkload.chain_for(jrng, dim, kinds)
        port = workload.chain_for(rng, dim, kinds)
        assert port.structure == ref.structure
        assert port.plan_kind == ref.plan_kind
        want = ref.fold()
        for got in (port.fold(),
                    convert.chain_from_reference(ref.dim, ref.kinds,
                                                 ref.params).fold()):
            assert len(got) == len(want)
            assert all(_same_bits(g, w) for g, w in zip(got, want)), kinds


def test_chain_from_reference_round_trips():
    rng = np.random.default_rng(5)
    for dim, kinds in workload.TEMPLATES:
        ref = jworkload.chain_for(rng, dim, kinds)
        port = convert.chain_from_reference(ref.dim, ref.kinds, ref.params)
        back = jtc.TransformChain(port.dim, port.kinds, port.params)
        assert back.structure == ref.structure
        assert all(_same_bits(a, b) for a, b in zip(back.fold(), ref.fold()))
    with pytest.raises(ValueError):
        convert.chain_from_reference(4, (), ())
    with pytest.raises(ValueError):
        convert.chain_from_reference(2, (("T", -1),), ())


def test_folded_to_torch_keeps_bits():
    chain = workload.chain_for(np.random.default_rng(2), 3, "RMRT")
    folded = chain.fold()
    tensors = convert.folded_to_torch(folded, "cpu")
    assert all(t.dtype == torch.float32 and _same_bits(t.numpy(), f)
               for t, f in zip(tensors, folded))


@pytest.mark.parametrize("dim, kinds", [(2, "TSP"), (3, "TSRP"), (3, "MPC")])
def test_folded_to_torch_keeps_projective_bounds(dim, kinds):
    """(H, lo, hi) crosses over bit for bit, +-inf bounds (no cull)
    included, single and stacked over a batch."""
    rng = np.random.default_rng(len(kinds))
    folds = [workload.chain_for(rng, dim, kinds).fold() for _ in range(3)]
    for folded in (folds[0], tuple(np.stack(p) for p in zip(*folds))):
        tensors = convert.folded_to_torch(folded, "cpu")
        assert len(tensors) == 3
        assert all(t.dtype == torch.float32 and _same_bits(t.numpy(), f)
                   for t, f in zip(tensors, folded))
    _, lo, hi = convert.folded_to_torch(folds[0], "cpu")
    if "C" in kinds:
        assert torch.isfinite(lo).all() and torch.isfinite(hi).all()
    else:
        assert torch.isneginf(lo).all() and torch.isposinf(hi).all()


def test_plan_cache_counts_match_reference():
    rng = np.random.default_rng(21)
    reqs = [(dim, kinds, rng.standard_normal((int(rng.integers(1, 40)), dim))
             .astype(np.float32))
            for dim, kinds in workload.AFFINE_TEMPLATES * 3]
    jtc.clear_plan_cache()
    jtc.reset_stats()
    tc.clear_plan_cache()
    tc.reset_stats()
    crng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    structures = set()
    for dim, kinds, pts in reqs:
        jworkload.chain_for(jrng, dim, kinds).apply(jnp.asarray(pts),
                                                    backend="ref")
        chain = workload.chain_for(crng, dim, kinds)
        chain.apply(torch.from_numpy(pts))
        structures.add(chain.structure)      # 3D rotations draw an axis
    assert tc.stats["compiles"] == jtc.stats["compiles"] == len(structures)
    assert tc.stats["hits"] == jtc.stats["hits"] \
        == len(reqs) - len(structures)
    assert tc.stats["traces"] == 0


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("template", workload.AFFINE_TEMPLATES,
                         ids=lambda t: f"{t[0]}D-{t[1]}")
def test_apply_matches_reference(template, backend):
    dim, kinds = template
    rng = np.random.default_rng([31, dim, len(kinds)])
    for n in (1, 45, 300):
        chain = workload.chain_for(rng, dim, kinds)
        ref = jtc.TransformChain(chain.dim, chain.kinds, chain.params)
        pts = rng.standard_normal((n, dim)).astype(np.float32)
        got = chain.apply(torch.from_numpy(pts))
        assert isinstance(got, torch.Tensor) and got.shape == pts.shape
        want = np.asarray(ref.apply(jnp.asarray(pts), backend=backend))
        assert np.all(np.abs(got.numpy().astype(np.float64) - want)
                      <= _bound(chain, pts))


def test_apply_keeps_leading_shape_and_numpy_input():
    rng = np.random.default_rng(8)
    chain = workload.chain_for(rng, 3, "TRS")
    pts = rng.standard_normal((4, 13, 3)).astype(np.float32)
    got = chain.apply_many(torch.from_numpy(pts))
    assert got.shape == pts.shape
    flat = chain.apply(pts.reshape(-1, 3), device="cpu")
    assert _same_bits(got.numpy().reshape(-1, 3), flat.numpy())
    ident = tc.TransformChain.identity(3)
    assert _same_bits(ident.apply(torch.from_numpy(pts)).numpy(), pts)
    out, mask = chain.project(torch.from_numpy(pts))
    assert torch.equal(out, got) and bool(mask.all()) \
        and mask.shape == pts.shape[:-1]


def test_apply_records_reference_bytes():
    rng = np.random.default_rng(9)
    pts = rng.standard_normal((77, 2)).astype(np.float32)
    for kinds in ("TST", "TSRT"):
        chain = workload.chain_for(rng, 2, kinds)
        ref = jtc.TransformChain(chain.dim, chain.kinds, chain.params)
        with opcount.counting() as got:
            chain.apply(torch.from_numpy(pts))
        with jopcount.counting() as want:
            ref.apply(jnp.asarray(pts), backend="ref")
        assert got == want


def test_boundary_errors_match_reference_taxonomy():
    chain = tc.TransformChain.identity(2).translate(1.0, 2.0)
    cases = [(np.zeros((0, 2), np.float32), errors.EmptyPointsError, "empty"),
             (np.zeros((3, 2), np.float64), errors.DtypeError, "dtype"),
             (np.zeros((3, 3), np.float32), errors.ShapeError, "shape")]
    for pts, cls, code in cases:
        with pytest.raises(cls) as ei:
            chain.apply(torch.from_numpy(pts))
        assert ei.value.code == code and isinstance(ei.value, ValueError)


def test_projective_executes_and_q_lane_raises_not_implemented():
    """A projective chain applies and projects (the projected points of
    ``apply`` are ``project``'s, bitwise; the mask is one bool per point;
    its parity with the reference is ``test_torch_projective.py``'s).
    The Qm.n half once asserted ``NotImplementedError``; the lane is
    ported now, so it asserts that an affine chain executes on it and a
    projective chain is refused with the reference's ``ValueError``."""
    rng = np.random.default_rng(3)
    pts_np = rng.standard_normal((5, 3)).astype(np.float32)
    pts = torch.from_numpy(pts_np)
    proj = workload.chain_for(rng, 3, "MPC")
    assert proj.plan_kind == "projective"
    out, mask = proj.project(pts)
    assert out.shape == pts.shape and out.dtype == torch.float32
    assert mask.shape == (5,) and mask.dtype == torch.bool
    assert torch.equal(proj.apply(pts), out)
    assert torch.equal(proj.apply(pts_np, device="cpu"), out)
    affine = workload.chain_for(rng, 3, "SAT")
    got = affine.apply(pts, dtype="q8.7")
    assert got.dtype == torch.float32 and got.shape == pts.shape
    with pytest.raises(ValueError, match="fixed-point"):
        proj.project(pts, dtype="q8.7")


def test_builder_validation_matches_reference():
    with pytest.raises(ValueError):
        tc.TransformChain.identity(4)
    with pytest.raises(ValueError):
        tc.TransformChain.identity(3).rotate(0.1)
    with pytest.raises(ValueError):
        tc.TransformChain.identity(2).rotate(0.1, axis="x")
    with pytest.raises(ValueError):
        tc.TransformChain.identity(2).translate(1.0, 2.0, 3.0)
    persp = np.eye(3, dtype=np.float32)
    persp[0, 2] = 0.5
    with pytest.raises(ValueError, match="projective"):
        tc.TransformChain.identity(2).matrix(persp).fold()


# -- the int16 Qm.n lane ----------------------------------------------------

def _q_oracle(chain, words):
    folded_q = quantize_fold(chain.fold(), chain.plan_kind, Q8_7)
    oracle = q_ref.np_chain_diag_q if chain.is_diagonal \
        else q_ref.np_chain_matrix_q
    return oracle(words.reshape(-1, chain.dim), *folded_q,
                  Q8_7.n).reshape(words.shape)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("template", workload.AFFINE_TEMPLATES,
                         ids=lambda t: f"{t[0]}D-{t[1]}")
def test_apply_q_matches_reference_bitwise(template, backend,
                                           reference_q_plans):
    """Float points in, float32 out; int16 words in, int16 out; both
    bitwise equal to the reference's lane and to the numpy Q oracle, and
    ``project(dtype=)`` returns the same points with an all-True mask."""
    dim, kinds = template
    rng = np.random.default_rng([32, dim, len(kinds)])
    for n in (1, 45, 300):
        chain = workload.chain_for(rng, dim, kinds)
        ref = jtc.TransformChain(chain.dim, chain.kinds, chain.params)
        pts = rng.uniform(-6, 6, (n, dim)).astype(np.float32)
        words = Q8_7.quantize(pts)
        for sub in (pts, words):
            got = chain.apply(torch.from_numpy(sub), dtype="q8.7")
            want = np.asarray(ref.apply(jnp.asarray(sub), dtype="q8.7",
                                        backend=backend))
            assert _same_bits(got.numpy(), want)
        assert _same_bits(got.numpy(), _q_oracle(chain, words))
        out, mask = chain.project(torch.from_numpy(words), dtype="q8.7")
        assert torch.equal(out, got) and mask.dtype == torch.bool
        assert bool(mask.all()) and mask.shape == (n,)
        fgot = chain.apply(torch.from_numpy(pts), dtype="q8.7").numpy()
        assert _same_bits(fgot, Q8_7.dequantize(_q_oracle(chain, words)))


def test_apply_q_keeps_shape_and_wraps_like_reference(reference_q_plans):
    """A leading batch axis through ``apply_many``, numpy input to the
    CPU, and points far out of range: float points saturate at the
    boundary, int16 words wrap in the lane, both as the reference does."""
    rng = np.random.default_rng(33)
    chain = workload.chain_for(rng, 2, "TSRT")
    ref = jtc.TransformChain(chain.dim, chain.kinds, chain.params)
    big = rng.uniform(-600, 600, (3, 17, 2)).astype(np.float32)
    words = rng.integers(-(1 << 15), 1 << 15, (3, 17, 2)).astype(np.int16)
    for sub in (big, words):
        got = chain.apply_many(torch.from_numpy(sub), dtype="q8.7")
        assert got.shape == sub.shape
        want = ref.apply(jnp.asarray(sub), dtype="q8.7", backend="ref")
        assert _same_bits(got.numpy(), np.asarray(want))
        assert _same_bits(chain.apply(sub, dtype="q8.7", device="cpu")
                          .numpy(), got.numpy())
    ident = tc.TransformChain.identity(2)
    assert _same_bits(ident.apply(torch.from_numpy(big), dtype="q8.7")
                      .numpy(), big)


def test_q_plan_cache_and_bytes_match_reference(reference_q_plans):
    """The q lane compiles its own plan per (structure, backend, format),
    beside the float lane's, and records ``chain_fused_*_q`` bytes at two
    bytes a word -- the reference's counters and records exactly."""
    rng = np.random.default_rng(34)
    pts = rng.uniform(-3, 3, (77, 3)).astype(np.float32)
    jtc.clear_plan_cache()
    jtc.reset_stats()
    tc.clear_plan_cache()
    tc.reset_stats()
    crng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    plans, calls = set(), 0
    with opcount.counting() as got, jopcount.counting() as want:
        for kinds in ("SAT", "TRS", "SAT", "TRS"):
            chain = workload.chain_for(crng, 3, kinds)
            ref = jworkload.chain_for(jrng, 3, kinds)
            for dtype in ("q8.7", "q8.7", None, "q4.11"):
                chain.apply(torch.from_numpy(pts), dtype=dtype)
                ref.apply(jnp.asarray(pts), dtype=dtype, backend="ref")
                plans.add((chain.structure, dtype))
                calls += 1
    assert got == want
    assert {op for op, _ in got} == {"chain_fused_diag_q",
                                     "chain_fused_matrix_q",
                                     "chain_fused_diag", "chain_fused_matrix"}
    q_bytes = [b for op, b in got if op == "chain_fused_matrix_q"]
    f_bytes = [b for op, b in got if op == "chain_fused_matrix"]
    assert 2 * q_bytes[0] == f_bytes[0]
    assert tc.stats["compiles"] == jtc.stats["compiles"]
    assert tc.stats["hits"] == jtc.stats["hits"]
    assert tc.stats["compiles"] == len(plans)
    assert tc.stats["hits"] == calls - len(plans)


def test_q_lane_rejects_projective_and_bad_formats(reference_q_plans):
    rng = np.random.default_rng(35)
    pts = torch.from_numpy(rng.uniform(-1, 1, (5, 3)).astype(np.float32))
    proj = tc.TransformChain.identity(3).projective(
        np.eye(4, dtype=np.float32)).cull()
    jproj = jtc.TransformChain(proj.dim, proj.kinds, proj.params)
    for call in (proj.apply, proj.project):
        with pytest.raises(ValueError, match="fixed-point") as got:
            call(pts, dtype="q8.7")
    with pytest.raises(ValueError) as want:
        jproj.apply(jnp.asarray(pts.numpy()), dtype="q8.7")
    assert str(got.value) == str(want.value)
    affine = workload.chain_for(rng, 3, "SAT")
    with pytest.raises(ValueError, match="not a fixed-point format"):
        affine.apply(pts, dtype="float32")
    with pytest.raises(TypeError, match="float .* or int16"):
        affine.apply(pts.to(torch.int32), dtype="q8.7")
    with pytest.raises(errors.DtypeError):
        affine.apply(pts.double(), dtype="q8.7")

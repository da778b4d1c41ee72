"""The port's chain compiler against the JAX package's.

Folds are compared BITWISE (both packages run the same numpy fold);
applied results within |port - jax| <= 4 eps32 (sum_m |p_m A_mc| + |t_c|)
per element, against the reference's ``ref`` and ``interpret`` backends
(XLA:CPU contracts some multiply-adds into FMAs; the port never does).
Inputs come from numpy seeds through both packages' ``chain_for``.
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
from repro_torch.serving import workload

EPS32 = float(np.finfo(np.float32).eps)


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


def test_projective_and_q_lane_raise_not_implemented():
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    proj = workload.chain_for(rng, 3, "MPC")
    assert proj.plan_kind == "projective"
    with pytest.raises(NotImplementedError, match="graphics slice"):
        proj.apply(pts)
    with pytest.raises(NotImplementedError, match="graphics slice"):
        proj.project(pts)
    affine = workload.chain_for(rng, 3, "SAT")
    with pytest.raises(NotImplementedError, match="Qm.n"):
        affine.apply(pts, dtype="q8.7")


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

"""The port's projective lane against the JAX package's.

The same numpy seeds go through both packages' ``chain_for`` (2D and 3D
projective structures), and the same points through the port's plain
PyTorch version (the path a CPU tensor takes) and through the JAX
package's ``ref`` oracle and its Pallas kernel in interpret mode.  The
folds are bitwise equal; the projected values and masks agree within the
float contract of ``torch_bounds.py``,

    4 eps32 [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| + |H_dd|)] / |w|

per element (4 eps32 (sum_m |p_m H_mc| + |H_dc|) where w <= 0), masks
equal wherever every margin exceeds that bound.  Within the port the
batch form, ``TransformChain.project``/``apply`` and the kernel entry
agree bit for bit.  The CUDA kernels are held against the plain version
in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import kernels as jkernels
from repro.core import transform_chain as jtc
from repro.kernels import opcount as jopcount
from repro.serving import workload as jworkload
from repro_torch.core import transform_chain as tc
from repro_torch.kernels import chain_project, chain_project_batch, opcount
from repro_torch.kernels.projective import ref as proj_ref
from repro_torch.serving import workload
from torch_bounds import EPS32, check_projective as _check

#: projective structures per dim: the TEMPLATES ones, a cull-free and a
#: culled chain with a viewport-style affine after the cull
STRUCTURES = {2: ("TSP", "MPC", "RPCA"), 3: ("TSRP", "MPC", "TRPCA")}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _chains(seed, dim, n_each=3):
    """(port chain, reference chain) pairs drawn from one seed through
    both packages' ``chain_for``: their folds are bitwise equal."""
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    pairs = []
    for kinds in STRUCTURES[dim]:
        for _ in range(n_each):
            port = workload.chain_for(rng, dim, kinds)
            ref = jworkload.chain_for(jrng, dim, kinds)
            assert all(_same_bits(a, b)
                       for a, b in zip(port.fold(), ref.fold()))
            pairs.append((port, ref))
    return pairs


def _points(rng, shape):
    """Points at a spread of scales: most land inside the cull bounds,
    some outside, a few behind the center of projection (w <= 0)."""
    scale = rng.choice([1.0, 4.0, 30.0], size=shape[:-1] + (1,))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_matches_reference_within_bound(dim, backend):
    rng = np.random.default_rng([61, dim])
    decided = culled = 0
    for port, ref in _chains(100 + dim, dim):
        folded = port.fold()
        for n in (1, 37, 300):
            pts = _points(rng, (n, dim))
            out, mask = chain_project(torch.from_numpy(pts), *folded)
            jout, jmask = jkernels.chain_project(jnp.asarray(pts),
                                                 *ref.fold(), backend=backend)
            decided += _check(pts, folded, out, mask, jout, jmask)
            culled += int((~mask.numpy()).sum())
            # the chain-level entry is the same single launch, bitwise
            got, gmask = port.project(torch.from_numpy(pts))
            assert _same_bits(got.numpy(), out.numpy())
            assert _same_bits(gmask.numpy(), mask.numpy())
    assert decided > 0 and culled > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_chain_project_matches_reference_chain(dim):
    """``TransformChain.project`` against the reference's, on its ``ref``
    backend (the jitted plan path)."""
    rng = np.random.default_rng([62, dim])
    for port, ref in _chains(200 + dim, dim, n_each=2):
        pts = _points(rng, (4, 29, dim))
        out, mask = port.project(torch.from_numpy(pts))
        jout, jmask = ref.project(jnp.asarray(pts), backend="ref")
        _check(pts, port.fold(), out, mask, jout, jmask)
        assert _same_bits(port.apply(torch.from_numpy(pts)).numpy(),
                          out.numpy())


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dim", [2, 3])
def test_batch_plain_matches_reference_and_rows_bitwise(dim, backend):
    """The packed (B, L, d) form within the bound of the reference's
    batch entry, and each row bit for bit the per-request form."""
    rng = np.random.default_rng([63, dim])
    pairs = _chains(300 + dim, dim, n_each=2)
    pts3 = _points(rng, (len(pairs), 40, dim))
    folds = [p.fold() for p, _ in pairs]
    h3, lo2, hi2 = (np.stack(part) for part in zip(*folds))
    out, mask = chain_project_batch(torch.from_numpy(pts3),
                                    *(torch.from_numpy(a)
                                      for a in (h3, lo2, hi2)))
    assert out.shape == pts3.shape and mask.shape == pts3.shape[:2]
    jout, jmask = jkernels.chain_project_batch(jnp.asarray(pts3), h3, lo2,
                                               hi2, backend=backend)
    for b, folded in enumerate(folds):
        _check(pts3[b], folded, out[b], mask[b], np.asarray(jout)[b],
               np.asarray(jmask)[b])
        row, rmask = chain_project(torch.from_numpy(pts3[b]), *folded)
        assert _same_bits(out[b].numpy(), row.numpy())
        assert _same_bits(mask[b].numpy(), rmask.numpy())


def test_plain_version_is_the_oracle_order():
    """The plain version sums the products over m and adds the
    translation row last, one rounded op at a time -- the reference
    oracle's order -- so a numpy float32 replay of that order is equal
    bit for bit."""
    rng = np.random.default_rng(64)
    for dim in (2, 3):
        for port, _ in _chains(400 + dim, dim, n_each=1):
            h, lo, hi = port.fold()
            pts = _points(rng, (500, dim))
            cols = []
            for c in range(dim + 1):
                acc = pts[:, 0] * h[0, c]
                for m in range(1, dim):
                    acc = acc + pts[:, m] * h[m, c]
                cols.append(acc + h[dim, c])
            w = cols.pop()
            safe = np.where(w > 0, w, np.float32(1.0))
            v = np.stack([c / safe for c in cols], axis=-1)
            inside = (w > 0) & np.all((v >= lo) & (v <= hi), axis=-1)
            out, mask = proj_ref.chain_project(
                torch.from_numpy(pts), *(torch.from_numpy(f)
                                         for f in (h, lo, hi)))
            assert _same_bits(out.numpy(), v)
            assert _same_bits(mask.numpy(), inside)


# -- cull-mask edge cases -----------------------------------------------------

def test_w_nonpositive_is_culled_and_finite():
    """Points behind the center of projection (w < 0) and AT it (w == 0)
    are masked out, and their coordinates stay finite (divided by 1)."""
    h = np.eye(4, dtype=np.float32)
    h[2, 3], h[3, 3] = 1.0, 0.0            # w = z
    chain = tc.TransformChain.identity(3).projective(h)
    pts = np.array([[1.0, 2.0, 4.0],       # w = 4  -> inside
                    [1.0, 2.0, -1.0],      # w = -1 -> culled
                    [1.0, 2.0, 0.0]],      # w = 0  -> culled
                   np.float32)
    out, mask = chain.project(torch.from_numpy(pts))
    assert mask.tolist() == [True, False, False]
    assert torch.isfinite(out).all()
    assert out[0].tolist() == [0.25, 0.5, 1.0]
    assert out[1].tolist() == [1.0, 2.0, -1.0]  # divided by 1
    jout, jmask = jtc.TransformChain(3, chain.kinds, chain.params).project(
        jnp.asarray(pts), backend="ref")
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert _same_bits(out.numpy(), np.asarray(jout))


def test_points_on_frustum_planes_are_inside():
    """The cull is inclusive: exactly +-1 is inside, one step beyond is
    outside; a cull-only chain passes the points through unchanged."""
    eps = np.float32(EPS32)
    chain = tc.TransformChain.identity(2).cull(-1.0, 1.0)
    pts = np.array([[1.0, -1.0],
                    [1.0 + 2 * eps, 0.0],
                    [0.0, -1.0 - 2 * eps],
                    [0.5, 0.5]], np.float32)
    out, mask = chain.project(torch.from_numpy(pts))
    assert mask.tolist() == [True, False, False, True]
    assert _same_bits(out.numpy(), pts)


def test_mask_is_per_point_not_per_coordinate():
    chain = tc.TransformChain.identity(3).cull(-1.0, 1.0)
    pts = np.array([[0.0, 0.0, 0.0],
                    [0.0, 5.0, 0.0],       # only y out of bounds
                    [0.0, 0.0, -5.0]],     # only z out of bounds
                   np.float32)
    out, mask = chain.project(torch.from_numpy(pts))
    assert mask.shape == (3,) and mask.tolist() == [True, False, False]


def test_unbounded_cull_keeps_every_point_with_positive_w():
    """``lo``/``hi`` of None are -inf/+inf: the mask is exactly w > 0,
    even for points far outside any finite box."""
    rng = np.random.default_rng(65)
    h = np.eye(3, dtype=np.float32)
    h[0, 2] = 0.5                          # w = 0.5 x + 1
    pts = (rng.standard_normal((400, 2)) * 1e6).astype(np.float32)
    out, mask = chain_project(torch.from_numpy(pts), h)
    w = pts[:, 0] * np.float32(0.5) + pts[:, 1] * np.float32(0.0) \
        + np.float32(1.0)
    assert np.array_equal(mask.numpy(), w > 0)
    assert 0 < int(mask.sum()) < 400
    lo = torch.full((2,), -float("inf"))
    out2, mask2 = chain_project(torch.from_numpy(pts), h, lo,
                                torch.full((2,), float("inf")))
    assert _same_bits(out2.numpy(), out.numpy())
    assert torch.equal(mask2, mask)


def test_empty_inputs_give_empty_results():
    h = torch.eye(4)
    out, mask = chain_project(torch.zeros(0, 3), h, -1.0, 1.0)
    assert out.shape == (0, 3) and mask.shape == (0,) \
        and mask.dtype == torch.bool
    out, mask = chain_project_batch(torch.zeros(2, 0, 3), h, -1.0, 1.0)
    assert out.shape == (2, 0, 3) and mask.shape == (2, 0)
    out, mask = chain_project_batch(torch.zeros(0, 5, 2), torch.eye(3))
    assert out.shape == (0, 5, 2) and mask.shape == (0, 5)


# -- plan cache, API surface and byte accounting --------------------------------

def test_projective_plan_cache_does_not_recompile():
    rng = np.random.default_rng(66)
    port, ref = _chains(500, 3, n_each=1)[0]
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    small = rng.standard_normal((7, 3)).astype(np.float32)
    tc.clear_plan_cache()
    tc.reset_stats()
    jtc.clear_plan_cache()
    jtc.reset_stats()
    for p in (pts, pts, small):
        port.project(torch.from_numpy(p))
        ref.project(jnp.asarray(p), backend="ref")
    port.apply(torch.from_numpy(pts))
    ref.apply(jnp.asarray(pts), backend="ref")
    assert tc.stats["compiles"] == jtc.stats["compiles"] == 1
    assert tc.stats["hits"] == jtc.stats["hits"] == 3
    assert tc.stats["traces"] == 0


def test_apply_equals_project_points_and_affine_project_is_trivial():
    rng = np.random.default_rng(9)
    pts = torch.from_numpy(rng.standard_normal((40, 2)).astype(np.float32))
    proj, _ = _chains(600, 2, n_each=1)[2]
    assert torch.equal(proj.apply(pts), proj.project(pts)[0])
    affine = tc.TransformChain.identity(2).scale(2.0).translate(1.0, -1.0)
    out, mask = affine.project(pts)
    assert torch.equal(out, affine.apply(pts))
    assert mask.dtype == torch.bool and bool(mask.all()) \
        and mask.shape == (40,)


def test_projective_chain_is_one_launch_and_records_reference_bytes():
    rng = np.random.default_rng(67)
    for dim in (2, 3):
        for port, ref in _chains(700 + dim, dim, n_each=1):
            pts = rng.standard_normal((3, 41, dim)).astype(np.float32)
            for method in ("project", "apply"):
                with opcount.counting() as got:
                    getattr(port, method)(torch.from_numpy(pts))
                with jopcount.counting() as want:
                    getattr(ref, method)(jnp.asarray(pts), backend="ref")
                assert got == want
                ((op, nbytes),) = got
                assert op == "chain_fused_projective"
                assert nbytes == opcount.fused_chain_bytes(
                    3 * 41, dim, kind="projective")

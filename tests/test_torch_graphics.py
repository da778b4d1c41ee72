"""The port's graphics pipeline against the JAX package's.

``repro_torch.graphics`` is a numpy copy of ``repro.graphics``: camera,
projection and viewport matrices are compared BITWISE, and so are the
folds of the viewing chains built from them.  Projected points agree
with the reference's within the projective float contract of
``torch_bounds.py``,

    4 eps32 [(sum_m |p_m H_mc| + |H_dc|) + |v_c| (sum_m |p_m H_md| + |H_dd|)] / |w|

with masks equal wherever every margin exceeds it.  The behaviour tests
are the port's counterparts of ``tests/test_graphics.py``: camera and
viewport semantics, cull bounds folding through the viewport, the
``Projected`` mask, one launch per viewing chain and per bucket, and the
reference's byte accounting.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro import graphics as jgraphics
from repro import serving as jserving
from repro.core import transform_chain as jtc
from repro.kernels import opcount as jopcount
from repro_torch import errors, graphics, serving
from repro_torch.core import transform_chain as tc
from repro_torch.kernels import opcount
from repro_torch.serving import workload
from torch_bounds import check_projective as _check


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _to_reference(chain):
    return jtc.TransformChain(chain.dim, chain.kinds, chain.params)


CAMERAS = [dict(eye=(3.0, 2.0, 6.0), target=(0.0, 0.0, 0.0),
                fov_y=np.pi / 3, aspect=16 / 9, near=0.5, far=50.0),
           dict(eye=(-1.0, 4.0, 2.5), target=(0.5, -0.5, 1.0),
                up=(0.0, 0.0, 1.0), fov_y=np.pi / 2, near=0.1, far=100.0),
           dict(eye=(0.0, 0.0, 5.0), fov_y=None, aspect=1.5,
                ortho_half=2.0, near=1.0, far=20.0)]


# -- the matrices and folds are the reference's, bit for bit ---------------------

@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_camera_matrices_bitwise_equal_reference(cam):
    port, ref = graphics.Camera(**CAMERAS[cam]), \
        jgraphics.Camera(**CAMERAS[cam])
    assert _same_bits(port.view_matrix(), ref.view_matrix())
    assert _same_bits(port.projection_matrix(), ref.projection_matrix())
    args = (CAMERAS[cam]["eye"], CAMERAS[cam].get("target", (0, 0, 0)))
    assert _same_bits(graphics.look_at(*args), jgraphics.look_at(*args))
    assert _same_bits(graphics.perspective(1.1, 0.8, 0.3, 70.0),
                      jgraphics.perspective(1.1, 0.8, 0.3, 70.0))
    assert _same_bits(graphics.orthographic(-3, 2, -1, 4, 0.5, 9.0),
                      jgraphics.orthographic(-3, 2, -1, 4, 0.5, 9.0))
    for dim in (2, 3):
        vp = (10.0, 20.0, 1920.0, 1080.0, (0.25, 1.0))
        got = graphics.Viewport(*vp).scale_offset(dim)
        want = jgraphics.Viewport(*vp).scale_offset(dim)
        assert all(_same_bits(a, b) for g, w in zip(got, want)
                   for a, b in zip(g, w))


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_viewing_chain_folds_bitwise_equal_reference(cam):
    vp = dict(x=0.0, y=0.0, width=640.0, height=480.0)
    model = dict(theta=0.4, s=1.2, t=(0.1, 0.0, -0.3))

    def build(pkg, tcm, **kw):
        m = (tcm.TransformChain.identity(3).rotate(model["theta"], axis="y")
             .scale(model["s"]).translate(*model["t"]))
        return pkg.viewing_chain(model=m, camera=pkg.Camera(**CAMERAS[cam]),
                                 viewport=pkg.Viewport(**vp), **kw)

    for kw in ({}, {"cull": False}, {"projection": False, "cull": False}):
        port, ref = build(graphics, tc, **kw), build(jgraphics, jtc, **kw)
        assert port.structure == ref.structure
        assert port.plan_kind == ref.plan_kind
        assert all(_same_bits(a, b) for a, b in zip(port.fold(), ref.fold()))
    persp = np.eye(3, dtype=np.float32)
    persp[0, 2] = 0.2
    port2 = graphics.viewing_chain(2, projection=persp,
                                   viewport=graphics.Viewport(0, 0, 8, 6))
    ref2 = jgraphics.viewing_chain(2, projection=persp,
                                   viewport=jgraphics.Viewport(0, 0, 8, 6))
    assert all(_same_bits(a, b) for a, b in zip(port2.fold(), ref2.fold()))


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_viewing_chain_projects_like_reference(cam):
    rng = np.random.default_rng([71, cam])
    chain = graphics.viewing_chain(camera=graphics.Camera(**CAMERAS[cam]),
                                   viewport=graphics.Viewport(0, 0, 1920,
                                                              1080))
    pts = (rng.standard_normal((2000, 3)) * 4).astype(np.float32)
    out, mask = chain.project(torch.from_numpy(pts))
    jout, jmask = _to_reference(chain).project(jnp.asarray(pts),
                                               backend="ref")
    _check(pts, chain.fold(), out.numpy(), mask.numpy(), jout, jmask)
    assert 0 < int(mask.sum()) < len(pts)


# -- camera and viewport semantics ----------------------------------------------

def test_look_at_centers_target_and_culls_behind():
    cam = graphics.Camera(eye=(3.0, 2.0, 5.0), target=(0.5, -0.5, 1.0),
                          fov_y=np.pi / 2, near=0.1, far=100.0)
    chain = graphics.viewing_chain(
        camera=cam, viewport=graphics.Viewport(0.0, 0.0, 640.0, 480.0))
    eye = np.asarray(cam.eye, np.float32)
    tgt = np.asarray(cam.target, np.float32)
    behind = eye + (eye - tgt)
    out, mask = chain.project(torch.from_numpy(np.stack([tgt, behind])))
    assert mask.tolist() == [True, False]
    assert np.allclose(out[0, :2].numpy(), [320.0, 240.0], atol=1e-3)


def test_perspective_near_far_map_to_depth_range():
    cam = graphics.Camera(eye=(0.0, 0.0, 0.0), target=(0.0, 0.0, -1.0),
                          fov_y=np.pi / 2, near=1.0, far=10.0)
    chain = graphics.viewing_chain(
        camera=cam, viewport=graphics.Viewport(0.0, 0.0, 2.0, 2.0,
                                               depth=(0.0, 1.0)))
    pts = np.array([[0.0, 0.0, -1.0],      # on the near plane
                    [0.0, 0.0, -10.0],     # on the far plane
                    [0.0, 0.0, -0.5],      # nearer than near -> culled
                    [0.0, 0.0, -20.0]],    # beyond far -> culled
                   np.float32)
    out, mask = chain.project(torch.from_numpy(pts))
    assert mask.tolist() == [True, True, False, False]
    assert abs(float(out[0, 2])) <= 1e-5
    assert abs(float(out[1, 2]) - 1.0) <= 1e-5


def test_orthographic_keeps_w_one_and_culls_on_bounds():
    h = graphics.orthographic(-2.0, 2.0, -1.0, 1.0, 1.0, 10.0)
    chain = tc.TransformChain.identity(3).projective(h).cull()
    pts = np.array([[0.0, 0.0, -5.0],
                    [3.0, 0.0, -5.0],      # x outside the box
                    [0.0, 0.0, -20.0]],    # beyond far
                   np.float32)
    out, mask = chain.project(torch.from_numpy(pts))
    assert mask.tolist() == [True, False, False]
    assert np.allclose(out[0].numpy(), [0.0, 0.0, -1.0 / 9.0], atol=1e-5)


def test_camera_validation():
    with pytest.raises(ValueError):
        graphics.look_at((0, 0, 0), (0, 0, 0))
    with pytest.raises(ValueError):
        graphics.perspective(0.0, 1.0, 0.1, 10.0)
    with pytest.raises(ValueError):
        graphics.perspective(1.0, 1.0, 5.0, 1.0)
    with pytest.raises(ValueError):
        graphics.Viewport().scale_offset(4)
    with pytest.raises(ValueError):
        graphics.viewing_chain(2, camera=graphics.Camera())
    with pytest.raises(ValueError):
        graphics.viewing_chain(3, model=tc.TransformChain.identity(2))


def test_cull_bounds_fold_through_viewport():
    """cull(-1, 1) then a viewport affine culls against the MAPPED bounds:
    the same points survive with and without the suffix (negative scales
    flip the bounds)."""
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-2, 2, (200, 2)).astype(np.float32))
    base = tc.TransformChain.identity(2).scale(0.7, 1.3).cull(-1.0, 1.0)
    _, mask0 = base.project(pts)
    assert 0 < int(mask0.sum()) < 200
    for s in ((8.0, 4.0), (-8.0, 4.0), (3.0, -2.0)):
        _, mask1 = base.affine(s, (1.0, -2.0)).project(pts)
        assert torch.equal(mask1, mask0)


def test_matrix_rejects_perspective_column_and_nonaffine_after_cull():
    persp = graphics.perspective(np.pi / 3, 1.0, 0.5, 40.0)
    with pytest.raises(ValueError, match="projective"):
        tc.TransformChain.identity(3).matrix(persp).fold()
    with pytest.raises(ValueError, match="projective"):
        tc.TransformChain.identity(3).matrix(persp).cull().fold()
    tc.TransformChain.identity(3).matrix(
        graphics.look_at((1.0, 2.0, 3.0), (0.0, 0.0, 0.0))).fold()
    base = tc.TransformChain.identity(2).cull()
    for bad in (base.rotate(0.3),
                base.matrix(np.eye(2, dtype=np.float32)),
                base.projective(np.eye(3, dtype=np.float32))):
        with pytest.raises(ValueError):
            bad.fold()


def test_projected_mask_never_inherited_by_derived_arrays():
    res = serving.engine._projected(
        np.arange(18, dtype=np.float32).reshape(6, 3),
        np.array([1, 0, 1, 0, 1, 0], bool))
    assert isinstance(res, serving.Projected)
    assert res.mask is not None and res.mask.shape == (6,)
    assert res[:4].mask is None
    assert res.T.mask is None
    assert res.reshape(-1).mask is None
    assert res[::-1].mask is None
    assert res[np.argsort(res[:, 0])[::-1]].mask is None
    assert (res * 2).mask is None


# -- one launch per chain and per bucket, the reference's bytes ----------------------

def test_viewing_chain_is_one_launch_and_fewer_bytes():
    rng = np.random.default_rng(72)
    pts = torch.from_numpy((rng.standard_normal((4096, 3)) * 0.5)
                           .astype(np.float32))
    chain = graphics.viewing_chain(
        model=tc.TransformChain.identity(3).rotate(0.4, axis="y")
        .scale(1.2).translate(0.1, 0.0, 0.0),
        camera=graphics.Camera(eye=(2.0, 1.0, 4.0), near=0.5, far=30.0),
        viewport=graphics.Viewport(0, 0, 640, 480))
    singles = [tc.TransformChain(chain.dim, (ka,), (p,))
               for ka, p in zip(chain.kinds, chain.params)]
    with opcount.counting() as staged:
        q = pts
        for single in singles:
            q = single.apply(q)
    with opcount.counting() as fused:
        chain.project(pts)
    with jopcount.counting() as want:
        _to_reference(chain).project(jnp.asarray(pts.numpy()), backend="ref")
    assert fused == want
    ((op, nbytes),) = fused
    assert op == "chain_fused_projective"
    assert nbytes == 3 * pts.numel() * 4 + 4 * (4 ** 2 + 2 * 3)
    assert len(staged) == len(chain) and nbytes < opcount.total_bytes(staged)


def _frames(n=10, seed=31):
    rng = np.random.default_rng(seed)
    cam = graphics.Camera(eye=(0.0, 1.0, 5.0), near=0.5, far=25.0)
    reqs = []
    for _ in range(n):
        model = (tc.TransformChain.identity(3)
                 .rotate(float(rng.uniform(-1, 1)), axis="y")
                 .scale(float(rng.uniform(0.8, 1.2))))
        chain = graphics.viewing_chain(
            model=model, camera=cam,
            viewport=graphics.Viewport(0, 0, 64, 48))
        pts = rng.uniform(-1.5, 1.5,
                          (int(rng.integers(33, 64)), 3)).astype(np.float32)
        reqs.append((chain, pts))          # every length pads to lpad=64
    return reqs


def test_server_buckets_viewing_chains_into_one_launch():
    """Many viewing chains of one structure are ONE launch, and every
    result carries per-request ``project``'s points and mask, bitwise."""
    serving.reset_stats()
    serving.clear_plan_cache()
    reqs = _frames()
    srv = serving.GeometryServer(device="cpu")
    outs = srv.serve(reqs)
    assert serving.stats["launches"] == serving.stats["buckets"] == 1
    assert srv.last_report[0].kind == "projective"
    for (chain, pts), out in zip(reqs, outs):
        assert isinstance(out, serving.Projected)
        got, mask = chain.project(torch.from_numpy(pts))
        assert _same_bits(out, got.numpy())
        assert _same_bits(out.mask, mask.numpy())


def test_serving_records_reference_projective_bytes():
    reqs = _frames(n=8, seed=7)
    serving.reset_stats()
    serving.clear_plan_cache()
    with opcount.counting() as got:
        serving.GeometryServer(device="cpu").serve(reqs)
    jserving.reset_stats()
    jserving.clear_plan_cache()
    with jopcount.counting() as want:
        jserving.GeometryServer(backend="ref").serve(
            [(_to_reference(c), p) for c, p in reqs])
    assert got == want
    ((op, nbytes),) = got
    assert op == "serve_bucket_projective"
    assert nbytes == opcount.packed_chain_bytes(8, 64, 3, kind="projective")
    assert serving.stats["launches"] == jserving.stats["launches"] == 1


def test_empty_projective_request_rejected_at_submit():
    serving.reset_stats()
    srv = serving.GeometryServer(device="cpu")
    chain = workload.chain_for(np.random.default_rng(0), 3, "TSRP")
    with pytest.raises(errors.EmptyPointsError) as ei:
        srv.submit(chain, np.zeros((0, 3), np.float32))
    assert ei.value.ticket == 0
    assert srv.flush() == []
    assert serving.stats["launches"] == 0
    assert serving.stats["rejected_requests"] == 1


def test_mixed_affine_projective_workload_saves_launches():
    serving.reset_stats()
    serving.clear_plan_cache()
    reqs = workload.random_workload(seed=2207, n_requests=64, max_points=512)
    assert any(c.is_projective for c, _ in reqs)
    srv = serving.GeometryServer(device="cpu")
    outs = srv.serve(reqs)
    assert serving.stats["requests"] == 64
    assert serving.stats["launches"] < 64
    assert any(r.kind == "projective" for r in srv.last_report)
    for (chain, pts), out in zip(reqs, outs):
        assert isinstance(out, serving.Projected) == chain.is_projective
        if chain.is_projective:
            assert out.mask.shape == pts.shape[:-1]

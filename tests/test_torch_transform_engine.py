"""The port's transform engine and table arithmetic against the JAX
package's.

  * ``Transform2D``/``Transform3D.matrix`` (``as_homogeneous``) and
    ``TransformChain.folded`` are bitwise equal to the JAX package's:
    both come from the same numpy fold, cast once to float32;
  * ``.apply`` is bitwise the port's own ``TransformChain.apply``;
  * the eager primitives of ``core/transform_engine.py`` take numpy in and
    match the JAX engine's within the bounds of ``test_torch_primitives``;
  * the paper's sequential 4-primitive pipeline (translate, scale, rotate,
    translate) and the fused chain agree within 8 eps32 mag_c, where
    mag_c = sum_m (|p_m| + |t2_m|) |s_m| |R_mc| + |t1_c|: each lies within
    4 eps32 mag_c of the float64 value of the exact transform (the per-
    primitive roundings, the float32 fold and the float32 cos/sin each
    add at most eps32/2 to eps32 of mag_c);
  * ``analysis.derive`` and ``format_table`` give the JAX package's rows
    and text.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro.core import analysis as jax_analysis
from repro.core import transform_chain as jax_tc
from repro.core import transform_engine as jax_te
from repro.core.morphosys import intel as jax_intel
from repro_torch.core import analysis, transform_engine as te
from repro_torch.core.transform_chain import TransformChain
from repro_torch.kernels import _build, opcount

EPS32 = float(np.finfo(np.float32).eps)
T1, T2, SV, THETA = (3.0, 2.0), (-1.0, 5.0), (1.3, 0.8), 0.3


def _chains_2d():
    """(port, JAX) Transform2D pairs over the builder calls and kinds."""
    m = np.array([[0.5, 0.2, 0.0], [-0.3, 1.1, 0.0], [2.0, -1.0, 1.0]],
                 np.float32)
    builds = [
        lambda t: t,
        lambda t: t.then_translate(1.5, -2.0),
        lambda t: t.then_scale(2.0, 0.5).then_translate(0.25, 3.0),
        lambda t: t.then_translate(*T2).then_scale(*SV).then_rotate(THETA)
        .then_translate(*T1),
        lambda t: t.then_rotate(-1.1).then_rotate(2.4).then_scale(-1.0, 3.0),
    ]
    pairs = [(b(te.Transform2D.identity(device="cpu")),
              b(jax_te.Transform2D.identity())) for b in builds]
    pairs.append((te.Transform2D.from_matrix(m, device="cpu")
                  .then_rotate(0.7),
                  jax_te.Transform2D.from_matrix(jnp.asarray(m))
                  .then_rotate(0.7)))
    return pairs


def _chains_3d():
    builds = [
        lambda t: t,
        lambda t: t.then_scale(1.0, 2.0, 3.0).then_translate(0.5, 0.5, -1.0),
        lambda t: t.then_rotate(0.3, "x").then_rotate(-0.8, 1)
        .then_rotate(1.9, "z").then_translate(1.0, 2.0, 3.0),
        lambda t: t.then_translate(1, 2, 3).then_rotate(0.5, 2)
        .then_scale(2, 2, 0.5),
    ]
    return [(b(te.Transform3D.identity(device="cpu")),
             b(jax_te.Transform3D.identity())) for b in builds]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dim", [2, 3])
def test_matrix_equals_reference_bitwise(dim):
    for port, ref in (_chains_2d() if dim == 2 else _chains_3d()):
        got = port.matrix
        assert got.device.type == "cpu" and got.dtype == torch.float32
        assert got.shape == (dim + 1, dim + 1)
        assert _same_bits(got.numpy(), ref.matrix), port.chain.kinds


def test_folded_and_as_homogeneous_equal_reference_bitwise():
    rng = np.random.default_rng(31)
    for dim in (2, 3):
        for _ in range(6):
            kinds = rng.choice(list("TSRA"), size=4)
            c, j = TransformChain.identity(dim), jax_tc.TransformChain \
                .identity(dim)
            for k in kinds:
                v = rng.uniform(-2, 2, dim).astype(np.float32)
                if k == "T":
                    c, j = c.translate(*v), j.translate(*v)
                elif k == "S":
                    c, j = c.scale(*v), j.scale(*v)
                elif k == "A":
                    c, j = c.affine(v, v[::-1]), j.affine(v, v[::-1])
                else:
                    ax = None if dim == 2 else int(rng.integers(3))
                    c, j = c.rotate(float(v[0]), axis=ax), \
                        j.rotate(float(v[0]), axis=ax)
            for got, want in zip(c.folded(device="cpu"), j.folded()):
                assert _same_bits(got.numpy(), want)
            assert _same_bits(c.as_homogeneous(device="cpu").numpy(),
                              j.as_homogeneous())


def test_projective_chain_has_no_affine_form_but_a_homogeneous_one():
    h = np.eye(3, dtype=np.float32)
    h[0, 2] = 0.5
    c = TransformChain.identity(2).translate(1.0, 2.0).projective(h).cull()
    j = jax_tc.TransformChain.identity(2).translate(1.0, 2.0).projective(h) \
        .cull()
    with pytest.raises(ValueError, match="no \\(A, t\\) form"):
        c.folded(device="cpu")
    assert _same_bits(c.as_homogeneous(device="cpu").numpy(),
                      j.as_homogeneous())


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_is_the_chains_apply_bitwise(dim):
    rng = np.random.default_rng([32, dim])
    pts = rng.standard_normal((257, dim)).astype(np.float32)
    for port, _ in (_chains_2d() if dim == 2 else _chains_3d()):
        got = port.apply(pts)                        # numpy -> the CPU
        want = port.chain.apply(torch.from_numpy(pts))
        assert got.device.type == "cpu"
        assert _same_bits(got.numpy(), want.numpy())
        batched = port.apply(torch.from_numpy(pts.reshape(1, -1, dim)))
        assert _same_bits(batched.numpy().reshape(-1, dim), want.numpy())


def test_builders_are_frozen_and_keep_the_device():
    t = te.Transform2D.identity(device="cpu").then_translate(1, 2)
    assert t.device == "cpu" and len(t.chain) == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.device = "cuda"
    t3 = te.Transform3D.identity(device="cpu").then_rotate(0.2, "y")
    assert t3.chain.kinds == (("R", 1),) and t3.device == "cpu"


def test_engine_primitives_match_reference():
    """numpy in with ``device="cpu"``: the port's engine against the JAX
    engine (``ref`` backend) within the primitives' bounds."""
    rng = np.random.default_rng(33)
    p = (rng.standard_normal((300, 2)) * 3).astype(np.float32)
    u = rng.standard_normal((300, 2)).astype(np.float32)
    s = np.array(SV, np.float32)
    t = np.array(T1, np.float32)
    p64, s64, t64 = (a.astype(np.float64) for a in (p, s, t))
    cases = [
        (te.translate(p, t, device="cpu"), jax_te.translate(p, t),
         4 * EPS32 * (np.abs(p64) + np.abs(t64))),
        (te.scale(p, s, device="cpu"), jax_te.scale(p, s),
         4 * EPS32 * np.abs(p64 * s64)),
        (te.affine(p, s, t, device="cpu"), jax_te.affine(p, s, t),
         4 * EPS32 * (np.abs(p64 * s64) + np.abs(t64))),
        (te.rotate(p, THETA, device="cpu"), jax_te.rotate(p, THETA),
         4 * EPS32 * np.abs(p64).sum(-1, keepdims=True)),
        (te.vecadd(p, u, device="cpu"), jax_te.vecadd(p, u), 0.0),
    ]
    for got, want, bound in cases:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        err = np.abs(got.numpy().astype(np.float64)
                     - np.asarray(want, np.float64))
        assert np.all(err <= bound)


def _sequential(p, backend=None):
    """kernel_bench.py's sequential pipeline: translate(t2), scale(s),
    rotate(theta), translate(t1), one eager primitive each."""
    q = te.translate(p, np.array(T2, np.float32), backend=backend)
    q = te.scale(q, np.array(SV, np.float32), backend=backend)
    q = te.rotate(q, THETA, backend=backend)
    return te.translate(q, np.array(T1, np.float32), backend=backend)


def _fused():
    return (te.Transform2D.identity(device="cpu").then_translate(*T2)
            .then_scale(*SV).then_rotate(THETA).then_translate(*T1))


def pipeline_bound(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the float64 exact transform of ``pts``, 4 eps32 mag_c)."""
    p = pts.astype(np.float64)
    t1, t2, s = (np.array(v, np.float64) for v in (T1, T2, SV))
    c, sn = np.cos(THETA), np.sin(THETA)
    r = np.array([[c, sn], [-sn, c]])
    exact = ((p + t2) * s) @ r + t1
    mag = ((np.abs(p) + np.abs(t2)) * np.abs(s)) @ np.abs(r) + np.abs(t1)
    return exact, 4 * EPS32 * mag


def test_sequential_pipeline_agrees_with_fused_chain():
    """Both paths within 4 eps32 mag_c of the exact transform, and so
    within 8 eps32 mag_c of each other; sequential records four opcount
    entries (4 x 2 point-buffer passes), fused one (2 passes)."""
    rng = np.random.default_rng(34)
    pts = (rng.standard_normal((4096, 2)) * 4).astype(np.float32)
    x = torch.from_numpy(pts)
    _build.reset_launch_counts()
    with opcount.counting() as rec_seq:
        seq = _sequential(x)
    with opcount.counting() as rec_fused:
        fused = _fused().apply(x)
    # CPU tensors run the plain versions: no kernel is launched here
    assert sum(_build.launch_counts().values()) == 0
    exact, bound = pipeline_bound(pts)
    for out in (seq, fused):
        assert np.all(np.abs(out.numpy().astype(np.float64) - exact) <= bound)
    assert np.all(np.abs(seq.numpy().astype(np.float64)
                         - fused.numpy().astype(np.float64)) <= 2 * bound)
    assert [op for op, _ in rec_seq] == ["affine", "affine", "matmul",
                                         "affine"]
    assert [op for op, _ in rec_fused] == ["chain_fused_matrix"]
    n_bytes = x.nbytes
    assert opcount.total_bytes(rec_seq) == 3 * (2 * n_bytes + 2 * 2 * 4) \
        + (2 * n_bytes + 2 * 2 * 4)
    assert opcount.total_bytes(rec_fused) == opcount.fused_chain_bytes(
        len(pts), 2, kind="matrix")


def test_sequential_pipeline_records_the_references_bytes():
    rng = np.random.default_rng(35)
    pts = rng.standard_normal((1000, 2)).astype(np.float32)
    from repro.kernels import opcount as jax_opcount
    with jax_opcount.counting() as jrec:
        q = jax_te.translate(jnp.asarray(pts), jnp.asarray(T2, jnp.float32))
        q = jax_te.scale(q, jnp.asarray(SV, jnp.float32))
        q = jax_te.rotate(q, THETA)
        jax_te.translate(q, jnp.asarray(T1, jnp.float32))
    with opcount.counting() as prec:
        _sequential(torch.from_numpy(pts))
    assert prec == jrec


def test_engine_entry_points_default_to_the_gpu():
    """numpy in without ``device=`` goes to the GPU: without one it
    raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    p = np.ones((4, 2), np.float32)
    for call in (lambda: te.translate(p, 1.0), lambda: te.scale(p, 2.0),
                 lambda: te.rotate(p, 0.3), lambda: te.affine(p, 2.0, 1.0),
                 lambda: te.vecadd(p, p),
                 lambda: te.Transform2D.identity().then_scale(2, 2).apply(p),
                 lambda: te.Transform2D.identity().matrix,
                 lambda: te.Transform3D.identity().matrix,
                 lambda: TransformChain.identity(2).folded(),
                 lambda: TransformChain.identity(3).as_homogeneous()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_analysis_equals_reference():
    rows, jrows = [], []
    for row in jax_intel.PAPER_TABLE5:
        ref_cycles = None if row.system == "m1" else jax_intel.paper_row(
            row.algorithm, "m1", row.n_elements).cycles
        rows.append(analysis.derive(row.algorithm, row.system,
                                    row.n_elements, row.cycles,
                                    ref_cycles=ref_cycles, source="paper"))
        jrows.append(jax_analysis.derive(row.algorithm, row.system,
                                         row.n_elements, row.cycles,
                                         ref_cycles=ref_cycles,
                                         source="paper"))
    assert [dataclasses.astuple(r) for r in rows] \
        == [dataclasses.astuple(r) for r in jrows]
    assert analysis.format_table(rows) == jax_analysis.format_table(jrows)
    r486 = analysis.derive("translation", "80486", 64, 769, ref_cycles=96)
    assert abs(r486.speedup_vs - 8.01) < 0.01        # the paper's speedup

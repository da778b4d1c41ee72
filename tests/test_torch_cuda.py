"""The port on the card: every CUDA kernel bitwise equal to its plain
PyTorch version on the GPU and on the CPU (the projective kernels' masks
included; the int16 Qm.n kernels at full-range inputs, where the int32
accumulator and the int16 store wrap, and at n_frac 0, 7 and 15; the
eager ``affine_2d``/``vecadd_2d``/``matmul_2d`` in float32 and bfloat16,
but ``matmul_2d``'s tensor-core regime, held within a bound; the model
kernels within ``torch_bounds``),
the launch counters, and the GPU server bitwise equal to the CPU server,
to the plain path and to per-request ``apply``/``project`` (the scene
graph's ``submit_scene`` lanes too); the reduced MoE, enc-dec and VLM
models through the kernels (flash attention also at whisper-medium's and
internvl2-76b's serve shapes), an int8-cache decode step against the
CPU's, ``moe_ffn`` deterministic on the card, the compiled serve step
(CUDA graphs of ``Model.prefill``/``decode``) of every family bit for
bit the eager one, and the compiled train step (one CUDA graph of
forward, backward and the in-place AdamW) bit for bit the eager loop,
with a serve between train steps holding one compiled serve a shape
key; on one-rank NCCL groups, functional collectives captured and
replayed, the compiled mesh serve and train steps bit for bit their
eager mesh runs, and a failed mesh capture raising.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither jax nor the JAX package, so it also runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro_torch import graphics, serving
from repro_torch.kernels import _build, chain_apply, chain_apply_batch, \
    chain_apply_batch_q, chain_apply_q, chain_diag, chain_diag_batch, \
    chain_diag_batch_q, chain_diag_q, chain_project, chain_project_batch
from repro_torch.kernels.affine import affine as diag_k
from repro_torch.kernels.affine import ref as diag_ref
from repro_torch.kernels.fixedpoint import fixedpoint as q_k
from repro_torch.kernels.fixedpoint import ref as q_ref
from repro_torch.kernels.matmul import matmul as matrix_k
from repro_torch.kernels.matmul import ref as matrix_ref
from repro_torch.kernels.projective import projective as proj_k
from repro_torch.kernels.projective import ref as proj_ref
from repro_torch.quantize import Q8_7
from repro_torch.serving import workload

pytestmark = pytest.mark.cuda

OPS = {("diag", False): (chain_diag, diag_ref.chain_diag),
       ("diag", True): (chain_diag_batch, diag_ref.chain_diag_batch),
       ("matrix", False): (chain_apply, matrix_ref.chain_matrix),
       ("matrix", True): (chain_apply_batch, matrix_ref.chain_matrix_batch)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _inputs(rng, lead, d, kind):
    pts = rng.standard_normal((*lead, d)).astype(np.float32)
    plead = lead[:1] if len(lead) == 2 else ()
    t = rng.uniform(-3, 3, (*plead, d)).astype(np.float32)
    shape = (*plead, d) if kind == "diag" else (*plead, d, d)
    return pts, rng.uniform(-1.5, 1.5, shape).astype(np.float32), t


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_kernel_equals_plain_on_card_and_cpu(cuda_device, kind, d, batched):
    rng = np.random.default_rng([14, d, batched])
    op, plain = OPS[kind, batched]
    shapes = ((1, 8), (5, 13), (12, 24), (3, 40_000), (1500, 16)) if batched \
        else ((1,), (37,), (300,), (100_003,))
    for lead in shapes:
        pts, p, t = _inputs(rng, lead, d, kind)
        host = [torch.from_numpy(a) for a in (pts, p, t)]
        dev = [a.to(cuda_device) for a in host]
        got = op(*dev)
        assert torch.equal(got, plain(*dev)), lead
        assert _same_bits(got.cpu().numpy(), op(*host).numpy()), lead


def test_wrappers_count_launches_and_check_operands(cuda_device):
    _build.reset_launch_counts()
    x = torch.ones(4, 3, device=cuda_device)
    s, t = torch.ones(3, device=cuda_device), torch.zeros(3, device=cuda_device)
    diag_k.chain_diag_1d(x.reshape(-1), s, t, d=3)
    diag_k.chain_diag_1d(x.reshape(-1)[:0], s, t, d=3)     # empty: no launch
    matrix_k.chain_matrix_1d(x.reshape(-1), torch.eye(3, device=cuda_device),
                             t, d=3)
    proj_k.chain_project_1d(x.reshape(-1), torch.eye(4, device=cuda_device),
                            t - 1, t + 1, d=3)
    counts = _build.launch_counts()
    assert counts["chain_diag_1d"] == 1 and counts["chain_matrix_1d"] == 1
    assert counts["chain_project_1d"] == 1
    assert counts["chain_diag_batch_2d"] == counts["chain_matrix_batch_2d"] \
        == counts["chain_project_batch_2d"] == 0
    with pytest.raises(TypeError):
        diag_k.chain_diag_1d(x.reshape(-1).double(), s.double(), t.double(),
                             d=3)
    with pytest.raises(ValueError):
        diag_k.chain_diag_1d(x.reshape(-1), s, t, d=2)     # s, t are (3,)
    with pytest.raises(ValueError):
        diag_k.chain_diag_1d(x.reshape(-1)[::2], s, t, d=3)  # not contiguous
    assert _build.launch_counts()["chain_diag_1d"] == 1


def test_apply_on_cuda_equals_cpu_bitwise(cuda_device):
    rng = np.random.default_rng(44)
    for dim, kinds in workload.AFFINE_TEMPLATES:
        chain = workload.chain_for(rng, dim, kinds)
        pts = rng.standard_normal((1000, dim)).astype(np.float32)
        cpu = chain.apply(torch.from_numpy(pts))
        dev = chain.apply(pts)                   # numpy -> the default GPU
        assert dev.is_cuda
        assert _same_bits(dev.cpu().numpy(), cpu.numpy())


def test_cuda_server_equals_cpu_server_bitwise(cuda_device):
    reqs = workload.random_workload(seed=5, n_requests=64,
                                    templates=workload.AFFINE_TEMPLATES,
                                    max_points=4096)
    serving.reset_stats()
    cpu = serving.GeometryServer(device="cpu").serve(reqs)
    serving.reset_stats()
    _build.reset_launch_counts()
    gpu_srv = serving.GeometryServer(device=cuda_device)
    gpu = gpu_srv.serve(reqs)
    counts = _build.launch_counts()
    assert counts["chain_diag_batch_2d"] + counts["chain_matrix_batch_2d"] \
        == serving.stats["launches"] == serving.stats["buckets"]
    ref = serving.GeometryServer(device=cuda_device, backend="ref").serve(reqs)
    for c, g, r in zip(cpu, gpu, ref, strict=True):
        assert _same_bits(c, g) and _same_bits(g, r)
    assert gpu_srv.last_timing["device_ms"] > 0


def test_cuda_server_resolves_non_finite_outputs_like_cpu(cuda_device):
    """``validate_outputs`` on the card: the request whose float32 output
    overflows to inf resolves to a ``LaunchError`` with its ticket, its
    neighbours in the same launch equal the CPU server's, bit for bit.
    A corruption on the kernel rung never degrades to the plain version:
    the card's server retries and bisects on the kernel alone, with the
    CPU server's counters, and its message names only the ``cuda`` rung
    where the CPU server's names ``ref``."""
    from repro_torch import errors
    from repro_torch.core import transform_chain as tc
    chain = tc.TransformChain.identity(3).scale([1e30, 1.0, 1.0])
    rng = np.random.default_rng(55)
    subs = [rng.standard_normal((64, 3)).astype(np.float32),
            np.full((64, 3), 1e10, np.float32),
            rng.standard_normal((50, 3)).astype(np.float32)]
    outs, counters = {}, {}
    for dev in ("cpu", cuda_device):
        serving.reset_stats()
        srv = serving.GeometryServer(device=dev, fault_config=serving
                                     .FaultConfig(backoff_base_s=0.0))
        outs[str(dev)] = srv.serve([(chain, p) for p in subs])
        assert serving.stats["failed_requests"] == 1
        assert sum(r.failed_requests for r in srv.last_report) == 1
        counters[str(dev)] = {k: serving.stats[k] for k in (
            "launches", "launch_failures", "retries", "backend_fallbacks",
            "bisections", "recovered_requests", "failed_requests")}
    assert counters["cpu"] == counters[str(cuda_device)]
    assert counters["cpu"]["backend_fallbacks"] == 0
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    for i, (c, g) in enumerate(zip(cpu, gpu, strict=True)):
        if i == 1:
            assert isinstance(g, errors.LaunchError) and g.ticket == 1
            assert isinstance(c, errors.LaunchError)
            assert str(c).split(": ", 1)[1] == str(g).split(": ", 1)[1]
            assert "('cuda',)" in str(g) and "('ref',)" in str(c)
        else:
            assert _same_bits(c, g)


def _projective_cases(rng, d):
    """(points, H, lo, hi) cases for one d: a random homography with a
    perspective column strong enough that some points have w <= 0, with
    finite and with +-inf bounds; a cull-only H = I with points exactly
    on and just beyond the planes; w = x_0 exactly 0 and negative."""
    h = np.eye(d + 1, dtype=np.float32)
    h[:d, :d] += rng.uniform(-0.4, 0.4, (d, d)).astype(np.float32)
    h[d, :d] = rng.uniform(-1, 1, d)
    h[:d, d] = rng.uniform(-0.5, 0.5, d)
    pts = (rng.standard_normal((50_000, d)) * 3).astype(np.float32)
    lo = np.full(d, -2.5, np.float32)
    hi = np.full(d, 2.5, np.float32)
    inf = np.full(d, np.inf, np.float32)
    eps = np.float32(np.finfo(np.float32).eps)
    edge = np.array([[1.0] * d, [-1.0] * d, [1.0 + 2 * eps] + [0.0] * (d - 1),
                     [0.0] * (d - 1) + [-1.0 - 2 * eps], [0.5] * d],
                    np.float32)
    w_edge = np.eye(d + 1, dtype=np.float32)
    w_edge[0, d], w_edge[d, d] = 1.0, 0.0     # w = x_0
    behind = np.array([[0.0] + [1.0] * (d - 1), [-2.0] + [1.0] * (d - 1),
                       [3.0] + [1.0] * (d - 1)], np.float32)
    ones = np.ones(d, np.float32)
    return [(pts, h, lo, hi), (pts, h, -inf, inf),
            (edge, np.eye(d + 1, dtype=np.float32), -ones, ones),
            (behind, w_edge, -10 * ones, 10 * ones),
            (pts[:0], h, lo, hi)]


@pytest.mark.parametrize("d", [2, 3])
def test_projective_kernels_equal_plain_bitwise(cuda_device, d):
    """Both projective kernels against the plain version on the card and
    on the CPU, points AND mask, bit for bit: w <= 0, points on the
    planes, +-inf bounds and an empty input included."""
    rng = np.random.default_rng([15, d])
    for k, (pts, h, lo, hi) in enumerate(_projective_cases(rng, d)):
        host = [torch.from_numpy(a) for a in (pts, h, lo, hi)]
        dev = [a.to(cuda_device) for a in host]
        out, mask = chain_project(*dev)
        pout, pmask = proj_ref.chain_project(*dev)
        cout, cmask = chain_project(*host)
        assert mask.dtype == torch.bool and mask.shape == pts.shape[:-1]
        for got, want in ((out, pout), (mask, pmask), (out.cpu(), cout),
                          (mask.cpu(), cmask)):
            assert _same_bits(got.cpu().numpy(), want.cpu().numpy()), k
        if k == 2:
            assert mask.tolist() == [True, True, False, False, True]
        if k == 3:
            assert mask.tolist() == [False, False, True]
            assert torch.isfinite(out).all()
        # the batch kernel: rows of the same case under per-row params
        if len(pts):
            pts3 = torch.from_numpy(pts[: 3 * (len(pts) // 3)]).reshape(
                3, -1, d).to(cuda_device)
            params = [a.expand(3, *a.shape).contiguous() for a in dev[1:]]
            bout, bmask = chain_project_batch(pts3, *params)
            pbout, pbmask = proj_ref.chain_project_batch(pts3, *params)
            assert _same_bits(bout.cpu().numpy(), pbout.cpu().numpy()), k
            assert _same_bits(bmask.cpu().numpy(), pbmask.cpu().numpy()), k
            row, rmask = chain_project(pts3[1], *dev[1:])
            assert _same_bits(bout[1].cpu().numpy(), row.cpu().numpy())
            assert _same_bits(bmask[1].cpu().numpy(), rmask.cpu().numpy())
    empty3 = torch.zeros(2, 0, d, device=cuda_device)
    params = [torch.from_numpy(a).to(cuda_device).expand(2, *a.shape)
              .contiguous() for a in _projective_cases(rng, d)[0][1:]]
    out, mask = proj_k.chain_project_batch_2d(empty3, *params)
    assert out.shape == (2, 0, d) and mask.shape == (2, 0)


def _same_values(a: np.ndarray, b: np.ndarray) -> bool:
    """NaN at the same places (its payload aside: the card's arithmetic
    gives one NaN, the CPU's keeps its input's), every other element bit
    for bit."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != np.float32:
        return a.tobytes() == b.tobytes()
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) \
        and a[~nan].tobytes() == b[~nan].tobytes()


@pytest.mark.parametrize("d", [2, 3])
def test_project_flat_vector_and_scalar_paths_equal_plain(cuda_device, d):
    """Both kernels of ``chain_project_1d`` bit for bit equal to the plain
    version on the card (and, NaN payloads aside, on the CPU), points AND
    mask: the 16-byte one from 2**19 points, with its tail of N mod 4 =
    0, 1, 2, 3 points, the scalar one below 2**19 points (N < 4 included)
    and at points one float off 16-byte alignment; w < 0 and w = 0
    exactly (H with w = x_0), NaN and infinite points, and bounds of +-inf
    and NaN."""
    rng = np.random.default_rng([70, d])
    h = np.eye(d + 1, dtype=np.float32)
    h[:d, :d] += rng.uniform(-0.4, 0.4, (d, d)).astype(np.float32)
    h[d, :d] = rng.uniform(-1, 1, d)
    h[:d, d] = rng.uniform(-0.5, 0.5, d)
    w_edge = np.eye(d + 1, dtype=np.float32)
    w_edge[0, d], w_edge[d, d] = 1.0, 0.0     # w = x_0
    inf = np.float32(np.inf)
    limits = [(np.full(d, -2.5, np.float32), np.full(d, 2.5, np.float32)),
              (np.full(d, -inf), np.full(d, inf)),
              (np.array([-inf] + [-1.0] * (d - 1), np.float32),
               np.array([np.nan] + [inf] * (d - 1), np.float32))]
    for n in (1, 2, 3, 4, 5, 8, 1001, 70_001, (1 << 19) - 1, 1 << 19,
              (1 << 19) + 1, (1 << 20) + 2, (1 << 20) + 3):
        pts = (rng.standard_normal((n, d)) * 3).astype(np.float32)
        pts[: min(n, 4), 0] = np.array([0.0, -2.0, np.nan, 3.0],
                                       np.float32)[: min(n, 4)]
        if n > 8:
            pts[5:8, d - 1] = [-np.inf, np.inf, np.nan]
        for hm in (h, w_edge):
            for lo, hi in limits:
                host = [torch.from_numpy(a) for a in (pts, hm, lo, hi)]
                want, wmask = proj_ref.chain_project(*host)
                x, hh, ll, uu = (a.to(cuda_device) for a in host)
                for xs in (x, _misaligned(x)):
                    out, mask = proj_k.chain_project_1d(xs.reshape(-1), hh,
                                                        ll, uu, d=d)
                    pout, pmask = proj_ref.chain_project(xs, hh, ll, uu)
                    got = out.reshape(n, d).cpu().numpy()
                    gmask = mask.cpu().numpy()
                    assert _same_bits(got, pout.cpu().numpy()), (n, d)
                    assert _same_bits(gmask, pmask.cpu().numpy()), (n, d)
                    assert _same_values(got, want.numpy()), (n, d)
                    assert _same_bits(gmask, wmask.numpy()), (n, d)


def _project_batch_inputs(rng, lead, d):
    """Points (3 sigma, some w <= 0 and some outside the cull) and per-
    request H, lo, hi for a (B, L, d) bucket; request 0 takes H with w =
    x_0 and points with x_0 = 0, -2, NaN, so w = 0 exactly, w < 0 and a
    NaN w occur."""
    bsz, length = lead
    pts = (3 * rng.standard_normal((bsz, length, d))).astype(np.float32)
    h = np.tile(np.eye(d + 1, dtype=np.float32), (bsz, 1, 1))
    h[:, :d, :d] += rng.uniform(-0.4, 0.4, (bsz, d, d)).astype(np.float32)
    h[:, d, :d] = rng.uniform(-1, 1, (bsz, d))
    h[:, :d, d] = rng.uniform(-0.5, 0.5, (bsz, d))
    h[0] = np.eye(d + 1, dtype=np.float32)
    h[0, 0, d], h[0, d, d] = 1.0, 0.0             # w = x_0
    pts[0, : min(length, 3), 0] = np.array([0.0, -2.0, np.nan],
                                           np.float32)[: min(length, 3)]
    lo = rng.uniform(-3, -2, (bsz, d)).astype(np.float32)
    hi = rng.uniform(2, 3, (bsz, d)).astype(np.float32)
    return pts, h, lo, hi


#: (B, L): csrc/chain_project.cu's 16-byte batch kernel (L a multiple of
#: 4: one group a row and many, the mixed serve's largest d = 2 bucket
#: and its median, the graphics frames, B > 1024) and its scalar kernel
#: (L = 6, 39, 1, 3001; B > 1024 at L = 13)
PROJECT_BATCH_VEC = ((1, 4), (3, 8), (2, 12), (20, 65536), (8, 32768),
                     (64, 65536), (1100, 8), (1500, 16))
PROJECT_BATCH_SCALAR = ((3, 6), (2, 39), (7, 1), (3, 3001), (1100, 13))


@pytest.mark.parametrize("d", [2, 3])
def test_project_batch_vector_and_scalar_paths_equal_plain(cuda_device, d):
    """Both kernels of ``chain_project_batch_2d`` bit for bit equal to the
    plain version on the card and, NaN payloads aside, on the CPU, points
    AND mask: the 16-byte one at rows of whole groups of four points
    (served buckets, B > 1024), the scalar one at rows of no whole group
    and at points one float off 16-byte alignment; w = 0, w < 0 and NaN
    w, points outside the cull."""
    rng = np.random.default_rng([71, d])
    for lead in PROJECT_BATCH_VEC + PROJECT_BATCH_SCALAR:
        host = [torch.from_numpy(a)
                for a in _project_batch_inputs(rng, lead, d)]
        want, wmask = proj_ref.chain_project_batch(*host)
        x, hh, ll, uu = (a.to(cuda_device) for a in host)
        for xs in (x, _misaligned(x)):
            out, mask = proj_k.chain_project_batch_2d(xs, hh, ll, uu)
            pout, pmask = proj_ref.chain_project_batch(xs, hh, ll, uu)
            got, gmask = out.cpu().numpy(), mask.cpu().numpy()
            assert _same_bits(got, pout.cpu().numpy()), (lead, d)
            assert _same_bits(gmask, pmask.cpu().numpy()), (lead, d)
            assert _same_values(got, want.numpy()), (lead, d)
            assert _same_bits(gmask, wmask.numpy()), (lead, d)
        if wmask.numel() > 1000:        # both mask values occur
            assert bool(wmask.any()) and not bool(wmask.all()), lead


def test_projective_bucket_on_card_equals_per_request_project(cuda_device):
    """The full TEMPLATES pool served on the card: every projective
    bucket one chain_project_batch_2d launch, every result bitwise equal
    to the CPU server, to the plain path on the card and to per-request
    ``project`` (masks included)."""
    reqs = workload.random_workload(seed=5, n_requests=66,
                                    templates=workload.TEMPLATES,
                                    max_points=4096)
    serving.reset_stats()
    cpu = serving.GeometryServer(device="cpu").serve(reqs)
    serving.reset_stats()
    _build.reset_launch_counts()
    gpu_srv = serving.GeometryServer(device=cuda_device)
    gpu = gpu_srv.serve(reqs)
    counts = _build.launch_counts()
    n_proj = sum(r.kind == "projective" for r in gpu_srv.last_report)
    assert n_proj > 0 and counts["chain_project_batch_2d"] == n_proj
    assert counts["chain_diag_batch_2d"] + counts["chain_matrix_batch_2d"] \
        + counts["chain_project_batch_2d"] == serving.stats["launches"] \
        == serving.stats["buckets"]
    ref = serving.GeometryServer(device=cuda_device, backend="ref").serve(reqs)
    for (chain, pts), c, g, r in zip(reqs, cpu, gpu, ref, strict=True):
        assert _same_bits(c, g) and _same_bits(g, r)
        if chain.is_projective:
            assert isinstance(g, serving.Projected)
            out, mask = chain.project(pts)          # numpy -> the GPU
            assert out.is_cuda and mask.is_cuda
            assert _same_bits(g, out.cpu().numpy())
            for other in (c, r):
                assert _same_bits(g.mask, other.mask)
            assert _same_bits(g.mask, mask.cpu().numpy())
        else:
            assert _same_bits(g, chain.apply(pts).cpu().numpy())


def test_viewing_chain_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(16)
    chain = graphics.viewing_chain(
        camera=graphics.Camera(eye=(3, 2, 6), fov_y=np.pi / 3,
                               aspect=16 / 9, near=0.5, far=50),
        viewport=graphics.Viewport(0, 0, 1920, 1080))
    pts = (rng.standard_normal((100_000, 3)) * 4).astype(np.float32)
    _build.reset_launch_counts()
    out, mask = chain.project(pts)
    assert _build.launch_counts()["chain_project_1d"] == 1
    cout, cmask = chain.project(pts, device="cpu")
    assert _same_bits(out.cpu().numpy(), cout.numpy())
    assert _same_bits(mask.cpu().numpy(), cmask.numpy())
    assert 0 < int(mask.sum()) < len(pts)


def test_cuda_backend_on_cpu_tensor_raises_for_projective(cuda_device):
    x = torch.ones(5, 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_project(x, torch.eye(4), backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chain_project_batch(x[None], torch.eye(4), backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        proj_k.chain_project_1d(x.reshape(-1), torch.eye(4), torch.zeros(3),
                                torch.ones(3), d=3)
    dev = x.to(cuda_device)
    with pytest.raises(ValueError, match="CUDA device"):     # mixed devices
        proj_k.chain_project_1d(dev.reshape(-1), torch.eye(4),
                                torch.zeros(3), torch.ones(3), d=3)


def test_eager_division_on_card_is_ieee_round_to_nearest(cuda_device):
    """The plain projective version divides with eager ``/``: on the card
    it must round as IEEE division does (numpy float32 on the host), or
    it could not equal the kernel's ``__fdiv_rn``."""
    rng = np.random.default_rng(17)
    a = rng.standard_normal(1 << 20).astype(np.float32) \
        * np.float32(10.0) ** rng.integers(-30, 30, 1 << 20).astype(np.float32)
    b = rng.standard_normal(1 << 20).astype(np.float32) \
        * np.float32(10.0) ** rng.integers(-30, 30, 1 << 20).astype(np.float32)
    tiny = np.array([1e-45, -3e-39, 1.1754942e-38, 3.4e38, 0.0, -0.0],
                    np.float32)
    a, b = np.concatenate([a, tiny, tiny]), np.concatenate([b, np.flip(tiny),
                                                           tiny[::-1] + 1])
    with np.errstate(all="ignore"):
        want = a / b
    got = (torch.from_numpy(a).to(cuda_device)
           / torch.from_numpy(b).to(cuda_device)).cpu().numpy()
    finite = np.isfinite(want)
    assert _same_bits(got[finite], want[finite])


# -- the int16 Qm.n lane ----------------------------------------------------

Q_OPS = {("diag", False): (chain_diag_q, q_ref.chain_diag_q),
         ("diag", True): (chain_diag_batch_q, q_ref.chain_diag_batch_q),
         ("matrix", False): (chain_apply_q, q_ref.chain_matrix_q),
         ("matrix", True): (chain_apply_batch_q, q_ref.chain_matrix_batch_q)}


def _words(rng, shape):
    return rng.integers(-(1 << 15), 1 << 15, shape).astype(np.int16)


@pytest.mark.parametrize("n_frac", [0, 7, 15])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_q_kernel_equals_plain_on_card_and_cpu(cuda_device, kind, d, batched,
                                               n_frac):
    """Full-range int16 words (products up to 2**30, sums that wrap
    int32): the kernel, the plain version on the card, the plain version
    on the CPU and the numpy oracle give the same words."""
    rng = np.random.default_rng([18, d, batched, n_frac])
    op, plain = Q_OPS[kind, batched]
    shapes = ((1, 8), (5, 13), (3, 40_000), (1500, 16)) if batched \
        else ((1,), (37,), (100_003,))
    for lead in shapes:
        plead = lead[:1] if batched else ()
        pts = _words(rng, (*lead, d))
        par = _words(rng, (*plead, d) if kind == "diag" else (*plead, d, d))
        t = _words(rng, (*plead, d))
        host = [torch.from_numpy(a) for a in (pts, par, t)]
        dev = [a.to(cuda_device) for a in host]
        got = op(*dev, n_frac=n_frac)
        assert got.dtype == torch.int16
        assert torch.equal(got, plain(*dev, n_frac)), lead
        assert _same_bits(got.cpu().numpy(),
                          op(*host, n_frac=n_frac).numpy()), lead
        oracle = q_ref.np_chain_diag_q if kind == "diag" \
            else q_ref.np_chain_matrix_q
        for i in range(lead[0] if batched else 1):
            rows = (pts[i], par[i], t[i]) if batched else (pts, par, t)
            want = oracle(*rows, n_frac)
            assert _same_bits(got[i].cpu().numpy() if batched
                              else got.cpu().numpy(), want), lead


#: the batch Qm.n kernels: (wrapper, plain version, numpy oracle)
Q_BATCH = {"diag": (q_k.chain_diag_batch_2d_q, q_ref.chain_diag_batch_q,
                    q_ref.np_chain_diag_q),
           "matrix": (q_k.chain_matrix_batch_2d_q,
                      q_ref.chain_matrix_batch_q, q_ref.np_chain_matrix_q)}


def _q_batch_case(rng, lead, d, kind="matrix"):
    pts = _words(rng, (*lead, d))
    par = _words(rng, (lead[0], d) if kind == "diag" else (lead[0], d, d))
    t = _words(rng, (lead[0], d))
    return pts, par, t


def _check_q_batch(cuda_device, pts, par, t, n_frac, misaligned=False,
                   kind="matrix"):
    """The kernel, the plain version on the card and on the CPU, and the
    numpy oracle per request, on the same words."""
    op, plain, oracle = Q_BATCH[kind]
    host = [torch.from_numpy(v) for v in (pts, par, t)]
    dev = [v.to(cuda_device) for v in host]
    if misaligned:
        dev[0] = _misaligned(dev[0])
    got = op(*dev, n_frac=n_frac)
    assert got.dtype == torch.int16
    assert torch.equal(got, plain(*dev, n_frac))
    got = got.cpu()
    assert torch.equal(got, plain(*host, n_frac))
    for i in range(pts.shape[0]):
        want = oracle(pts[i], par[i], t[i], n_frac)
        assert _same_bits(got[i].numpy(), want), i


@pytest.mark.parametrize("n_frac", [0, 7, 15])
@pytest.mark.parametrize("d", [2, 3])
def test_q_matrix_batch_vector_kernel_equals_plain(cuda_device, d, n_frac):
    """``chain_matrix_batch_2d_q``'s 16-byte kernel (rows of a multiple of 8
    words on aligned buffers): one vector or group a row and many, the
    largest q bucket's shape, B > 1024, full-range words, bitwise equal
    to the plain version and the numpy oracle."""
    rng = np.random.default_rng([72, d, n_frac])
    for lead in ((1, 8), (3, 4 if d == 2 else 8), (2, 24), (4, 4096),
                 (15, 65536), (2, 40_000), (1500, 16)):
        _check_q_batch(cuda_device, *_q_batch_case(rng, lead, d), n_frac)


@pytest.mark.parametrize("n_frac", [0, 7, 15])
@pytest.mark.parametrize("d", [2, 3])
def test_q_matrix_batch_scalar_kernel_equals_plain(cuda_device, d, n_frac):
    """``chain_matrix_batch_2d_q``'s scalar kernel: rows of no multiple of
    8 words ((3, 1001, d), (5, 13, d), B > 1024) and points one element
    off 16-byte alignment at the largest q bucket's shape, full-range
    words, bitwise equal to the plain version and the numpy oracle."""
    rng = np.random.default_rng([73, d, n_frac])
    for lead, off in (((3, 1001), False), ((5, 13), False),
                      ((1100, 13), False), ((15, 65536), True),
                      ((1500, 16), True)):
        _check_q_batch(cuda_device, *_q_batch_case(rng, lead, d), n_frac,
                       misaligned=off)


@pytest.mark.parametrize("n_frac", [0, 7, 15])
@pytest.mark.parametrize("d", [2, 3])
def test_q_diag_batch_vector_kernel_equals_plain(cuda_device, d, n_frac):
    """``chain_diag_batch_2d_q``'s 16-byte kernel (rows of a multiple of 8
    words on aligned buffers): at d = 3 rows of 3, 6 and 9 vectors, so
    every column phase starts and ends a row; the largest q diag bucket's
    shape, B > 1024, full-range words, bitwise equal to the plain version
    and the numpy oracle."""
    rng = np.random.default_rng([74, d, n_frac])
    leads = ((1, 4), (3, 12), (4, 4096), (36, 32768), (2, 40_000),
             (1500, 16)) if d == 2 else \
        ((1, 8), (3, 16), (5, 24), (4, 4096), (2, 40_000), (1100, 8))
    for lead in leads:
        _check_q_batch(cuda_device, *_q_batch_case(rng, lead, d, "diag"),
                       n_frac, kind="diag")


@pytest.mark.parametrize("n_frac", [0, 7, 15])
@pytest.mark.parametrize("d", [2, 3])
def test_q_diag_batch_scalar_kernel_equals_plain(cuda_device, d, n_frac):
    """``chain_diag_batch_2d_q``'s scalar kernel: rows of no multiple of 8
    words ((3, 1001, d), (5, 13, d), B > 1024) and points one element off
    16-byte alignment at the largest q diag bucket's shape and at B >
    1024, full-range words, bitwise equal to the plain version and the
    numpy oracle."""
    rng = np.random.default_rng([75, d, n_frac])
    for lead, off in (((3, 1001), False), ((5, 13), False),
                      ((1100, 13), False), ((36, 32768), True),
                      ((1500, 16), True)):
        _check_q_batch(cuda_device, *_q_batch_case(rng, lead, d, "diag"),
                       n_frac, misaligned=off, kind="diag")


def test_q_wrappers_count_launches_and_check_operands(cuda_device):
    _build.reset_launch_counts()
    x = torch.ones(4, 3, dtype=torch.int16, device=cuda_device)
    s = torch.ones(3, dtype=torch.int16, device=cuda_device)
    t = torch.zeros(3, dtype=torch.int16, device=cuda_device)
    a = torch.eye(3, device=cuda_device).to(torch.int16)
    q_k.chain_diag_1d_q(x.reshape(-1), s, t, d=3, n_frac=7)
    q_k.chain_diag_1d_q(x.reshape(-1)[:0], s, t, d=3, n_frac=7)  # no launch
    q_k.chain_matrix_1d_q(x.reshape(-1), a, t, d=3, n_frac=0)
    q_k.chain_diag_batch_2d_q(x[None], s[None], t[None], n_frac=15)
    q_k.chain_matrix_batch_2d_q(x[None, :0], a[None], t[None], n_frac=7)
    counts = _build.launch_counts()
    assert counts["chain_diag_1d_q"] == counts["chain_matrix_1d_q"] \
        == counts["chain_diag_batch_2d_q"] == 1
    assert counts["chain_matrix_batch_2d_q"] == 0
    with pytest.raises(TypeError):                        # float operands
        q_k.chain_diag_1d_q(x.reshape(-1).float(), s.float(), t.float(), d=3,
                            n_frac=7)
    with pytest.raises(TypeError):
        chain_diag_q(x.float(), s, t, n_frac=7)
    with pytest.raises(ValueError):                       # not contiguous
        q_k.chain_diag_1d_q(x.reshape(-1)[::2], s, t, d=3, n_frac=7)
    with pytest.raises(ValueError):
        q_k.chain_matrix_batch_2d_q(x[None].transpose(1, 2).contiguous()
                                    .transpose(1, 2), a[None], t[None],
                                    n_frac=7)
    with pytest.raises(ValueError):
        q_k.chain_diag_1d_q(x.reshape(-1), s, t, d=3, n_frac=16)
    assert _build.launch_counts()["chain_diag_1d_q"] == 1


def test_apply_dtype_on_card_uses_flat_q_kernels(cuda_device):
    """``apply(dtype="q8.7")`` on the card: one flat q kernel launch a
    call, float points in gives float32 out and int16 words give int16,
    bitwise equal to the CPU."""
    rng = np.random.default_rng(19)
    _build.reset_launch_counts()
    n_kind = {"diag": 0, "matrix": 0}
    for dim, kinds in workload.AFFINE_TEMPLATES:
        chain = workload.chain_for(rng, dim, kinds)
        pts = rng.uniform(-4, 4, (1000, dim)).astype(np.float32)
        for sub in (pts, Q8_7.quantize(pts)):
            dev = chain.apply(sub, dtype="q8.7")          # numpy -> the GPU
            cpu = chain.apply(torch.from_numpy(sub), dtype="q8.7")
            assert dev.is_cuda
            assert dev.dtype == (torch.float32 if sub.dtype == np.float32
                                 else torch.int16)
            assert _same_bits(dev.cpu().numpy(), cpu.numpy())
            n_kind[chain.plan_kind] += 1
    counts = _build.launch_counts()
    assert counts["chain_diag_1d_q"] == n_kind["diag"] > 0
    assert counts["chain_matrix_1d_q"] == n_kind["matrix"] > 0
    assert counts["chain_diag_1d"] == counts["chain_matrix_1d"] == 0


def test_q_server_on_card_equals_cpu_server_bitwise(cuda_device):
    """The mixed-lane workload on the card: q buckets run the q batch
    kernels, and every result equals the CPU server's and the plain
    path's on the card, bit for bit."""
    reqs = workload.mixed_lane_workload(7, 96, max_points=4096)
    assert any(q for _, _, q in reqs)

    def serve(srv):
        for chain, pts, q in reqs:
            srv.submit(chain, pts, qformat=q)
        return srv.flush()

    serving.reset_stats()
    cpu = serve(serving.GeometryServer(device="cpu"))
    serving.reset_stats()
    _build.reset_launch_counts()
    gpu = serve(serving.GeometryServer(device=cuda_device))
    counts = _build.launch_counts()
    assert sum(counts[k] for k in ("chain_diag_batch_2d", "chain_matrix_batch_2d",
                                   "chain_project_batch_2d",
                                   "chain_diag_batch_2d_q",
                                   "chain_matrix_batch_2d_q")) \
        == serving.stats["launches"] == serving.stats["buckets"]
    assert counts["chain_diag_batch_2d_q"] + counts["chain_matrix_batch_2d_q"] > 0
    ref = serve(serving.GeometryServer(device=cuda_device, backend="ref"))
    for c, g, r in zip(cpu, gpu, ref, strict=True):
        assert _same_bits(c, g) and _same_bits(g, r)


# -- the eager primitives (affine_2d, vecadd_2d, matmul_2d) ------------------

def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits on the host (bfloat16 as its int16 words)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _dense(rng, shape, dtype, device, low=None, high=None):
    a = rng.uniform(low, high, shape) if low is not None \
        else rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_and_vecadd_kernels_equal_plain(cuda_device, dtype):
    """``affine_2d`` and ``vecadd_2d`` against their plain versions on the
    card and on the CPU, bit for bit: N = 1, 2, 3 (point clouds), ragged
    and lane-wide shapes, and signed zeros (scale is x*s + 0)."""
    rng = np.random.default_rng([51, dtype == torch.bfloat16])
    for shape in ((1, 1), (1, 8), (17, 100), (5000, 2), (3001, 3),
                  (1024, 1024), (70_001, 2), (0, 3)):
        x = _dense(rng, shape, dtype, cuda_device)
        z = _dense(rng, shape, dtype, cuda_device)
        s = _dense(rng, shape[1:], dtype, cuda_device, -2, 2)
        t = _dense(rng, shape[1:], dtype, cuda_device, -3, 3)
        got = diag_k.affine_2d(x, s, t)
        assert got.dtype == dtype and got.shape == x.shape
        for want in (diag_ref.affine(x, s, t),
                     diag_ref.affine(x.cpu(), s.cpu(), t.cpu())):
            assert _same_bits(_bits(got), _bits(want)), shape
        got = diag_k.vecadd_2d(x, z)
        for want in (diag_ref.vecadd(x, z), diag_ref.vecadd(x.cpu(), z.cpu())):
            assert _same_bits(_bits(got), _bits(want)), shape
    x = torch.tensor([[-1.0, 2.0, -0.0, 0.0]], dtype=dtype,
                     device=cuda_device)
    s = torch.tensor([0.0, -0.0, 1.0, -1.0], dtype=dtype, device=cuda_device)
    zero = torch.zeros(4, dtype=dtype, device=cuda_device)
    out = diag_k.affine_2d(x, s, zero)
    assert not torch.signbit(out).any()
    assert _same_bits(_bits(out), _bits(diag_ref.scale(x.cpu(), s.cpu())))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_equals_plain(cuda_device, dtype, out):
    """``matmul_2d`` against the plain version (k ascending, one rounded
    multiply and add a step) on the card and on the CPU, at ragged edges,
    K past one panel, K = 0 and the rotate shape: bit for bit for float32
    inputs and for the skinny regime (K <= 8 and N <= 8) of either dtype;
    within ``bounds.matmul_bound`` for the tensor-core regime (bfloat16
    otherwise), through its per-thread loads (K or N no multiple of 8) and
    its TMA loads (256 x 512 x 384 and 1024**3)."""
    import torch_bounds as bounds
    rng = np.random.default_rng([52, dtype == torch.bfloat16, out == "bfloat16"])
    out_dtype = getattr(torch, out)
    for m, k, n in ((17, 100, 33), (1, 8, 1), (1, 1, 1), (65, 17, 63),
                    (130, 1024, 70), (1 << 16, 2, 2), (3000, 3, 3),
                    (5, 0, 4), (256, 512, 384), (1024, 1024, 1024)):
        x = _dense(rng, (m, k), dtype, cuda_device)
        y = _dense(rng, (k, n), dtype, cuda_device)
        got = matrix_k.matmul_2d(x, y, out_dtype=out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        for want in (matrix_ref.matmul(x, y, out_dtype),
                     matrix_ref.matmul(x.cpu(), y.cpu(), out_dtype)):
            if matrix_k.tensor_cores(dtype, k, n):
                want = want.to(cuda_device)
                err = (got.float() - want.float()).abs()
                assert bool((err <= bounds.matmul_bound(x, y, want)).all()), \
                    (m, k, n)
            else:
                assert _same_bits(_bits(got), _bits(want)), (m, k, n)


def test_primitive_ops_on_card_equal_cpu(cuda_device):
    """The dispatching ops and the engine: a CUDA tensor launches the
    kernels, one per call, and equals the CPU bit for bit; numpy goes to
    the GPU by default."""
    from repro_torch import kernels
    from repro_torch.core import transform_engine as te
    rng = np.random.default_rng(53)
    pts = rng.standard_normal((10_000, 2)).astype(np.float32)
    host = torch.from_numpy(pts)
    dev = host.to(cuda_device)
    _build.reset_launch_counts()
    for op in (lambda p: kernels.translate(p, torch.tensor([1.0, -2.0],
                                                           device=p.device)),
               lambda p: kernels.scale(p, 0.5),
               lambda p: kernels.affine(p, 2.0, 1.0),
               lambda p: kernels.rotate2d(p, 0.3),
               lambda p: kernels.vecadd(p, p),
               lambda p: kernels.matmul(p.reshape(10, -1, 2),
                                        torch.eye(2, device=p.device)),
               # operands of two dtypes widen to float32 first
               lambda p: kernels.matmul(p.bfloat16(),
                                        torch.eye(2, device=p.device) * 0.3,
                                        out_dtype=torch.float32)):
        assert _same_bits(_bits(op(dev)), _bits(op(host)))
    counts = _build.launch_counts()
    assert counts["affine_2d"] == 3 and counts["matmul_2d"] == 3
    assert counts["vecadd_2d"] == 1
    out = te.rotate(pts, 0.3)                        # numpy -> the GPU
    assert out.is_cuda
    assert _same_bits(_bits(out), _bits(te.rotate(pts, 0.3, device="cpu")))


def test_sequential_pipeline_on_card_launches_four_against_one(cuda_device):
    from repro_torch.core import transform_engine as te
    rng = np.random.default_rng(54)
    pts = rng.standard_normal((50_000, 2)).astype(np.float32)
    dev = torch.from_numpy(pts).to(cuda_device)
    t1, t2 = np.array([3.0, 2.0], np.float32), np.array([-1.0, 5.0],
                                                         np.float32)
    _build.reset_launch_counts()
    seq = te.translate(te.rotate(te.scale(te.translate(dev, t2), [1.3, 0.8]),
                                 0.3), t1)
    counts = _build.launch_counts()
    assert counts["affine_2d"] == 3 and counts["matmul_2d"] == 1
    assert sum(counts.values()) == 4
    _build.reset_launch_counts()
    fused = te.Transform2D.identity().then_translate(-1.0, 5.0) \
        .then_scale(1.3, 0.8).then_rotate(0.3).then_translate(3.0, 2.0) \
        .apply(dev)
    counts = _build.launch_counts()
    assert counts["chain_matrix_1d"] == 1 and sum(counts.values()) == 1
    assert seq.is_cuda and fused.is_cuda
    host = torch.from_numpy(pts)
    cpu_seq = te.translate(te.rotate(te.scale(te.translate(host, t2),
                                              [1.3, 0.8]), 0.3), t1)
    assert _same_bits(_bits(seq), _bits(cpu_seq))


def test_primitive_wrappers_count_launches_and_check_operands(cuda_device):
    _build.reset_launch_counts()
    x = torch.ones(4, 3, device=cuda_device)
    s, t = torch.ones(3, device=cuda_device), torch.zeros(3, device=cuda_device)
    diag_k.affine_2d(x, s, t)
    diag_k.affine_2d(x[:0], s, t)                        # empty: no launch
    diag_k.vecadd_2d(x, x)
    matrix_k.matmul_2d(x, torch.ones(3, 2, device=cuda_device))
    counts = _build.launch_counts()
    assert counts["affine_2d"] == counts["vecadd_2d"] \
        == counts["matmul_2d"] == 1
    half = x.half()
    with pytest.raises(TypeError):
        diag_k.affine_2d(half, s.half(), t.half())
    with pytest.raises(TypeError):
        diag_k.vecadd_2d(half, half)
    with pytest.raises(TypeError):
        matrix_k.matmul_2d(half, half.t().contiguous())
    with pytest.raises(TypeError):                       # mixed dtypes
        diag_k.affine_2d(x, s.bfloat16(), t)
    with pytest.raises(TypeError):
        matrix_k.matmul_2d(x, x.t().contiguous(), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA device"):
        diag_k.affine_2d(x.cpu(), s.cpu(), t.cpu())
    with pytest.raises(ValueError, match="CUDA device"):
        matrix_k.matmul_2d(x, torch.ones(3, 2))          # mixed devices
    with pytest.raises(ValueError):
        diag_k.affine_2d(x, s[:2], t[:2])                # s, t not (N,)
    with pytest.raises(ValueError):
        matrix_k.matmul_2d(x, torch.ones(4, 2, device=cuda_device))
    with pytest.raises(ValueError):
        diag_k.vecadd_2d(x.t(), x.t())                   # not contiguous
    assert _build.launch_counts()["affine_2d"] == 1


# -- the model stack's kernels (rmsnorm_2d, rope_3d, flash_attention_3d,
#    ssd_intra) and the serving path -------------------------------------

def _model_kernels():
    import torch_bounds as bounds
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms_k
    from repro_torch.kernels.rope import ref as rope_ref
    from repro_torch.kernels.rope import rope as rope_k
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd import ssd as ssd_k
    return bounds, rms_k, rms_ref, rope_k, rope_ref, fa_k, fa_ref, ssd_k, \
        ssd_ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_within_bound_of_plain(cuda_device, dtype):
    """``rmsnorm_2d`` at row widths 64, 1600 and 3200 (none a power of
    two, nothing padded) and ragged ones, within ``bounds.rmsnorm_bound``
    of the plain version on the card and on the CPU."""
    bounds, rms_k, rms_ref = _model_kernels()[:3]
    rng = np.random.default_rng([61, dtype == torch.bfloat16])
    for m, n in ((1, 1), (3, 64), (4, 1600), (257, 1600), (33, 3200),
                 (5, 37), (2, 5000)):
        x = _dense(rng, (m, n), dtype, cuda_device) * 3
        g = _dense(rng, (n,), torch.float32, cuda_device, 0.5, 1.5)
        got = rms_k.rmsnorm_2d(x, g, eps=1e-5)
        assert got.dtype == dtype and got.shape == x.shape
        for want in (rms_ref.rmsnorm(x, g, 1e-5),
                     rms_ref.rmsnorm(x.cpu(), g.cpu(), 1e-5).to(cuda_device)):
            err = (got.float() - want.float()).abs()
            assert bool((err <= bounds.rmsnorm_bound(want, n)).all()), (m, n)


def _misaligned(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``a`` whose base lies one element past a
    16-byte boundary (a view into a buffer one element longer)."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_vector_and_scalar_paths_within_bound(cuda_device, dtype):
    """Both kernels of ``csrc/rmsnorm.cu`` within ``bounds.rmsnorm_bound``
    of the plain version: the 16-byte one at every warps-a-row instance
    (few rows and many, up to the widest row it takes) and the scalar
    one at rows of no multiple of 16 bytes (N = 33, 100), past the
    widest, and at x or gain one element off 16-byte alignment; M = 1
    among them."""
    bounds, rms_k, rms_ref = _model_kernels()[:3]
    rng = np.random.default_rng([66, dtype == torch.bfloat16])
    widest = 65536 if dtype == torch.bfloat16 else 32768
    for m, n in ((1, 1600), (1, 3200), (3, 8), (200, 64), (4, 1600),
                 (200, 1600), (4, 3200), (200, 3200), (3, 8192),
                 (140, 8192), (140, 16384), (2, widest), (2, widest + 8), (1, 33),
                 (7, 33), (5, 100), (300, 100)):
        x = _dense(rng, (m, n), dtype, cuda_device) * 3
        g = _dense(rng, (n,), torch.float32, cuda_device, 0.5, 1.5)
        want = rms_ref.rmsnorm(x, g, 1e-5)
        bound = bounds.rmsnorm_bound(want, n)
        for xs, gs in ((x, g), (_misaligned(x), g), (x, _misaligned(g))):
            got = rms_k.rmsnorm_2d(xs, gs, eps=1e-5)
            err = (got.float() - want.float()).abs()
            assert bool((err <= bound).all()), (m, n, xs.data_ptr() % 16,
                                                gs.data_ptr() % 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vecadd_vector_and_scalar_paths_equal_plain(cuda_device, dtype):
    """Both kernels of ``vecadd_2d`` bit for bit equal to the plain version
    on the card and on the CPU: totals that are no multiple of 8 (the
    16-byte kernel's scalar tail), M = 1, and x or z one element off
    16-byte alignment (the scalar kernel)."""
    rng = np.random.default_rng([67, dtype == torch.bfloat16])
    for shape in ((1, 1), (1, 7), (3, 5), (1, 1603), (13, 77), (8191, 3),
                  (4, 1600), (4096, 1600), (1, 1 << 20)):
        x = _dense(rng, shape, dtype, cuda_device)
        z = _dense(rng, shape, dtype, cuda_device)
        want = diag_ref.vecadd(x.cpu(), z.cpu())
        for xs, zs in ((x, z), (_misaligned(x), z), (x, _misaligned(z)),
                       (_misaligned(x), _misaligned(z))):
            got = diag_k.vecadd_2d(xs, zs)
            assert _same_bits(_bits(got), _bits(want)), shape
            assert _same_bits(_bits(got), _bits(diag_ref.vecadd(xs, zs)))


@pytest.mark.parametrize("d", [2, 3])
def test_diag_batch_vector_and_scalar_paths_equal_plain(cuda_device, d):
    """Both kernels of ``chain_diag_batch_2d`` bit for bit equal to the
    plain version on the card and on the CPU: the 16-byte one at rows of
    a multiple of 4 floats (d = 3: rows of 1, 2, 3 and many vectors, so
    every column phase starts and ends a row), B > 1024, and the scalar
    one at rows of no multiple of 4 floats and at points one element off
    16-byte alignment."""
    rng = np.random.default_rng([68, d])
    for lead in ((1, 4), (3, 8), (2, 12), (5, 13), (7, 1), (4, 100),
                 (48, 4096), (2, 40_000), (1500, 16), (1100, 13),
                 (3, 3001)):
        pts, p, t = _inputs(rng, lead, d, "diag")
        host = [torch.from_numpy(a) for a in (pts, p, t)]
        want = diag_ref.chain_diag_batch(*host)
        x, s, tt = (a.to(cuda_device) for a in host)
        for xs in (x, _misaligned(x)):
            got = diag_k.chain_diag_batch_2d(xs, s, tt)
            assert _same_bits(got.cpu().numpy(), want.numpy()), (lead, d)
            assert torch.equal(got, diag_ref.chain_diag_batch(xs, s, tt))


@pytest.mark.parametrize("d", [2, 3])
def test_matrix_batch_vector_and_scalar_paths_equal_plain(cuda_device, d):
    """Both kernels of ``chain_matrix_batch_2d`` bit for bit equal to the
    plain version on the card and on the CPU: the 16-byte one at rows of
    whole groups (one group a row and many, the largest served bucket's
    shape, B > 1024), and the scalar one at rows of no whole group (L =
    13, 1, 3001; L = 6 at d = 3, B > 1024) and at points one element off
    16-byte alignment."""
    rng = np.random.default_rng([69, d])
    for lead in ((1, 4), (3, 8), (2, 12), (5, 13), (7, 1), (3, 6),
                 (47, 32768), (2, 40_000), (1500, 16), (1100, 13),
                 (3, 3001)):
        pts, a, t = _inputs(rng, lead, d, "matrix")
        host = [torch.from_numpy(v) for v in (pts, a, t)]
        want = matrix_ref.chain_matrix_batch(*host)
        x, av, tv = (v.to(cuda_device) for v in host)
        for xs in (x, _misaligned(x)):
            got = matrix_k.chain_matrix_batch_2d(xs, av, tv)
            assert _same_bits(got.cpu().numpy(), want.numpy()), (lead, d)
            assert torch.equal(got, matrix_ref.chain_matrix_batch(xs, av,
                                                                  tv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_regimes_equal_plain(cuda_device, dtype):
    """Each regime of ``affine_2d`` bit for bit equal to the plain version
    on the card and on the CPU: flat vectors (N dividing the width), with
    scalar tails where the total is no multiple of it; column vectors (N
    a multiple of the width: narrow, ragged column tiles, M = 1); the
    scalar kernel (N = 3, 100; x, s or t one element off 16-byte
    alignment, which sends every N to it); signed zeros at N = 1024."""
    rng = np.random.default_rng([69, dtype == torch.bfloat16])
    for shape in ((1, 1), (3, 1), (4097, 1), (1, 2), (5, 2), (70_001, 2),
                  (2, 4), (1001, 4), (3001, 8), (4097, 8), (999, 12),
                  (7, 16), (3, 24), (33, 520), (4, 1600), (300, 1600),
                  (1024, 1024), (1, 1 << 16), (5, 3), (3001, 3),
                  (17, 100), (4097, 100)):
        x = _dense(rng, shape, dtype, cuda_device)
        s = _dense(rng, shape[1:], dtype, cuda_device, -2, 2)
        t = _dense(rng, shape[1:], dtype, cuda_device, -3, 3)
        want = diag_ref.affine(x.cpu(), s.cpu(), t.cpu())
        for xs, ss, ts in ((x, s, t), (_misaligned(x), s, t),
                           (x, _misaligned(s), t), (x, s, _misaligned(t))):
            got = diag_k.affine_2d(xs, ss, ts)
            assert _same_bits(_bits(got), _bits(want)), shape
            assert _same_bits(_bits(got), _bits(diag_ref.affine(xs, ss, ts)))
    x = _dense(rng, (64, 1024), dtype, cuda_device)
    x[::2] = -0.0
    s = _dense(rng, (1024,), dtype, cuda_device, -2, 2)
    s[::3] = 0.0
    zero = torch.zeros(1024, dtype=dtype, device=cuda_device)
    out = diag_k.affine_2d(x, s, zero)
    assert not torch.signbit(out[out == 0]).any()
    assert _same_bits(_bits(out), _bits(diag_ref.scale(x.cpu(), s.cpu())))


def test_cuda_server_with_a_custom_grid_equals_cpu_bitwise(cuda_device):
    """``waste_cap=0.2`` gives padded lengths that are no power of two, so
    some diag buckets have rows of no multiple of 4 floats (the scalar
    batch kernel) beside others that take the 16-byte one: the GPU server
    bit for bit equal to the CPU server."""
    reqs = workload.random_workload(seed=6, n_requests=96,
                                    templates=workload.AFFINE_TEMPLATES,
                                    min_points=9, max_points=4096)
    cpu = serving.GeometryServer(device="cpu", waste_cap=0.2).serve(reqs)
    srv = serving.GeometryServer(device=cuda_device, waste_cap=0.2)
    gpu = srv.serve(reqs)
    rows = {rep.lpad * int(rep.structure[0]) % 4 == 0
            for rep in srv.last_report if rep.kind == "diag"}
    assert rows == {True, False}
    for c, g in zip(cpu, gpu, strict=True):
        assert _same_bits(c, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_equals_plain_bitwise(cuda_device, dtype):
    """``rope_3d`` rounds after each op as eager torch does: bit for bit
    the plain version on the card and on the CPU, head dims 16 and 64,
    ragged sequence lengths."""
    _, _, _, rope_k, rope_ref = _model_kernels()[:5]
    rng = np.random.default_rng([62, dtype == torch.bfloat16])
    for bh, s, d in ((1, 1, 2), (100, 37, 64), (20, 200, 64), (8, 48, 16)):
        x = _dense(rng, (bh, s, d), dtype, cuda_device)
        pos = torch.arange(1000, 1000 + s, device=cuda_device)
        cos, sin = (t.to(dtype) for t in rope_ref.rope_tables(pos, d))
        got = rope_k.rope_3d(x, cos, sin)
        for want in (rope_ref.rope(x, cos, sin),
                     rope_ref.rope(x.cpu(), cos.cpu(), sin.cpu())):
            assert _same_bits(_bits(got), _bits(want)), (bh, s, d)


def _rope_case(rng, shape, dtype, device, pos0=0):
    _, _, _, _, rope_ref = _model_kernels()[:5]
    bh, s, d = shape
    x = _dense(rng, shape, dtype, device)
    pos = torch.arange(pos0, pos0 + s, device=device)
    cos, sin = (t.to(dtype).contiguous() for t in rope_ref.rope_tables(pos, d))
    return x, cos, sin


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_vector_kernel_equals_plain_bitwise(cuda_device, dtype):
    """``rope_3d``'s 16-byte kernel (a half row of a multiple of 16 bytes
    on aligned buffers): every RoPE head width of the configs (64, 80, 96,
    128) and the reduced models' 16, hymba's prefill and decode shapes,
    one head and more heads than a group, bit for bit the plain version
    on the card and on the CPU."""
    _, _, _, rope_k, rope_ref = _model_kernels()[:5]
    rng = np.random.default_rng([70, dtype == torch.bfloat16])
    for shape in ((100, 2048, 64), (20, 2048, 64), (100, 1, 64), (20, 1, 64),
                  (1, 1, 64), (3, 37, 80), (7, 300, 96), (5, 2048, 128),
                  (130, 5, 128), (2, 33, 16), (4097, 1, 16)):
        x, cos, sin = _rope_case(rng, shape, dtype, cuda_device, pos0=2000)
        got = rope_k.rope_3d(x, cos, sin)
        assert _same_bits(_bits(got), _bits(rope_ref.rope(x, cos, sin))), shape
        assert _same_bits(_bits(got), _bits(rope_ref.rope(
            x.cpu(), cos.cpu(), sin.cpu()))), shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_scalar_kernel_equals_plain_bitwise(cuda_device, dtype):
    """``rope_3d``'s scalar kernel: half rows of no multiple of 16 bytes
    (D = 2, 20 in bfloat16, 6 in float32) and x, y's source, cos or sin
    one element off 16-byte alignment at hymba's widths, bit for bit the
    plain version on the card and on the CPU."""
    _, _, _, rope_k, rope_ref = _model_kernels()[:5]
    rng = np.random.default_rng([71, dtype == torch.bfloat16])
    for shape in ((1, 1, 2), (20, 200, 20), (3, 17, 6), (8, 48, 40)):
        x, cos, sin = _rope_case(rng, shape, dtype, cuda_device)
        got = rope_k.rope_3d(x, cos, sin)
        assert _same_bits(_bits(got), _bits(rope_ref.rope(
            x.cpu(), cos.cpu(), sin.cpu()))), shape
    for shape in ((100, 2048, 64), (20, 1, 64), (3, 37, 128)):
        x, cos, sin = _rope_case(rng, shape, dtype, cuda_device)
        want = rope_ref.rope(x.cpu(), cos.cpu(), sin.cpu())
        for xs, cs, ss in ((_misaligned(x), cos, sin),
                           (x, _misaligned(cos), sin),
                           (x, cos, _misaligned(sin))):
            got = rope_k.rope_3d(xs, cs, ss)
            assert _same_bits(_bits(got), _bits(want)), shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_within_bound_of_plain(cuda_device, dtype):
    """``flash_attention_3d`` within ``bounds.flash_bound`` of its plain
    version (for bfloat16 the tensor-core kernel's bound): GQA groups 1
    to 5, causal with and without a window (an edge on a tile boundary
    and one inside a tile), ``q_offset`` with S < T (decode-like),
    non-causal, every head dim of ``HEAD_DIMS``, and S and T that are no
    multiple of any tile (D = 80, 96 and 128 among them)."""
    bounds = _model_kernels()[0]
    fa_k, fa_ref = _model_kernels()[5:7]
    rng = np.random.default_rng([63, dtype == torch.bfloat16])
    for bhkv, group, s, t, d, causal, window, q_off in (
            (2, 1, 37, 37, 64, True, None, 0),
            (2, 5, 300, 300, 64, True, 128, 0),
            (2, 5, 300, 300, 64, True, 100, 0),
            (1, 5, 200, 200, 16, True, 32, 0),
            (3, 2, 5, 261, 64, True, 64, 256),
            (1, 4, 1, 77, 80, True, None, 76),
            (2, 1, 50, 70, 96, False, None, 0),
            (4, 5, 129, 129, 128, True, 1024, 0),
            (2, 2, 200, 333, 80, True, 100, 133),
            (2, 3, 157, 157, 96, True, None, 0),
            (1, 2, 300, 300, 128, False, None, 0),
            (2, 1, 77, 200, 128, True, 50, 123)):
        q = _dense(rng, (bhkv * group, s, d), dtype, cuda_device)
        k = _dense(rng, (bhkv, t, d), dtype, cuda_device)
        v = _dense(rng, (bhkv, t, d), dtype, cuda_device)
        scale = d ** -0.5
        got = fa_k.flash_attention_3d(q, k, v, scale=scale, causal=causal,
                                      window=window, q_offset=q_off)
        want = fa_ref.flash_attention(q, k, v, scale=scale, causal=causal,
                                      window=window, q_offset=q_off)
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs()
        bound = bounds.flash_bound(q, k, v, scale, want)
        assert bool((err <= bound).all()), (bhkv, group, s, t, d, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_within_bound_of_plain(cuda_device, dtype):
    """``ssd_intra`` within ``bounds.ssd_bounds`` of its plain version
    (bfloat16: the tensor-core kernel, the bound's ``tensor_cores``
    branch; float32: the CUDA-core kernel) at lc = 1, 16, 65, 100 and
    256, (p, n) = (16, 16), (64, 16) and (64, 128), hymba-1.5b's 50 heads
    and mamba2-130m's 24 (n = 128) over a few chunks, head counts that
    leave a short last group, and bfloat16 operands one element off
    16-byte alignment, with strongly decaying ``cum`` (by up to 2 or 4 a
    row, so masked exponents would overflow, even inside one 64-key
    tile, if they were not masked before exp) and with mildly decaying
    ``cum`` (so every key tile adds to the last rows)."""
    bounds = _model_kernels()[0]
    ssd_k, ssd_ref = _model_kernels()[7:]
    rng = np.random.default_rng([64, dtype == torch.bfloat16])
    for bc, lc, h, p, n, decay in (
            (3, 16, 4, 16, 16, 2.0), (2, 256, 5, 64, 16, 2.0),
            (2, 256, 3, 64, 128, 2.0), (1, 100, 2, 64, 128, 2.0),
            (3, 256, 50, 64, 16, 4.0), (2, 256, 50, 64, 16, 0.01),
            (3, 256, 24, 64, 128, 4.0), (2, 256, 24, 64, 128, 0.01),
            (2, 100, 50, 64, 16, 0.01), (2, 100, 24, 64, 128, 2.0),
            (2, 1, 3, 16, 16, 2.0), (2, 65, 9, 64, 16, 0.01),
            (1, 256, 17, 16, 16, 0.01)):
        xdt = _dense(rng, (bc, lc, h, p), dtype, cuda_device)
        b = _dense(rng, (bc, lc, n), dtype, cuda_device)
        c = _dense(rng, (bc, lc, n), dtype, cuda_device)
        a = -torch.from_numpy(rng.uniform(decay / 200, decay, (bc, lc, h))
                              .astype(np.float32)).to(cuda_device)
        cum = torch.cumsum(a, dim=1)
        wy, ws = ssd_ref.ssd_intra(xdt, b, c, cum)
        by, bs = bounds.ssd_bounds(xdt, b, c, cum, ssd_ref.ssd_intra,
                                   tensor_cores=True)
        views = ((xdt, b, c),)
        if dtype == torch.bfloat16:
            views += ((_misaligned(xdt), _misaligned(b), _misaligned(c)),)
        for xs, bs_, cs in views:
            y, s_c = ssd_k.ssd_intra(xs, bs_, cs, cum)
            assert y.dtype == s_c.dtype == torch.float32
            assert bool(torch.isfinite(y).all()) \
                and bool(torch.isfinite(s_c).all())
            assert bool(((y - wy).abs() <= by).all()), (bc, lc, h, p, n)
            assert bool(((s_c - ws).abs() <= bs).all()), (bc, lc, h, p, n)


def test_model_kernel_wrappers_check_operands(cuda_device):
    bounds, rms_k, _, rope_k, _, fa_k, _, ssd_k, _ = _model_kernels()
    x = torch.ones(4, 64, device=cuda_device)
    g = torch.ones(64, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA device"):
        rms_k.rmsnorm_2d(x.cpu(), g.cpu())
    with pytest.raises(TypeError):
        rms_k.rmsnorm_2d(x, g.bfloat16())
    with pytest.raises(ValueError, match="CUDA device"):
        rope_k.rope_3d(x.cpu()[None], g.cpu()[None, :32].expand(4, 32)
                       .contiguous(), g.cpu()[None, :32].expand(4, 32)
                       .contiguous())
    q = torch.ones(5, 8, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fa_k.flash_attention_3d(q, q[:2], q[:2], scale=0.125)   # 5 % 2
    with pytest.raises(ValueError):
        fa_k.flash_attention_3d(q[..., :48].contiguous(),
                                q[:1, :, :48].contiguous(),
                                q[:1, :, :48].contiguous(), scale=0.125)
    with pytest.raises(ValueError, match="CUDA device"):
        fa_k.flash_attention_3d(q.cpu(), q.cpu(), q.cpu(), scale=0.125)
    xdt = torch.ones(1, 300, 2, 16, device=cuda_device)
    bn = torch.ones(1, 300, 16, device=cuda_device)
    with pytest.raises(ValueError):                       # lc > 256
        ssd_k.ssd_intra(xdt, bn, bn, torch.zeros(1, 300, 2,
                                                 device=cuda_device))
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_k.ssd_intra(xdt.cpu(), bn.cpu(), bn.cpu(),
                        torch.zeros(1, 300, 2))


def test_reduced_hymba_serves_on_card_through_the_kernels(cuda_device):
    """The reduced hymba-1.5b serves on the card; its prefill launches
    rmsnorm_2d 5L+1, rope_3d 2L, flash_attention_3d L, ssd_intra L and
    vecadd_2d 2L times (L layers), each decode step the same without
    flash attention and SSD; the tokens equal the plain path's on the
    card (``use_backend("ref")``) and logits agree to float32 rounding."""
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    cfg = configs.get("hymba-1.5b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompts = np.random.default_rng(65).integers(0, cfg.vocab_size, (4, 48))
    L, gen = cfg.n_layers, 8
    _build.reset_launch_counts()
    trace = {}
    toks = serve_batch(cfg, params, prompts, gen_tokens=gen, model=model,
                       trace=trace)
    pre, total = trace["launches_prefill"], _build.launch_counts()
    assert pre["rmsnorm_2d"] == 5 * L + 1 and pre["rope_3d"] == 2 * L
    assert pre["flash_attention_3d"] == L and pre["ssd_intra"] == L
    assert pre["vecadd_2d"] == 2 * L
    dec = {k: total[k] - pre[k] for k in pre}
    assert dec["rmsnorm_2d"] == gen * (5 * L + 1)
    assert dec["rope_3d"] == gen * 2 * L and dec["vecadd_2d"] == gen * 2 * L
    assert dec["flash_attention_3d"] == dec["ssd_intra"] == 0
    ref_trace = {}
    with dispatch.use_backend("ref"):
        _build.reset_launch_counts()
        ref_toks = serve_batch(cfg, params, prompts, gen_tokens=gen,
                               model=model, trace=ref_trace)
        assert sum(_build.launch_counts().values()) == 0
    assert np.array_equal(toks, ref_toks)
    for a, b in zip(trace["logits"], ref_trace["logits"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_reduced_granite_serves_on_card_through_the_kernels(cuda_device):
    """The reduced granite-moe-3b-a800m (MoE, attention only) serves on the
    card: a prefill launches rmsnorm_2d 2L+1, rope_3d 2L,
    flash_attention_3d L and vecadd_2d 2L times and no ssd_intra, a
    decode step the same without flash; the tokens equal the plain
    path's on the card, the logits agree to float32 rounding, and a
    second serve gives the same bits."""
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompts = np.random.default_rng(66).integers(0, cfg.vocab_size, (4, 48))
    L, gen = cfg.n_layers, 8
    _build.reset_launch_counts()
    trace, again = {}, {}
    toks = serve_batch(cfg, params, prompts, gen_tokens=gen, model=model,
                       trace=trace)
    pre, total = trace["launches_prefill"], _build.launch_counts()
    assert pre["rmsnorm_2d"] == 2 * L + 1 and pre["rope_3d"] == 2 * L
    assert pre["flash_attention_3d"] == L and pre["vecadd_2d"] == 2 * L
    assert total["ssd_intra"] == 0
    dec = {k: total[k] - pre[k] for k in pre}
    assert dec["rmsnorm_2d"] == gen * (2 * L + 1)
    assert dec["rope_3d"] == gen * 2 * L and dec["vecadd_2d"] == gen * 2 * L
    assert dec["flash_attention_3d"] == 0
    assert np.array_equal(serve_batch(cfg, params, prompts, gen_tokens=gen,
                                      model=model, trace=again), toks)
    assert all(torch.equal(a, b)
               for a, b in zip(trace["logits"], again["logits"]))
    ref_trace = {}
    with dispatch.use_backend("ref"):
        _build.reset_launch_counts()
        ref_toks = serve_batch(cfg, params, prompts, gen_tokens=gen,
                               model=model, trace=ref_trace)
        assert sum(_build.launch_counts().values()) == 0
    assert np.array_equal(toks, ref_toks)
    for a, b in zip(trace["logits"], ref_trace["logits"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("bhq, bhkv, s, t, d, causal", [
    (64, 64, 1500, 1500, 64, False),    # whisper's encoder
    (64, 64, 1, 1500, 64, False),       # its cross-attention, one query
    (64, 64, 1, 1, 64, True),           # its self-attention prefill
    (256, 32, 2048, 2048, 128, True)])  # internvl2-76b's prefill, group 8
def test_flash_kernel_at_the_encdec_and_vlm_serve_shapes(cuda_device, bhq,
                                                         bhkv, s, t, d,
                                                         causal):
    """The bfloat16 (wgmma) kernel at the serve shapes of whisper-medium
    (no mask with S = T = 1500, whose last kv tile is ragged; one query
    row of a 128-row tile against 1500 keys; one against one, causal) and
    internvl2-76b (D = 128, a GQA group of 8), within ``flash_bound`` of
    its plain version."""
    bounds, fa_k, fa_ref = (_model_kernels()[i] for i in (0, 5, 6))
    rng = np.random.default_rng([64, s, t, d])
    q = _dense(rng, (bhq, s, d), torch.bfloat16, cuda_device)
    k = _dense(rng, (bhkv, t, d), torch.bfloat16, cuda_device)
    v = _dense(rng, (bhkv, t, d), torch.bfloat16, cuda_device)
    scale = d ** -0.5
    got = fa_k.flash_attention_3d(q, k, v, scale=scale, causal=causal)
    want = fa_ref.flash_attention(q, k, v, scale=scale, causal=causal)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs()
    assert bool((err <= bounds.flash_bound(q, k, v, scale, want)).all())


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_reduced_encdec_and_vlm_serve_on_card_through_the_kernels(
        cuda_device, arch):
    """The reduced whisper-medium (enc-dec: zero frames, decoding from
    position 1) and internvl2-76b (VLM: a zero patch prefix) serve on the
    card: whisper's prefill launches rmsnorm_2d 2E+1+3L+1,
    flash_attention_3d E+2L and vecadd_2d 2E+3L times and no rope_3d, a
    decode step 3L+1, L (cross-attention) and 3L; internvl2's as a dense
    model's; the tokens equal the plain path's on the card, the logits
    agree to float32 rounding, and a second serve gives the same bits."""
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    cfg = configs.get(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompts = np.random.default_rng(67).integers(0, cfg.vocab_size, (4, 48))
    L, E, gen = cfg.n_layers, cfg.encoder_layers, 8
    _build.reset_launch_counts()
    trace, again = {}, {}
    toks = serve_batch(cfg, params, prompts, gen_tokens=gen, model=model,
                       trace=trace)
    pre, total = trace["launches_prefill"], _build.launch_counts()
    dec = {k: total[k] - pre[k] for k in pre}
    if cfg.is_encdec:
        assert pre["rmsnorm_2d"] == 2 * E + 1 + 3 * L + 1
        assert pre["flash_attention_3d"] == E + 2 * L
        assert pre["vecadd_2d"] == 2 * E + 3 * L
        assert dec["rmsnorm_2d"] == gen * (3 * L + 1)
        assert dec["flash_attention_3d"] == gen * L
        assert dec["vecadd_2d"] == gen * 3 * L
        assert total["rope_3d"] == 0
    else:
        assert pre["rmsnorm_2d"] == 2 * L + 1 and pre["rope_3d"] == 2 * L
        assert pre["flash_attention_3d"] == L and pre["vecadd_2d"] == 2 * L
        assert dec["flash_attention_3d"] == 0
    assert total["ssd_intra"] == 0
    assert np.array_equal(serve_batch(cfg, params, prompts, gen_tokens=gen,
                                      model=model, trace=again), toks)
    assert all(torch.equal(a, b)
               for a, b in zip(trace["logits"], again["logits"]))
    ref_trace = {}
    with dispatch.use_backend("ref"):
        _build.reset_launch_counts()
        ref_toks = serve_batch(cfg, params, prompts, gen_tokens=gen,
                               model=model, trace=ref_trace)
        assert sum(_build.launch_counts().values()) == 0
    assert np.array_equal(toks, ref_toks)
    for a, b in zip(trace["logits"], ref_trace["logits"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_int8_cache_decode_step_on_card_matches_the_cpu(cuda_device):
    """One decode step of the reduced granite-moe-3b-a800m with an int8 KV
    cache, on the card through the kernels and on the CPU through the
    plain versions, from the same prefilled cache: every slot the step
    does not write stays bitwise, the new slot's int8 words differ by at
    most one step (float32 rounding may move a value across a rounding
    boundary of x / scale), its scales agree to float32 rounding, and the
    logits within 1e-3 of their largest (a word one step off moves one
    key or value element by max|row| / 127, within 1e-3 through two
    reduced layers)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import build
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m").reduced(),
                              kv_cache_dtype="int8")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(68).integers(
        0, cfg.vocab_size, (4, 40)))
    batch, pos, _ = serve_inputs(cfg, prompts)
    cache = model.init_cache(4, 48, device="cpu")
    logits, cache = model.prefill(params, batch, cache)
    tok = logits.argmax(-1)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    card_cache = to(cache, cuda_device)
    _build.reset_launch_counts()
    got, card_cache = model.decode(to(params, cuda_device),
                                   tok.to(cuda_device), pos, card_cache)
    assert _build.launch_counts()["rmsnorm_2d"] == 2 * cfg.n_layers + 1
    want, cache = model.decode(params, tok, pos, cache)
    got_cache = to(card_cache, "cpu")
    for g, w in zip(got_cache, cache):
        assert g["k"].dtype == torch.int8 and torch.equal(g["kpos"], w["kpos"])
        for name in ("k", "v", "kscale", "vscale"):
            old, new = (torch.cat([a[:, :, :pos], a[:, :, pos + 1:]], dim=2)
                        for a in (g[name], w[name]))
            assert torch.equal(old, new), name
        for name in ("k", "v"):
            step = (g[name][:, :, pos].int() - w[name][:, :, pos].int()).abs()
            assert int(step.max()) <= 1, name
            sg, sw = g[name + "scale"][:, :, pos], w[name + "scale"][:, :, pos]
            assert float((sg - sw).abs().max()) <= 1e-5 * float(sw.abs().max())
    got = got.cpu()
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


#: the seed of the MoE card test's weights and tokens: every token's k-th
#: and (k+1)-th router probabilities differ by more than MOE_MARGIN on
#: the CPU, in float32 and in bfloat16, for the prompt and the decode
#: group (asserted), so the card's routing must equal the CPU's
MOE_SEED, MOE_MARGIN = 4, 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_card_is_deterministic_and_matches_the_cpu(cuda_device,
                                                              dtype):
    """``moe_ffn`` at granite-moe-3b-a800m's width (1536, 40 experts, top
    8; two layers' worth of tokens) on the card: the same routing as on
    the CPU, the output within float rounding of the CPU's (bfloat16:
    the gate and up products in float32 on both), and two calls bitwise
    equal (no atomics in the combine).  Weights and tokens are made on
    the CPU from MOE_SEED and copied to the card."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get("granite-moe-3b-a800m")
    k = cfg.experts_per_token
    cpu = moe.init(torch.Generator().manual_seed(MOE_SEED), cfg, dtype)
    params = {n: v.to(cuda_device) for n, v in cpu.items()}
    x = torch.from_numpy(np.random.default_rng(MOE_SEED).standard_normal(
        (2, 256, cfg.d_model)).astype(np.float32)).to(dtype)
    for xc in (x, x[:, :1]):        # a prompt, and a decode step's group
        rc = moe.route(cpu["router"], xc, cfg)
        top = torch.sort(rc.probs, dim=-1, descending=True).values
        assert float((top[..., k - 1] - top[..., k]).min()) > MOE_MARGIN
        xs = xc.to(cuda_device)
        y, aux = moe.moe_ffn(params, xs, cfg)
        y2, aux2 = moe.moe_ffn(params, xs, cfg)
        assert torch.equal(y, y2) and torch.equal(aux, aux2)
        r = moe.route(params["router"], xs, cfg)
        assert torch.equal(r.expert_ids.cpu(), rc.expert_ids)
        yc, _ = moe.moe_ffn(cpu, xc, cfg)
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
        assert float((y.cpu().float() - yc.float()).abs().max()) \
            <= tol * float(yc.float().abs().max())


def test_scene_lanes_on_card_equal_submit_apply_and_the_cpu(cuda_device):
    """``submit_scene`` on a CUDA server, for the diag and the matrix
    scene, q8.7 and float32: bitwise equal to ``submit(world_chain)`` in
    the same flush, to per-request ``apply`` on the card, to the CPU
    server's results, and through ``submit_scene_async`` to the sync
    flush; the batch kernels launched."""
    import torch_scenes as ts
    from repro_torch import scene
    from repro_torch.core import transform_chain as tc
    rng = np.random.default_rng(ts.SCENE_SEED)
    for kind in ("diag", "matrix"):
        g, names = ts.BUILD[kind][0](scene, tc, 3, 4)
        pts = ts.leaf_points(rng, len(names), 1000, g.dim)
        ts.edit(scene, tc, g, kind, 1, 3)
        res = {}
        for dev in (cuda_device, "cpu"):
            srv = serving.GeometryServer(device=dev)
            _build.reset_launch_counts()
            for n, p in zip(names, pts):
                srv.submit_scene(g, n, p, qformat="q8.7")
                srv.submit_scene(g, n, p)
                srv.submit(g.world_chain(n), p)
            res[str(dev)] = srv.flush()
        got, want = res[str(cuda_device)], res["cpu"]
        assert all(_same_bits(a, b) for a, b in zip(got, want))
        for i, (n, p) in enumerate(zip(names, pts)):
            q, f, twin = got[3 * i:3 * i + 3]
            assert _same_bits(f, twin)
            chain = g.world_chain(n)
            assert _same_bits(f, chain.apply(p, device=cuda_device)
                              .cpu().numpy())
            assert _same_bits(q, chain.apply(p, dtype="q8.7",
                                             device=cuda_device)
                              .cpu().numpy())
        eng = serving.AsyncGeometryServer(device=cuda_device,
                                          clock=serving.VirtualClock())
        _build.reset_launch_counts()
        tickets = []
        for n, p in zip(names, pts):
            tickets.append(eng.submit_scene_async(g, n, p, qformat="q8.7"))
            tickets.append(eng.submit_scene_async(g, n, p))
            tickets.append(eng.submit_async(g.world_chain(n), p))
        eng.drain()
        counts = _build.launch_counts()
        batch = {"diag": "chain_diag_batch_2d",
                 "matrix": "chain_matrix_batch_2d"}[kind]
        assert counts[batch] > 0 and counts[batch + "_q"] > 0
        assert all(_same_bits(np.asarray(t.result()), w)
                   for t, w in zip(tickets, got))


def test_chaos_soak_on_card_gives_the_two_rung_counters(cuda_device):
    """The chaos soak on a CUDA server walks the card's two-rung ladder
    (the kernels, then the plain versions on the card) and gives the JAX
    package's two-rung counters exactly, every resolved result bitwise
    equal to per-request ``apply``/``project``."""
    import torch_chaos
    rep = serving.run_chaos_soak(seed=torch_chaos.SEED,
                                 n_requests=torch_chaos.N_REQUESTS,
                                 device=cuda_device,
                                 fault_config=serving.FaultConfig(
                                     backoff_base_s=0.0))
    assert rep.backend == "cuda"
    assert rep.counters() == torch_chaos.TWO_RUNG


def test_contained_exception_on_card_checks_the_device(cuda_device,
                                                       monkeypatch):
    """A launch that raises on a CUDA server (not injected) is contained
    once ``torch.cuda.synchronize`` shows the device healthy: its request
    resolves to a ``LaunchError`` after the kernel rung's attempts -- the
    plain version on the card never stands in for a kernel that raised
    -- and its neighbour serves bitwise equal to the CPU server."""
    from repro_torch import errors
    from repro_torch.core import transform_chain as tc
    from repro_torch.serving import engine
    bad = tc.TransformChain.identity(2).translate(0.5, -0.25)
    good = tc.TransformChain.identity(3).translate(1.0, 2.0, 3.0)
    calls = []

    def boom(folded, pts3):
        calls.append(pts3.device.type)
        raise RuntimeError("kernel refused")
    plan = engine.get_batch_plan(bad.structure, "cuda")
    monkeypatch.setitem(engine._BATCH_PLANS, (bad.structure, "cuda", None),
                        engine.BatchPlan(kind=plan.kind, dim=plan.dim,
                                         backend="cuda", fn=boom))
    synced = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (synced.append(1), real_sync(*a)))
    rng = np.random.default_rng(56)
    pts = rng.standard_normal((40, 3)).astype(np.float32)
    serving.reset_stats()
    srv = serving.GeometryServer(device=cuda_device, fault_config=serving
                                 .FaultConfig(backoff_base_s=0.0))
    out = srv.serve([(bad, rng.standard_normal((8, 2)).astype(np.float32)),
                     (good, pts)])
    assert isinstance(out[0], errors.LaunchError)
    assert "('cuda',)" in str(out[0]) and "kernel refused" in str(out[0])
    assert len(calls) == 3 and set(calls) == {"cuda"} and len(synced) >= 3
    assert serving.stats["backend_fallbacks"] == 0
    assert _same_bits(out[1], good.apply(pts, device="cpu").numpy())


def test_async_drain_on_card_equals_the_sync_flush(cuda_device):
    """A frozen-clock drain on the card launches exactly the synchronous
    flush's buckets and returns its results bit for bit."""
    reqs = workload.mixed_lane_workload(5, 48)
    serving.reset_stats()
    sync = serving.GeometryServer(device=cuda_device)
    for c, p, q in reqs:
        sync.submit(c, p, qformat=q)
    want = sync.flush()
    launches = serving.stats["launches"]
    serving.reset_stats()
    eng = serving.AsyncGeometryServer(device=cuda_device,
                                      clock=serving.VirtualClock())
    tickets = [eng.submit_async(c, p, qformat=q) for c, p, q in reqs]
    eng.drain()
    assert serving.stats["launches"] == launches
    assert eng.server.last_report == sync.last_report
    for t, w in zip(tickets, want):
        assert _same_bits(np.asarray(t.result()), np.asarray(w))


# -- autotune: every launch knob on the card ---------------------------------

def _chain_calls(dev, rng, kernel, shape):
    """``cfg -> result`` of a chain op at ``shape`` on the card (the
    search's own seeded entry)."""
    from repro_torch.autotune import search
    return search._chain_entry(kernel, "cuda", dev, shape,
                               "q8.7" if kernel.endswith("_q") else "float32")


def _outs(r):
    return r if isinstance(r, tuple) else (r,)


@pytest.mark.parametrize("kernel", ["chain_diag", "chain_apply",
                                    "chain_project", "chain_diag_q",
                                    "chain_apply_q"])
def test_every_single_chain_candidate_equals_the_default(cuda_device, kernel):
    """Every candidate of a single-chain kernel gives the default config's
    bits (masks included), through its scalar kernel and, for
    ``chain_project_1d`` from 2**19 points, its 16-byte one."""
    from repro_torch.autotune import DEFAULTS, search
    rng = np.random.default_rng(90)
    for n in (37, 100_003, (1 << 19) + 3):
        for d in (2, 3):
            run = _chain_calls(cuda_device, rng, kernel, (n, d))
            want = _outs(run(DEFAULTS[kernel]))
            for cfg in search.candidates_for(kernel):
                got = _outs(run(cfg))
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (n, d, cfg.describe())


@pytest.mark.parametrize("kernel", ["chain_diag_batch", "chain_apply_batch",
                                    "chain_project_batch",
                                    "chain_diag_batch_q",
                                    "chain_apply_batch_q"])
def test_every_batch_chain_candidate_equals_the_default(cuda_device, kernel):
    """Every candidate of a batch kernel -- waves for its 16-byte kernel,
    threads x waves for its scalar one, both spaces at both kinds of
    shape -- gives the default config's bits."""
    from repro_torch.autotune import DEFAULTS, search
    rng = np.random.default_rng(91)
    cands = search.chain_batch_candidates(kernel) \
        + search.chain_batch_candidates(kernel, vectors=False)
    for shape in ((5, 13, 2), (3, 6, 3), (1100, 8, 3), (6, 4096, 2),
                  (4, 1024, 3)):
        run = _chain_calls(cuda_device, rng, kernel, shape)
        want = _outs(run(DEFAULTS[kernel]))
        for cfg in cands:
            got = _outs(run(cfg))
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                (shape, cfg.describe())


def test_every_matmul_candidate_on_the_card(cuda_device):
    """Every (bn, stages) of ``matmul_2d``'s wgmma regime within
    ``matmul_bound`` of the plain version; the ring's stages move no bit
    at a given BN."""
    import torch_bounds as bounds
    from repro_torch import kernels
    from repro_torch.autotune import search
    rng = np.random.default_rng(92)
    for m, k, n in ((1024, 1024, 1024), (130, 1024, 70), (256, 512, 384)):
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                             ).to(cuda_device, torch.bfloat16)
        y = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                             ).to(cuda_device, torch.bfloat16)
        want = matrix_ref.matmul(x, y)
        bound = bounds.matmul_bound(x, y, want)
        by_bn = {}
        for cfg in search.matmul_candidates():
            got = kernels.matmul(x, y, config=cfg)
            err = (got.float() - want.float()).abs()
            assert bool((err <= bound).all()), (m, k, n, cfg.describe())
            first = by_bn.setdefault(cfg.bn, got)
            assert torch.equal(got, first), (m, k, n, cfg.describe())


def test_every_rmsnorm_candidate_on_the_card(cuda_device):
    """Every feasible ``row_warps`` within ``rmsnorm_bound`` of the plain
    version, and the count the kernel picks itself bit for bit."""
    import torch_bounds as bounds
    from repro_torch import kernels
    from repro_torch.autotune import costmodel, search
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    rng = np.random.default_rng(93)
    for (m, n), dtype in (((8192, 1600), torch.bfloat16),
                          ((4, 3200), torch.float32),
                          ((300, 64), torch.float32)):
        x = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)
                             ).to(cuda_device, dtype)
        g = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)
                             ).to(cuda_device)
        want = rms_ref.rmsnorm(x, g, 1e-6)
        base = kernels.rmsnorm(x, g)
        own = costmodel.rmsnorm_warps(m, n * x.element_size() // 16)
        ran = 0
        for cfg in search.rmsnorm_candidates():
            if not costmodel.rmsnorm_cost(m, n, cfg,
                                          itemsize=x.element_size()).feasible:
                continue
            got = kernels.rmsnorm(x, g, config=cfg)
            err = (got.float() - want.float()).abs()
            assert bool((err <= bounds.rmsnorm_bound(want, n)).all()), \
                (m, n, cfg.row_warps)
            if cfg.row_warps == own:
                assert torch.equal(got, base)
            ran += 1
        assert ran >= 1


def test_infeasible_knobs_raise_on_the_card(cuda_device):
    from repro_torch.kernels.rmsnorm import rmsnorm as rms_k
    x = torch.ones(64, 2, device=cuda_device)
    s, t = torch.ones(2, device=cuda_device), torch.zeros(2, device=cuda_device)
    with pytest.raises(ValueError, match="block_threads"):
        diag_k.chain_diag_1d(x.reshape(-1), s, t, d=2, block_threads=100)
    with pytest.raises(ValueError, match="waves"):
        diag_k.chain_diag_batch_2d(x[None], s[None], t[None], waves=-2)
    b = torch.ones(64, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bn"):
        matrix_k.matmul_2d(b, b, bn=256)
    with pytest.raises(ValueError, match="stages"):
        matrix_k.matmul_2d(b, b, stages=5)
    f = torch.ones(4, 3200, device=cuda_device)
    g = torch.ones(3200, device=cuda_device)
    with pytest.raises(ValueError, match="row_warps"):
        rms_k.rmsnorm_2d(f, g, row_warps=1)          # 800 vectors a row
    # rows of 33 bfloat16 values (66 bytes) take the scalar kernel only
    with pytest.raises(ValueError, match="row_warps"):
        rms_k.rmsnorm_2d(torch.ones(4, 33, device=cuda_device,
                                    dtype=torch.bfloat16),
                         torch.ones(33, device=cuda_device), row_warps=4)
    # and so does a base off 16-byte alignment
    buf = torch.ones(4 * 1600 + 1, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="row_warps"):
        rms_k.rmsnorm_2d(buf[1:].view(4, 1600),
                         torch.ones(1600, device=cuda_device), row_warps=4)


def test_tuned_serve_on_the_card_is_bitwise(cuda_device):
    """A server under tuning -- a tuned grid and non-default launch knobs
    for every batch kernel -- returns the untuned server's results and
    per-request ``apply``/``project``'s, bit for bit, with the tuned
    config in every launch instant."""
    from repro_torch import autotune, obs
    from repro_torch.autotune import cache as tcache
    reqs = workload.mixed_lane_workload(7, 64, max_points=2048)
    untuned = serving.GeometryServer(device=cuda_device)
    for c, p, q in reqs:
        untuned.submit(c, p, qformat=q)
    want = untuned.flush()
    cache = tcache.TuningCache()
    cache.put("serving_grid", "cuda", "float32", 0, tcache.KernelConfig(
        "serving_grid", grid_min_len=16, grid_waste_cap=0.25,
        source="tuned"))
    for kernel, dtype in (("chain_diag_batch", "float32"),
                          ("chain_apply_batch", "float32"),
                          ("chain_project_batch", "float32"),
                          ("chain_diag_batch_q", "q8.7"),
                          ("chain_apply_batch_q", "q8.7")):
        cache.put(kernel, "cuda", dtype, 0, tcache.KernelConfig(
            kernel, block_threads=128, waves=2, source="tuned"))
    tcache.set_cache(cache)
    autotune.set_enabled(True)
    try:
        tuned = serving.GeometryServer(device=cuda_device)
        trc = obs.Tracer()
        with obs.installed(trc):
            for c, p, q in reqs:
                tuned.submit(c, p, qformat=q)
            got = tuned.flush()
        assert (tuned.min_len, tuned.waste_cap) == (16, 0.25)
    finally:
        autotune.set_enabled(None)
        tcache.set_cache(None)
    assert {s.attrs["config"] for s in trc.spans if s.name == "launch"} \
        == {"tuned"}
    for (c, p, q), g, w in zip(reqs, got, want):
        assert _same_bits(np.asarray(g), np.asarray(w))
        if q is None and not c.is_projective:
            assert _same_bits(np.asarray(g),
                              c.apply(p, device=cuda_device).cpu().numpy())
        if c.is_projective:
            assert _same_bits(g.mask, w.mask)


def test_tuners_time_the_kernels_on_the_card(cuda_device):
    """The tuners run on the card through the kernels (the default always
    trial 0) and cache under the ``cuda`` backend."""
    from repro_torch.autotune import search
    from repro_torch.autotune.cache import TuningCache
    cache = TuningCache()
    _build.reset_launch_counts()
    reps = [search.tune_chain("chain_apply", n_points=1 << 16, d=2,
                              cache=cache, iters=2),
            search.tune_chain_batch("chain_diag_batch_q", bsz=8, lpad=4096,
                                    d=3, dtype="q8.7", cache=cache, iters=2),
            search.tune_matmul(m=512, k=512, n=512, cache=cache, iters=2),
            search.tune_rmsnorm(m=1024, n=1600, dtype="bfloat16",
                                cache=cache, iters=2)]
    counts = _build.launch_counts()
    assert counts["chain_matrix_1d"] > 0 and counts["matmul_2d"] > 0
    assert counts["chain_diag_batch_2d_q"] > 0 and counts["rmsnorm_2d"] > 0
    for rep in reps:
        assert rep.backend == "cuda" and len(rep.trials) > 1
        assert rep.trials[0].config.source == "default"
        assert all(t.seconds > 0 for t in rep.trials)
    assert all("|cuda|" in k for k in cache.entries)


# -- the model kernels under autograd (kernels.grad) -----------------------------

def _train_inputs(name, dev, rng):
    """The training micro-batch's shapes (hymba-1.5b, 2 x 2048 tokens):
    (op, kernel, plain, inputs, which require grad, the Function)."""
    from repro_torch.kernels import attention, rmsnorm, rope, ssd_intra, \
        vecadd
    from repro_torch.kernels.affine import ref as affine_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms_k
    from repro_torch.kernels.rope import ref as rope_ref
    from repro_torch.kernels.rope import rope as rope_k
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd import ssd as ssd_k

    def randn(*s, dtype=torch.bfloat16, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dev) * scale).to(dtype)
    if name == "vecadd_2d":
        xs = (randn(4096, 1600), randn(4096, 1600))
        return (vecadd, diag_k.vecadd_2d, affine_ref.vecadd, xs,
                (True, True), "VecAdd")
    if name in ("rmsnorm_2d", "rmsnorm_2d f32"):
        n, dt = (1600, torch.bfloat16) if name == "rmsnorm_2d" \
            else (3200, torch.float32)
        xs = (randn(4096, n, dtype=dt, scale=3.0),
              1.0 + randn(n, dtype=torch.float32, scale=0.1))
        return (lambda x, g: rmsnorm(x, g, eps=1e-5),
                lambda x, g: rms_k.rmsnorm_2d(x, g, eps=1e-5),
                lambda x, g: rms_ref.rmsnorm(x, g, 1e-5), xs, (True, True),
                "RMSNorm")
    if name == "rope_3d":
        cos, sin = (t.to(torch.bfloat16).contiguous() for t in
                    rope_ref.rope_tables(torch.arange(2048, device=dev), 64))
        return (rope, rope_k.rope_3d, rope_ref.rope,
                (randn(50, 2048, 64), cos, sin), (True, False, False),
                "Rope")
    if name == "flash_attention_3d":
        kw = dict(scale=0.125, causal=True, window=1024)
        xs = (randn(2, 25, 2048, 64), randn(2, 5, 2048, 64),
              randn(2, 5, 2048, 64))
        return (lambda q, k, v: attention(q, k, v, window=1024),
                lambda q, k, v: fa_k.flash_attention_3d(
                    q.reshape(50, 2048, 64), k.reshape(10, 2048, 64),
                    v.reshape(10, 2048, 64), **kw).reshape(q.shape),
                lambda q, k, v: fa_ref.autodiff_attention(q, k, v, **kw),
                xs, (True, True, True), "FlashAttention")
    cum = torch.cumsum(-torch.from_numpy(rng.uniform(
        0.001, 0.1, (16, 256, 50)).astype(np.float32)).to(dev), dim=1)
    xs = (randn(16, 256, 50, 64), randn(16, 256, 16), randn(16, 256, 16),
          cum)
    return (ssd_intra, ssd_k.ssd_intra, ssd_ref.ssd_intra, xs,
            (True, True, True, True), "SSDIntra")


@pytest.mark.parametrize("name", ["vecadd_2d", "rmsnorm_2d",
                                  "rmsnorm_2d f32", "rope_3d",
                                  "flash_attention_3d", "ssd_intra"])
def test_grad_function_on_card_at_training_shapes(cuda_device, name):
    """The op on inputs that require grad launches the kernel through its
    ``kernels.grad`` Function: the output equals the kernel's forward
    bit for bit, the ``grad_fn`` is the Function's, one launch and one
    plain backward run, and every input's gradient equals direct
    autograd of the plain version (the Function's backward is that
    vjp) for the same cotangent."""
    from repro_torch.kernels import grad
    rng = np.random.default_rng([27, len(name)])
    op, kernel, plain, inputs, needs, fn = _train_inputs(name, cuda_device,
                                                         rng)
    xs = [x.clone().requires_grad_(n) for x, n in zip(inputs, needs)]
    ys = [x.clone().requires_grad_(n) for x, n in zip(inputs, needs)]
    _build.reset_launch_counts()
    grad.reset_backward_counts()
    got = op(*xs)
    kname = name.split()[0]
    assert _build.launch_counts()[kname] == 1
    with torch.no_grad():
        want_fwd = kernel(*inputs)
    got = got if isinstance(got, tuple) else (got,)
    want_fwd = want_fwd if isinstance(want_fwd, tuple) else (want_fwd,)
    assert type(got[0].grad_fn).__name__ == fn + "Backward"
    assert all(torch.equal(a, b) for a, b in zip(got, want_fwd))
    want = plain(*ys)
    want = want if isinstance(want, tuple) else (want,)
    cots = [torch.randn_like(w) for w in want]
    torch.autograd.backward(got, cots)
    torch.autograd.backward(want, cots)
    assert grad.backward_counts() == {kname: 1}
    for x, y, n in zip(xs, ys, needs):
        if n:
            assert bool(torch.isfinite(x.grad).all())
            assert torch.equal(x.grad, y.grad), name


def test_ops_without_a_backward_raise_on_the_card(cuda_device):
    """A geometry or eager kernel op given a CUDA input that requires
    grad raises (its output would carry no gradient); under no_grad it
    launches."""
    from repro_torch.kernels import affine, matmul
    x = torch.ones(64, 2, device=cuda_device, requires_grad=True)
    for call in (lambda: matmul(x, torch.eye(2, device=cuda_device)),
                 lambda: affine(x, 2.0, 1.0),
                 lambda: chain_diag(x, 2.0, 1.0),
                 lambda: chain_apply(x, torch.eye(2), torch.zeros(2)),
                 lambda: chain_project(
                     torch.ones(64, 3, device=cuda_device,
                                requires_grad=True), torch.eye(4))):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    with torch.no_grad():
        assert matmul(x, torch.eye(2, device=cuda_device)).grad_fn is None


def test_reduced_hymba_train_step_on_card(cuda_device):
    """Reduced hymba's train step through the kernels (remat "dots", two
    micro-batches): the launches and plain backwards of
    ``expected_train_launches``, a finite loss and gradient norm within
    1e-3 relative of the same step on the CPU's plain versions."""
    from repro_torch import configs
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import grad
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_map
    cfg = configs.get("hymba-1.5b").reduced()
    params = build(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(27)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1, 256)))
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=-1)}
    step = make_train_step(build(cfg), AdamWConfig(), 2)
    _, _, cpu = step(params, adamw_init(params), batch)
    dev_params = tree_map(lambda p: p.to(cuda_device), params)
    _build.reset_launch_counts()
    grad.reset_backward_counts()
    _, _, met = step(dev_params, adamw_init(dev_params),
                     {k: v.to(cuda_device) for k, v in batch.items()})
    L = cfg.n_layers
    fwd = {"rmsnorm_2d": 5 * L + 1, "rope_3d": 2 * L,
           "flash_attention_3d": L, "ssd_intra": L, "vecadd_2d": 2 * L}
    counts = _build.launch_counts()
    assert {k: counts[k] for k in fwd} == {
        k: 2 * (2 * v - (k == "rmsnorm_2d")) for k, v in fwd.items()}
    assert grad.backward_counts() == {k: 2 * v for k, v in fwd.items()}
    assert bool(torch.isfinite(met["loss"]))
    for key in ("loss", "grad_norm"):
        a, b = float(met[key]), float(cpu[key])
        assert abs(a - b) <= 1e-3 * abs(b), key


# -- the model kernels on DTensors: a one-rank NCCL mesh -------------------------

def _dtensor_cases(dev):
    """(name, op on plain tensors, its tensor arguments, free dims) of the
    five model kernel ops at small bfloat16 shapes."""
    from repro_torch.kernels import attention, rmsnorm, rope, ssd_intra, \
        vecadd
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    from repro_torch.kernels.rope import ref as rope_ref
    cs, sn = rope_ref.rope_tables(torch.arange(64, device=dev), 64, 10000.0,
                         torch.float32)
    return [
        ("vecadd_2d", lambda a, b: vecadd(a, b), (rand(4, 64, 128),
                                                  rand(4, 64, 128))),
        ("rmsnorm_2d", lambda a, w: rmsnorm(a, w, eps=1e-6),
         (rand(4, 64, 128), rand(128, dtype=torch.float32))),
        ("rope_3d", lambda a: rope(a, cs, sn), (rand(4, 8, 64, 64),)),
        ("flash_attention_3d", lambda q, k, v: attention(q, k, v, causal=True),
         (rand(4, 8, 128, 64), rand(4, 2, 128, 64), rand(4, 2, 128, 64))),
        ("ssd_intra", lambda x, b, c, cum: ssd_intra(x, b, c, cum),
         (rand(8, 64, 4, 64), rand(8, 64, 16), rand(8, 64, 16),
          -torch.rand((8, 64, 4), generator=g, device=dev).cumsum(1))),
    ]


@pytest.mark.parametrize("name", ["vecadd_2d", "rmsnorm_2d", "rope_3d",
                                  "flash_attention_3d", "ssd_intra"])
def test_model_kernel_on_a_dtensor_launches_on_the_local_shard(cuda_device,
                                                              name):
    """On a 1x1 NCCL mesh each model kernel op called on DTensors (batch
    rows on ``data``) launches its kernel on the local shard once and
    gives the plain-tensor call's bits, as a DTensor of the first
    argument's placements; under autograd the plain vjp runs on the
    local shard (one plain backward)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, \
        distribute_tensor
    from repro_torch.kernels import grad
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh()
    _, op, args = next(c for c in _dtensor_cases(cuda_device)
                       if c[0] == name)
    want = op(*args)
    placed = [distribute_tensor(a, mesh, (Shard(0), Replicate())
                                if a.dim() > 1 else (Replicate(),) * 2,
                                src_data_rank=None) for a in args]
    _build.reset_launch_counts()
    got = op(*placed)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == 1
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for o, w in zip(outs, wants):
        assert isinstance(o, DTensor)
        assert tuple(o.placements) == (Shard(0), Replicate())
        assert torch.equal(o.to_local(), w)
    grad.reset_backward_counts()
    leaf = placed[0].detach().requires_grad_(True)
    out = op(leaf, *placed[1:])
    out = out[0] if isinstance(out, tuple) else out
    out.float().sum().backward()
    assert grad.backward_counts() == {name: 1}
    assert isinstance(leaf.grad, DTensor)


@pytest.mark.parametrize("arch, kv", [
    ("hymba-1.5b", "bfloat16"), ("h2o-danube-1.8b", "bfloat16"),
    ("mamba2-130m", "bfloat16"), ("granite-moe-3b-a800m", "bfloat16"),
    ("granite-moe-3b-a800m", "int8"), ("whisper-medium", "bfloat16"),
    ("internvl2-76b", "bfloat16")])
def test_compiled_serve_is_bitwise_the_eager_serve_on_card(cuda_device, arch,
                                                           kv):
    """The compiled serve step (CUDA graphs of ``Model.prefill`` and
    ``Model.decode``) of each reduced family: its first serve captures,
    and its tokens, every step's logits and its kernel launches equal
    the ``eager=True`` serve's; a second serve of the same key replays
    without a capture and gives the same bits and launches again, with
    no synchronising call in its replays; each decode step launches the
    same sizes at every position."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.serve import release_graphs, serve_batch
    from repro_torch.models import build
    cfg = dataclasses.replace(configs.get(arch).reduced(), kv_cache_dtype=kv)
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompts = np.random.default_rng(68).integers(0, cfg.vocab_size, (4, 40))
    runs = []
    for eager in (True, False, False):
        _build.reset_launch_counts()
        trace = {}
        toks = serve_batch(cfg, params, prompts, gen_tokens=6, model=model,
                           trace=trace, eager=eager,
                           sync_debug=None if eager else "error")
        runs.append((toks, trace, _build.launch_counts()))
    (te, eager, ce), (t1, first, c1), (t2, second, c2) = runs
    assert eager["step"] == "eager"
    assert first["step"] == second["step"] == "cuda graph"
    assert first["capture_ms"] is not None and second["capture_ms"] is None
    assert len(model.serve_graphs) == 1
    for toks, trace, counts in runs[1:]:
        assert np.array_equal(toks, te) and counts == ce
        assert trace["launches_prefill"] == eager["launches_prefill"]
        assert all(torch.equal(a, b)
                   for a, b in zip(trace["logits"], eager["logits"]))
        assert all(s == eager["decode_sizes"][0]
                   for s in trace["decode_sizes"] + eager["decode_sizes"])
    assert sum(ce.values()) > 0
    release_graphs(model)
    assert not model.serve_graphs


@pytest.mark.parametrize("arch, batch, prompt", [
    ("hymba-1.5b", 32, 1024), ("granite-moe-3b-a800m", 8, 1536)])
def test_layer_spans_in_graphs_keep_the_tokens_and_cover_each_replay(
        cuda_device, arch, batch, prompt):
    """With an ``obs.Tracer`` installed the compiled serve captures graphs
    of their own key whose event-record nodes time the layer spans:
    their tokens are bit for bit the plain graphs' (twice: the capture's
    serve and a serve of replays only), and in every replay of the decode
    step the top-level spans (``embed``, the ``layer``s, ``head``,
    ``greedy``) cover at least 97 % of the time from its first event to
    its last.  Four layers at the published widths, with a benchmark
    cell's batch and one of its prompt lengths: a reduced model's decode
    step takes under a millisecond, where the event nodes' own few µs
    and a single launch bubble can be a tenth of it."""
    import dataclasses
    from repro_torch import configs, obs
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    from repro_torch.obs import steps
    cfg = dataclasses.replace(configs.get(arch), n_layers=4)
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(1))
    prompts = np.random.default_rng(69).integers(0, cfg.vocab_size,
                                                 (batch, prompt))
    plain = [serve_batch(cfg, params, prompts, gen_tokens=8, model=model)
             for _ in range(2)]
    trc = obs.Tracer()
    with obs.installed(trc):
        spanned = [serve_batch(cfg, params, prompts, gen_tokens=8,
                               model=model) for _ in range(2)]
    assert all(np.array_equal(t, plain[0]) for t in plain + spanned)
    assert sorted(key[-2] for key in model.serve_graphs) == [False, True]
    replays = steps.summary(trc)[("decode", prompt, True)]
    assert replays["steps"] == 7 + 8
    assert replays["top_share"] >= 0.97, replays


# -- the compiled train step (one CUDA graph of forward, backward, AdamW) --------

def _local(t):
    """A tensor's copy; a DTensor's local shard's."""
    from repro_torch.distributed import sharding
    return (t.to_local() if sharding.is_dtensor(t) else t).clone()


def _train_run(cfg, eager: bool, steps: int = 3, mesh=None) -> dict:
    """``train_loop`` of ``steps`` steps of ``cfg`` on the card (on
    ``mesh`` if given), 4 rows of 64 tokens, 2 micro-batches: each step's
    loss, gradient norm, parameters and optimizer leaves (copies of the
    local shards), launches and plain backwards, and the trace."""
    from repro_torch.kernels import grad
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    rows = []

    def on_step(i, metrics):
        torch.cuda.synchronize()
        rows.append({
            "loss": metrics["loss"], "grad_norm": _local(metrics["grad_norm"]),
            "params": [_local(t) for t in leaves(metrics["params"])],
            "opt": [_local(t) if isinstance(t, torch.Tensor) else t
                    for t in leaves(metrics["opt_state"])],
            "launches": {k: v for k, v in _build.launch_counts().items() if v},
            "backwards": grad.backward_counts()})
        _build.reset_launch_counts()
        grad.reset_backward_counts()
    _build.reset_launch_counts()
    grad.reset_backward_counts()
    trace = {}
    train_loop(cfg, steps=steps, global_batch=4, seq_len=64,
               micro_per_shard=2, opt_cfg=AdamWConfig(total_steps=steps,
                                                      warmup_steps=2),
               device="cuda", on_step=on_step, log_every=100, eager=eager,
               trace=trace, sync_debug=None if eager else "error", mesh=mesh)
    return {"rows": rows, "trace": trace}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-moe-3b-a800m",
                                  "whisper-medium"])
def test_compiled_train_loop_is_bitwise_the_eager_loop_on_card(cuda_device,
                                                               arch):
    """Three steps of the reduced hybrid, MoE and enc-dec models: the
    compiled loop (step 1 eager over the static buffers, a capture, two
    replays with no synchronising call in their enqueue) gives every
    step's loss, gradient norm, parameters and optimizer leaves bit for
    bit the ``eager=True`` loop's, and the same launches and plain
    backwards at every step, replays included; hymba's are
    ``expected_train_launches``' counts."""
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(arch).reduced(), remat="dots")
    eager, compiled = _train_run(cfg, True), _train_run(cfg, False)
    _same_steps(eager, compiled)
    if cfg.family == "hybrid":
        L = cfg.n_layers
        fwd = {"rmsnorm_2d": 5 * L + 1, "rope_3d": 2 * L,
               "flash_attention_3d": L, "ssd_intra": L, "vecadd_2d": 2 * L}
        for row in compiled["rows"]:
            assert row["launches"] == {k: 2 * (2 * v - (k == "rmsnorm_2d"))
                                       for k, v in fwd.items()}
            assert row["backwards"] == {k: 2 * v for k, v in fwd.items()}


def _same_steps(eager: dict, compiled: dict) -> None:
    """The compiled loop's run (``_train_run``) is the eager loop's bit
    for bit at every step, launches and plain backwards included."""
    assert eager["trace"]["step"] == "eager"
    assert compiled["trace"]["step"] == "cuda graph"
    assert compiled["trace"]["capture_ms"] is not None
    assert len(compiled["trace"]["replay_us"]) == 2
    for a, b in zip(eager["rows"], compiled["rows"]):
        assert a["loss"] == b["loss"]
        assert torch.equal(a["grad_norm"], b["grad_norm"])
        assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(a["opt"], b["opt"]))
        assert a["launches"] == b["launches"] and a["launches"]
        assert a["backwards"] == b["backwards"]


def _serve_twice_around(cfg, model, params, step) -> tuple:
    """Serve, ``step()``, serve again (compiled, 4 prompts of 40 tokens, 6
    tokens): (both traces, ``memory_allocated`` after each serve, the
    second's tokens and an ``eager=True`` serve's on the parameters
    then)."""
    from repro_torch.launch.serve import serve_batch
    prompts = np.random.default_rng(69).integers(0, cfg.vocab_size, (4, 40))
    traces, mem = [{}, {}], []
    serve_batch(cfg, params(), prompts, gen_tokens=6, model=model,
                trace=traces[0])
    del traces[0]["logits"]
    torch.cuda.synchronize()
    mem.append(torch.cuda.memory_allocated())
    step()
    toks = serve_batch(cfg, params(), prompts, gen_tokens=6, model=model,
                       trace=traces[1])
    del traces[1]["logits"]
    torch.cuda.synchronize()
    mem.append(torch.cuda.memory_allocated())
    want = serve_batch(cfg, params(), prompts, gen_tokens=6, model=model,
                       eager=True)
    return traces, mem, toks, want


def test_serve_after_eager_train_steps_keeps_memory_flat(cuda_device):
    """Serving between two functional train steps (new parameter tensors
    each step) releases the first compiled serve before capturing the
    second: one entry a shape key, ``memory_allocated`` after the second
    serve within 1 % of after the first, and the tokens the ``eager=True``
    serve's."""
    from repro_torch import configs
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = configs.get("hymba-1.5b").reduced()
    model = build(cfg)
    st = {"params": model.init(torch.Generator(cuda_device).manual_seed(0))}
    st["opt"] = adamw_init(st["params"])
    rng = np.random.default_rng(70)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, 64)))
    batch = {"tokens": toks.to(cuda_device),
             "labels": toks.roll(-1, dims=-1).to(cuda_device)}
    step_fn = make_train_step(model, AdamWConfig(), 2)

    def step():
        st["params"], st["opt"], _ = step_fn(st["params"], st["opt"], batch)
    step()
    traces, mem, got, want = _serve_twice_around(
        cfg, model, lambda: st["params"], step)
    assert traces[0]["capture_ms"] is not None
    assert traces[1]["capture_ms"] is not None     # new tensors: captured
    assert len(model.serve_graphs) == 1
    assert abs(mem[1] - mem[0]) <= 0.01 * mem[0], mem
    assert np.array_equal(got, want)


def test_serve_after_a_compiled_train_step_hits_its_key(cuda_device):
    """The compiled train step updates the parameters in place, so a serve
    after a replayed step finds its key and replays without a capture,
    reads the new values (its tokens the ``eager=True`` serve's on them)
    and leaves ``memory_allocated`` within 1 % of after the first serve."""
    from repro_torch import configs
    from repro_torch.launch.train import CompiledTrain
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves
    cfg = configs.get("hymba-1.5b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator(cuda_device).manual_seed(1))
    rng = np.random.default_rng(71)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, 64)))
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=-1)}
    ct = CompiledTrain(model, AdamWConfig(total_steps=4, warmup_steps=1), 2,
                       params, adamw_init(params))
    ct.load(batch)
    ct.run()
    ct.capture()
    host_us = []

    def step():
        ct.load(batch)
        ct.replay(host_us)
    step()
    before = [t.clone() for t in leaves(ct.params)]
    traces, mem, got, want = _serve_twice_around(cfg, model,
                                                 lambda: ct.params, step)
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, leaves(ct.params)))
    assert traces[0]["capture_ms"] is not None
    assert traces[1]["capture_ms"] is None and traces[1]["step"] == \
        "cuda graph"
    assert len(model.serve_graphs) == 1 and len(host_us) == 2
    assert abs(mem[1] - mem[0]) <= 0.01 * mem[0], mem
    assert np.array_equal(got, want)


# -- the compiled mesh step: one-rank NCCL groups ---------------------------------

def test_functional_collectives_replay_in_a_cuda_graph_on_nccl(cuda_device):
    """``funcol.all_reduce`` and ``all_gather_tensor`` called directly on
    the size-1 groups of a 1x1 NCCL mesh (which ``reduce_on_model`` and
    the rest skip): run once on a side stream (the communicators'
    warm-up), captured into a CUDA graph on it, and replayed on new
    values of their input, with no synchronising call in the replay:
    the values right after it, and no work left unwaited."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.distributed.sharding import _wait
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import sync_debug_mode
    mesh = make_local_mesh()
    assert all(dist.get_backend(mesh.get_group(i)) == "nccl"
               for i in range(mesh.ndim))
    x = torch.arange(8, dtype=torch.float32, device=cuda_device)

    def step():
        return (_wait(funcol.all_reduce(x * 2, "sum", (mesh, 1))),
                _wait(funcol.all_gather_tensor(x + 1, 0, (mesh, 0))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a, b = step()
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(a, x * 2) and torch.equal(b, x + 1)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        a, b = step()
    x.copy_(torch.arange(8, dtype=torch.float32, device=cuda_device) * 3)
    with sync_debug_mode("error"):
        g.replay()
    torch.cuda.synchronize()
    assert torch.equal(a, x * 2) and torch.equal(b, x + 1)
    assert torch._C._distributed_c10d._get_work_registry_size() == 0


@pytest.mark.parametrize("arch, placed", [
    ("hymba-1.5b", True), ("granite-moe-3b-a800m", True),
    ("granite-moe-3b-a800m", False), ("whisper-medium", True)])
def test_compiled_mesh_serve_is_bitwise_the_eager_mesh_serve_on_card(
        cuda_device, arch, placed):
    """``serve_batch`` under ``mesh_context`` of a 1x1 NCCL mesh, with the
    parameters placed by ``params_specs`` (or plain, the MoE mesh path
    alone): the compiled route (its first serve captures, its second
    replays without a capture, no synchronising call in their replays)
    gives the ``eager=True`` mesh serve's tokens, every step's logits,
    launches and decode sizes bit for bit; one graph entry, keyed by the
    mesh's shape and dimension names."""
    from repro_torch import configs
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.mesh import make_local_mesh, mesh_context
    from repro_torch.launch.serve import release_graphs, serve_batch
    from repro_torch.models import build
    cfg = configs.get(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    mesh = make_local_mesh()
    if placed:
        params = elastic.place(params, mesh,
                               sharding.params_specs(params, mesh))
    prompts = np.random.default_rng(72).integers(0, cfg.vocab_size, (4, 40))
    runs = []
    with mesh_context(mesh):
        for eager in (True, False, False):
            _build.reset_launch_counts()
            trace = {}
            toks = serve_batch(cfg, params, prompts, gen_tokens=6,
                               model=model, trace=trace, eager=eager,
                               sync_debug=None if eager else "error")
            torch.cuda.synchronize()
            runs.append((toks, trace, _build.launch_counts()))
    (te, eager, ce), (_, first, _), (_, second, _) = runs
    assert eager["step"] == "eager"
    assert first["step"] == second["step"] == "cuda graph"
    assert first["capture_ms"] is not None and second["capture_ms"] is None
    for toks, trace, counts in runs[1:]:
        assert np.array_equal(toks, te) and counts == ce
        assert trace["launches_prefill"] == eager["launches_prefill"]
        assert all(torch.equal(_local(a), _local(b))
                   for a, b in zip(trace["logits"], eager["logits"]))
        assert trace["decode_sizes"] == eager["decode_sizes"]
    assert sum(ce.values()) > 0
    (key,) = model.serve_graphs
    assert key[-1] == ((1, 1), ("data", "model"))
    release_graphs(model)


def test_compiled_serve_of_dtensor_parameters_needs_the_ambient_mesh(
        cuda_device):
    """``serve_batch`` of parameters placed on a 1x1 NCCL mesh with no
    ``mesh_context``: the compiled route, which places its buffers on the
    ambient mesh, raises and keeps no graphs; under ``mesh_context`` the
    compiled serve gives the eager mesh serve's tokens."""
    from repro_torch import configs
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch.mesh import make_local_mesh, mesh_context
    from repro_torch.launch.serve import release_graphs, serve_batch
    from repro_torch.models import build
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    mesh = make_local_mesh()
    params = elastic.place(params, mesh, sharding.params_specs(params, mesh))
    prompts = np.random.default_rng(74).integers(0, cfg.vocab_size, (2, 16))
    with pytest.raises(ValueError, match="mesh_context"):
        serve_batch(cfg, params, prompts, gen_tokens=3, model=model)
    assert not model.serve_graphs
    trace = {}
    with mesh_context(mesh):
        want = serve_batch(cfg, params, prompts, gen_tokens=3, model=model,
                           eager=True)
        got = serve_batch(cfg, params, prompts, gen_tokens=3, model=model,
                          trace=trace)
    assert want.shape == (2, 3)
    assert trace["step"] == "cuda graph" and np.array_equal(got, want)
    release_graphs(model)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-moe-3b-a800m"])
def test_compiled_mesh_train_loop_is_bitwise_the_eager_mesh_loop_on_card(
        cuda_device, arch):
    """Three ``train_loop`` steps of the reduced hybrid and MoE models on
    a 1x1 NCCL mesh: the compiled route (step 1 eager over DTensor
    buffers, a capture, two replays with no synchronising call in their
    enqueue) gives every step's loss, gradient norm, parameters and
    optimizer leaves bit for bit the ``eager=True`` mesh loop's, and the
    same launches and plain backwards at every step, replays
    included."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    cfg = dataclasses.replace(configs.get(arch).reduced(), remat="dots")
    mesh = make_local_mesh()
    _same_steps(_train_run(cfg, True, mesh=mesh),
                _train_run(cfg, False, mesh=mesh))


def test_a_failed_mesh_capture_raises_and_serves_nothing_eagerly(
        cuda_device, monkeypatch):
    """A host read planted in the serve step under capture (the greedy
    pick reads its logits' sum while the stream captures) on a 1x1 NCCL
    mesh: ``serve_batch`` raises and returns no eager result; the card
    serves again once the read is gone.  Last in the file: the failed
    capture leaves its stream's capture aborted."""
    from repro_torch import configs
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh, mesh_context
    from repro_torch.models import build
    cfg = configs.get("granite-moe-3b-a800m").reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    mesh = make_local_mesh()
    params = elastic.place(params, mesh, sharding.params_specs(params, mesh))
    prompts = np.random.default_rng(73).integers(0, cfg.vocab_size, (2, 16))
    greedy = serve.greedy

    def reading(logits):
        if torch.cuda.is_current_stream_capturing():
            float(_local(logits).sum())
        return greedy(logits)
    monkeypatch.setattr(serve, "greedy", reading)
    trace = {}
    with mesh_context(mesh), pytest.raises(RuntimeError):
        serve.serve_batch(cfg, params, prompts, gen_tokens=3, model=model,
                          trace=trace)
    assert "step" not in trace
    monkeypatch.setattr(serve, "greedy", greedy)
    serve.release_graphs(model)
    torch.cuda.synchronize()
    with mesh_context(mesh):
        want = serve.serve_batch(cfg, params, prompts, gen_tokens=3,
                                 model=model, eager=True)
        got = serve.serve_batch(cfg, params, prompts, gen_tokens=3,
                                model=model, trace=trace)
    assert trace["step"] == "cuda graph" and np.array_equal(got, want)
    serve.release_graphs(model)

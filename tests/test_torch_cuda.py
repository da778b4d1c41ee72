"""The port on the card: every CUDA kernel bitwise equal to its plain
PyTorch version on the GPU and on the CPU (the projective kernels' masks
included; the int16 Qm.n kernels at full-range inputs, where the int32
accumulator and the int16 store wrap, and at n_frac 0, 7 and 15; the
eager ``affine_2d``/``vecadd_2d``/``matmul_2d`` in float32 and bfloat16),
the launch counters, and the GPU server bitwise equal to the CPU server,
to the plain path and to per-request ``apply``/``project``.

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
    multiply and add a step) on the card and on the CPU, bit for bit, at
    ragged edges, K past one panel, K = 0 and the rotate shape."""
    rng = np.random.default_rng([52, dtype == torch.bfloat16, out == "bfloat16"])
    out_dtype = getattr(torch, out)
    for m, k, n in ((17, 100, 33), (1, 8, 1), (1, 1, 1), (65, 17, 63),
                    (130, 1024, 70), (1 << 16, 2, 2), (3000, 3, 3),
                    (5, 0, 4)):
        x = _dense(rng, (m, k), dtype, cuda_device)
        y = _dense(rng, (k, n), dtype, cuda_device)
        got = matrix_k.matmul_2d(x, y, out_dtype=out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        for want in (matrix_ref.matmul(x, y, out_dtype),
                     matrix_ref.matmul(x.cpu(), y.cpu(), out_dtype)):
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

"""The port on the card: every CUDA kernel bitwise equal to its plain
PyTorch version on the GPU and on the CPU, the launch counters, and the
GPU server bitwise equal to the CPU server and to the plain path.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither jax nor the JAX package, so it also runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed these tests skip
torch = pytest.importorskip("torch")

from repro_torch import serving
from repro_torch.kernels import _build, chain_apply, chain_apply_batch, \
    chain_diag, chain_diag_batch
from repro_torch.kernels.affine import affine as diag_k
from repro_torch.kernels.affine import ref as diag_ref
from repro_torch.kernels.matmul import matmul as matrix_k
from repro_torch.kernels.matmul import ref as matrix_ref
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
    counts = _build.launch_counts()
    assert counts["chain_diag_1d"] == 1 and counts["chain_matrix_1d"] == 1
    assert counts["chain_diag_batch_2d"] == counts["chain_matrix_batch_2d"] == 0
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

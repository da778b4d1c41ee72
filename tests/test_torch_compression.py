"""Gradient compression of the port against the JAX package's.

``quantize_int8``/``dequantize_int8`` bitwise equal to the reference's
(float32 and bfloat16 gradients, with error feedback), the reference's
convergence and round-trip tests ported, and ``pod_sync_int8`` on a
2-rank gloo world, mesh (2, 1, 1) with each pod its own gradients,
bitwise equal to the reference's on a (2, 1, 1) host mesh (its
subprocess has 8 host devices and gives each pod device its own block).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a) -> bytes:
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_bitwise_equal_the_reference(seed, dtype):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((64, 33)) * 10.0 ** rng.integers(-4, 2)
         ).astype(np.float32)
    err = (rng.standard_normal((64, 33)) * 1e-4).astype(np.float32)
    gt = torch.from_numpy(g).to(getattr(torch, dtype))
    gj = jnp.asarray(gt.float().numpy()).astype(getattr(jnp, dtype))
    q, s, e = compression.quantize_int8(gt, torch.from_numpy(err))
    jq, js, je = jcomp.quantize_int8(gj, jnp.asarray(err))
    assert q.dtype == torch.int8 and s.dtype == e.dtype == torch.float32
    assert _bits(q.numpy()) == _bits(jq)
    assert _bits(s.numpy()) == _bits(js)
    assert _bits(e.numpy()) == _bits(je)
    d, jd = compression.dequantize_int8(q, s), jcomp.dequantize_int8(jq, js)
    assert _bits(d.numpy()) == _bits(jd)


def test_int8_error_feedback_converges():
    """The reference's test: the same gradient repeatedly, the mean of
    the dequantized words within 2 % of its largest magnitude."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(256).astype(np.float32)) * 1e-3
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, scale, err = compression.quantize_int8(g, err)
        acc = acc + q.float() * scale
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(),
                               atol=float(g.abs().max()) * 0.02)


def test_quantize_roundtrip_bounded():
    g = torch.linspace(-1, 1, 100)
    q, scale, err = compression.quantize_int8(g, torch.zeros_like(g))
    assert q.dtype == torch.int8
    deq = compression.dequantize_int8(q, scale)
    np.testing.assert_allclose(deq.numpy(), g.numpy(), atol=0.01)
    np.testing.assert_allclose((g - deq).numpy(), err.numpy(), atol=1e-7)


def test_init_error_state_and_no_pod_axis():
    g = {"w": torch.ones(3, 4, dtype=torch.bfloat16), "b": torch.ones(4)}
    err = compression.init_error_state(g)
    assert all(e.dtype == torch.float32 and not e.any()
               for e in err.values())
    from repro_torch.launch import dryrun
    mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
    out, new_err = compression.pod_sync_int8(g, err, mesh)
    assert out is g and new_err is err


_REFERENCE = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.compression import init_error_state, pod_sync_int8
from repro.launch.mesh import make_mesh
GRADS = %(grads)s
mesh = make_mesh((2, 1, 1), ("pod", "data", "model"),
                 devices=jax.devices()[:2])
devs = list(mesh.devices.flat)

def per_pod(blocks):
    arrs = [jax.device_put(np.asarray(b, np.float32), d)
            for b, d in zip(blocks, devs)]
    return jax.make_array_from_single_device_arrays(
        arrs[0].shape, NamedSharding(mesh, P()), arrs)

grads = {k: per_pod([GRADS[0][k], GRADS[1][k]]) for k in GRADS[0]}
err = init_error_state(grads)
specs = {k: P() for k in grads}
out, new_err = pod_sync_int8(grads, err, mesh, specs)
res = {}
for k in out:
    res[k] = [np.asarray(s.data).tolist() for s in
              sorted(out[k].addressable_shards, key=lambda s: s.device.id)]
    res["err/" + k] = [np.asarray(s.data).tolist() for s in sorted(
        new_err[k].addressable_shards, key=lambda s: s.device.id)]
print(json.dumps(res))
"""


def test_pod_sync_int8_bitwise_equals_the_reference(tmp_path):
    rng = np.random.default_rng(7)
    grads = [{"w": rng.standard_normal((8, 6)).astype(np.float32),
              "b": (rng.standard_normal(5) * 1e-3).astype(np.float32)}
             for _ in range(2)]
    code = _REFERENCE % {"grads": repr([{k: v.tolist() for k, v in
                                          g.items()} for g in grads])}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    got, got_err = torch_dist.spawn("pod_sync", 2, tmp_path, grads,
                                    (2, 1, 1), deadline=120)
    for k in ("w", "b"):
        # rank 0 holds pod 0's block: the synced values on every pod, its
        # own error feedback
        want = np.asarray(ref[k][0], np.float32)
        assert _bits(got[k]) == _bits(want)
        assert _bits(np.asarray(ref[k][1], np.float32)) == _bits(want)
        assert _bits(got_err[k]) == _bits(np.asarray(ref["err/" + k][0],
                                                     np.float32))

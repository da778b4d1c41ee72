"""Mesh factories, the port of the JAX package's ``launch/mesh.py``:
functions, never module-level state -- importing this module touches no
process group.

The port runs SPMD, one process a device, started by ``torchrun``.  A
mesh is an ``init_device_mesh`` over the current world; when no process
group exists, ``ensure_process_group`` starts one from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``...) or else as a
world of 1 on a ``HashStore``, with ``nccl`` on the card and ``gloo`` on
the CPU and an explicit timeout.  ``mesh_context`` sets the ambient mesh
that ``sharding.ambient_mesh()`` returns, as ``jax.sharding.set_mesh``.
``compiled_route`` is the one rule both launchers follow to choose
between their CUDA graphs and their eager step.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import mesh_context

__all__ = ["compiled_route", "ensure_process_group", "make_local_mesh",
           "make_mesh", "make_production_mesh", "mesh_context",
           "world_device"]

#: the timeout every process group of the port is started with
TIMEOUT = datetime.timedelta(seconds=60)


def world_device() -> str:
    """The device type the world's ranks compute on: ``cuda`` when the
    process group's backend is ``nccl``, else ``cpu``."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def compiled_route(params, mesh, eager: bool) -> bool:
    """Whether a launcher runs its step as replays of CUDA graphs
    (``launch.serve.CompiledServe``, ``launch.train.CompiledTrain``), the
    port of the reference's ``jax.jit``: the parameters on the card,
    ``eager`` false, and no mesh or a mesh whose every dimension's group
    is ``nccl``.  A capture records the kernels that DTensor's host-side
    dispatch enqueues and NCCL's collectives, which run on the card's
    streams; gloo runs its collectives on the host, where no graph sees
    them, so a gloo mesh (the CPU's, two ranks sharing one card) stays
    eager, as do the CPU and ``eager=True``."""
    if eager or params["embed"].device.type != "cuda":
        return False
    return mesh is None or all(dist.get_backend(mesh.get_group(i)) == "nccl"
                               for i in range(mesh.ndim))


def ensure_process_group(backend: str | None = None,
                         timeout: datetime.timedelta = TIMEOUT) -> None:
    """Start the default process group unless one exists: from
    ``torchrun``'s environment when it set ``WORLD_SIZE``, else a world
    of 1 on a ``HashStore``; ``nccl`` when CUDA is available (the rank's
    card is ``LOCAL_RANK``), ``gloo`` otherwise."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def make_mesh(shape, axes, *, devices: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current world
    (``devices``: the device type, by default the world's)."""
    ensure_process_group()
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(devices or world_device(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; 2x16x16 = 512 ranks across two pods
    (raises on a smaller world)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ensure_process_group()
    need = 512 if multi_pod else 256
    if dist.get_world_size() != need:
        raise ValueError(f"the {'multipod' if multi_pod else 'production'} "
                         f"mesh needs {need} ranks, the world has "
                         f"{dist.get_world_size()}")
    return make_mesh(shape, axes)


def make_local_mesh(model_axis: int = 1):
    """A ``("data", "model")`` mesh over the launched world."""
    ensure_process_group()
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {n}")
    return make_mesh((n // model_axis, model_axis), ("data", "model"))

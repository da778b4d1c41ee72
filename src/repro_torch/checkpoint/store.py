"""Fault-tolerant checkpointing: an atomic npz archive plus a manifest,
the port of the JAX package's ``checkpoint/store.py``.

Protocol (restart-safe by construction):
  1. the arrays are written to ``step_<k>.tmp/arrays.npz``,
  2. ``manifest.json`` (tree paths, signature, step, wall time) is
     written last,
  3. the directory is atomically renamed to ``step_<k>/`` -- a
     checkpoint without a completed rename never existed.

``latest_step`` only returns fully renamed checkpoints, so a job killed
mid-save restarts from the previous good step.  A tree is nested dicts
(their keys sorted, as the JAX package flattens them), lists and tuples
of tensors, numpy arrays or Python numbers; a leaf's path names every
step, as in ``[0]['layers'][3]['attn']['wq']`` -- the port's lists of
per-layer dicts by index.  Restoration is template-based: the caller
passes a tree of the right structure (``Model.init``'s parameters and
``adamw_init``'s state) and each array comes back with its template
leaf's dtype, shape and device, after the manifest's paths are held
against the template's (a structure check).  bfloat16 arrays, which npz
cannot hold, are saved widened to float32 (lossless) and narrowed back
on restore.  Async saves run on a daemon thread; the device-to-host
copy happens on the caller's thread, so the step's tensors are
snapshotted before the next step replaces them.

A sharded run's tree holds DTensors: every rank gathers each full tensor
(``full_tensor``), rank 0 alone writes, and the ranks meet at a barrier
once the write is done (``CheckpointManager.wait``).  The checkpoint is
therefore mesh-independent, as the reference's full host arrays are: a
run resumes on another mesh by loading full arrays and re-placing them
(``distributed.elastic.place``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor


def _tree_items(tree, path: str = "") -> list:
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in _tree_items(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in _tree_items(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(template, leaves):
    if isinstance(template, dict):   # leaves in sorted order, keys in its
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _host(v) -> np.ndarray:
    """A leaf as a numpy array on the host (bfloat16 widened to float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _snapshot(v):
    """A leaf copied to the host, its dtype kept; a DTensor's full tensor
    (a collective: every rank of its mesh takes part)."""
    if isinstance(v, torch.Tensor):
        if is_dtensor(v):
            v = v.full_tensor()
        return v.detach().to("cpu", copy=True)
    return np.array(v) if isinstance(v, np.ndarray) else v


def _rank_of(tree) -> int | None:
    """This process's rank when ``tree`` holds DTensors (a sharded run),
    else None."""
    if any(is_dtensor(v) for _, v in _tree_items(tree)):
        import torch.distributed as dist
        return dist.get_rank()
    return None


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


def _signature(tree) -> str:
    items = [(k, tuple(np.shape(v)), _dtype_name(v))
             for k, v in _tree_items(tree)]
    return hashlib.sha256(json.dumps(items, sort_keys=True).encode()
                          ).hexdigest()


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3,
                    extra: dict | None = None) -> str:
    """Write ``tree`` as step ``step`` of ``directory`` by the protocol
    above, then keep only the newest ``keep`` checkpoints.  Returns the
    checkpoint's directory."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step:09d}.tmp")
    final = os.path.join(directory, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    items = _tree_items(tree)
    arrays = {f"a{i:05d}": _host(v) for i, (_, v) in enumerate(items)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": [k for k, _ in items],
        "signature": _signature(tree),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic commit
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def _list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return out


def latest_step(directory: str) -> int | None:
    """The newest complete checkpoint's step, None if there is none."""
    steps = _list_steps(directory)
    return max(steps) if steps else None


def _restore(a: np.ndarray, t):
    if isinstance(t, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=t.device, dtype=t.dtype).reshape(t.shape)
    if isinstance(t, np.ndarray):
        return np.asarray(a, dtype=t.dtype).reshape(t.shape)
    return type(t)(a)


def load_checkpoint(directory: str, template, step: int | None = None):
    """Restore a ``template``-structured tree (the newest checkpoint
    unless ``step`` is given).  Returns (tree, step); raises
    ``ValueError`` when the checkpoint's tree paths are not the
    template's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    items = _tree_items(template)
    if manifest["keys"] != [k for k, _ in items]:
        raise ValueError("checkpoint tree structure does not match template")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        restored = [_restore(data[f"a{i:05d}"], t)
                    for i, (_, t) in enumerate(items)]
    return _unflatten(template, iter(restored)), step


class CheckpointManager:
    """Periodic and async checkpointing with bounded retention."""

    def __init__(self, directory: str, *, interval: int = 100, keep: int = 3):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._rank: int | None = None

    def maybe_save(self, step: int, tree, *, blocking: bool = False,
                   extra: dict | None = None) -> bool:
        """Save ``tree`` as step ``step`` when ``step`` is a multiple of
        the interval (after the previous async save ends); the copy to
        the host happens here, the write on a daemon thread unless
        ``blocking``.  ``tree`` may be live tensors that the next step
        overwrites in place (``launch.train``'s compiled step donates
        the parameters and the optimizer state): the snapshot is taken
        before this returns, so the saved step is this one.  Returns
        whether it saved."""
        if step % self.interval:
            return False
        self.wait()
        # snapshot on the caller's thread: the next step overwrites the
        # tensors in place (the compiled step) or replaces them
        host_tree = _unflatten(tree, iter(_snapshot(v)
                                          for _, v in _tree_items(tree)))
        self._rank = _rank_of(tree)
        if self._rank not in (None, 0):   # a sharded run: rank 0 writes
            return True
        if blocking:
            save_checkpoint(self.directory, step, host_tree, keep=self.keep,
                            extra=extra)
            return True
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.directory, step, host_tree),
            kwargs=dict(keep=self.keep, extra=extra), daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        """Block until the pending async save, if any, is written (in a
        sharded run every rank then meets at a barrier, so none reads a
        checkpoint before rank 0 has written it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._rank is not None:
            import torch.distributed as dist
            dist.barrier()
            self._rank = None

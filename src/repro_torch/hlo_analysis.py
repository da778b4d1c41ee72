"""Per-device cost analysis of a traced step, the counterpart of the JAX
package's ``hlo_analysis.py`` (the name is kept so the two packages
mirror each other): the same ``analyze`` contract -- ``flops``,
``hbm_bytes``, ``collective_bytes`` and ``collective_counts`` by kind --
read from the torch dispatcher's local ops, not from XLA HLO (the port
compiles nothing).

``DispatchTrace`` is a ``TorchDispatchMode``.  Under DTensor every op is
dispatched twice: once on the DTensors (the global view) and once on
each rank's local tensors.  Counting both would add the global count to
the per-device one; the trace hands a DTensor op back to DTensor
(``NotImplemented``) and counts only the local ops its dispatch runs,
which are per device -- not the global-shaped fake runs by which DTensor
infers an op's output shape.  With ``FakeTensorMode`` and a fake process
group nothing is allocated or sent: the counts come from shapes alone.

  * ``flops``: 2 * prod(out) * prod(contracted) over ``mm``, ``bmm``,
    ``addmm``, ``baddbmm`` and convolutions, as the reference counts
    dots and convolutions;
  * ``hbm_bytes``: the input and output bytes of every op that is not a
    view.  The trace is eager and unfused, so this is an upper count by
    design, with no parity to XLA's count of fused materialisations;
  * ``collective_bytes``/``collective_counts``: the operand bytes and
    calls of each ``_c10d_functional`` collective, by the reference's
    kind names;
  * live bytes: every storage an op creates is held from its creation
    until it is freed, and the peak is kept (``peak_bytes``), the
    dry-run's ``temps``.

Loops: ``repeat(n)`` multiplies what is counted inside by ``n`` (a train
cell's accumulation loop traced once, the counterpart of XLA's
``known_trip_count``).
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

#: the functional collectives by packet name, to the reference's kinds
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_CONVS = {"convolution", "_convolution"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _dot_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm"):
        a = args[0]
    elif name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        return 0.0
    return 2.0 * _prod(out.shape) * int(a.shape[-1])


def _conv_flops(args, out) -> float:
    w = args[1]                          # (out_ch, in_ch / groups, *kernel)
    return 2.0 * _prod(out.shape) * _prod(w.shape[1:])


class DispatchTrace(TorchDispatchMode):
    """Count a step's per-device FLOPs, bytes, collectives and live
    memory (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.mult = 1.0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = {k: 0.0 for k in COLLECTIVES}
        self.collective_counts = {k: 0.0 for k in COLLECTIVES}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: weakref.WeakSet = weakref.WeakSet()
        self._paused = 0
        self._unpatch = None

    def __enter__(self):
        # DTensor infers an op's global output shape by running the op on
        # global-shaped fake tensors; those runs come through this mode
        # too and are no device's work: they are not counted
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def shadow(prop, op_schema):
            self._paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._paused -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = shadow

        def unpatch():
            ShardingPropagator._propagate_tensor_meta_non_cached = orig
        self._unpatch = unpatch
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times (a loop traced once)."""
        prev, self.mult = self.mult, self.mult * n
        try:
            yield
        finally:
            self.mult = prev

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _hold(self, out) -> None:
        if not isinstance(out, torch.Tensor):
            return
        try:
            st = out.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if DTensor in types:
            # the global view: let DTensor run it, its local ops come back
            # through this mode (which stays on the stack), per device
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        flat_in, _ = tree_flatten((args, kwargs))
        flat_out, _ = tree_flatten(out)
        name = func._opname
        ns = func.namespace
        self.n_ops += 1
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                self.collective_bytes[kind] += self.mult * sum(
                    _nbytes(a) for a in flat_in)
                self.collective_counts[kind] += self.mult
            for o in flat_out:
                self._hold(o)
            return out
        if name in _DOTS:
            self.flops += self.mult * _dot_flops(name, args, flat_out[0])
        elif name in _CONVS:
            self.flops += self.mult * _conv_flops(args, flat_out[0])
        if not func.is_view:
            self.hbm_bytes += self.mult * (
                sum(_nbytes(a) for a in flat_in)
                + sum(_nbytes(o) for o in flat_out))
            for o in flat_out:
                self._hold(o)
        return out


def analyze(trace: DispatchTrace) -> dict:
    """The reference's keys of a finished ``DispatchTrace``."""
    return {
        "flops": trace.flops,
        "hbm_bytes": trace.hbm_bytes,
        "collective_bytes": dict(trace.collective_bytes),
        "collective_counts": dict(trace.collective_counts),
        "n_ops": trace.n_ops,
    }

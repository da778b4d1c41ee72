"""Autograd for the model kernels: one ``torch.autograd.Function`` each.

A kernel wrapper launches through ctypes on raw data pointers, so its
output is a fresh tensor with no ``grad_fn``: called on an input that
requires grad, it would cut every parameter upstream off from its
gradient.  The wrappers therefore raise on such an input
(``_build.check_no_grad``), and the ops of the five model kernels --
``vecadd_2d``, ``rmsnorm_2d``, ``rope_3d``, ``flash_attention_3d`` and
``ssd_intra`` -- route a CUDA call through the Functions here whenever
``wanted`` says autograd is recording it.

Each Function's ``forward`` launches the hand-written kernel through its
wrapper and saves the inputs; its ``backward`` returns the
vector-Jacobian product of the plain version, recomputed from the saved
inputs under ``torch.enable_grad()``.  That is the JAX package's own
autodiff path: it differentiates only through its ``ref`` backend and
has no backward kernel.  For attention the plain version differentiated
is the training path's (``flash_attention.ref.autodiff_attention``:
banded sliding-window or blockwise), never the full-softmax serving
one, whose float32 (B*H, S, T) scores a layer would not fit at 2048
tokens.

Under non-reentrant activation checkpointing the saved inputs are
recomputed by the checkpoint, which launches the kernel again; the
Functions save nothing else.  ``backward_counts`` counts the plain
backwards by kernel, as ``_build.launch_counts`` counts the launches,
and ``timed`` collects CUDA-event spans around them on the card.  A
CUDA graph's capture runs nothing: inside ``record()`` a plain backward
is kept in the ``Recording`` instead of counted, with no span, and each
replay of the graph adds it (``Recording.replay``), as
``_build.record(counted=False)`` does for the launches.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch

_BACKWARDS: Counter = Counter()
#: the (start, end) CUDA events of each plain backward while ``timed``
#: collects them, None otherwise
_SPANS: list | None = None
#: the open captures' ``Recording``s (``record``)
_CAPTURES: list = []


class Recording:
    """The plain backwards of one captured span, by kernel name."""

    def __init__(self):
        self.backwards: Counter = Counter()

    def replay(self) -> None:
        """Add the span's plain backwards to the counts, as one replay of
        a graph captured from it runs them."""
        _BACKWARDS.update(self.backwards)


@contextlib.contextmanager
def record():
    """A CUDA graph's capture: a plain backward recorded inside is noted
    in the ``Recording`` this yields, not counted and not timed."""
    rec = Recording()
    _CAPTURES.append(rec)
    try:
        yield rec
    finally:
        _CAPTURES.remove(rec)


def wanted(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode is on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if isinstance(t, torch.Tensor))


def backward_counts() -> dict[str, int]:
    """Plain backwards run since the last reset, by kernel name."""
    return dict(_BACKWARDS)


def reset_backward_counts() -> None:
    """Set every kernel's plain-backward count to 0."""
    _BACKWARDS.clear()


@contextlib.contextmanager
def timed():
    """Collect a (start, end) CUDA-event pair around every plain backward
    run inside; yields the list (read ``elapsed_ms`` after a sync)."""
    global _SPANS
    prev, _SPANS = _SPANS, []
    try:
        yield _SPANS
    finally:
        _SPANS = prev


def elapsed_ms(spans: list) -> float:
    """The summed milliseconds of ``timed``'s spans (synchronizes)."""
    if spans:
        spans[-1][1].synchronize()
    return sum(a.elapsed_time(b) for a, b in spans)


class _KernelFunction(torch.autograd.Function):
    """The kernel forward, the plain version's vjp backward.

    ``apply(name, kernel, plain, *inputs)``: ``kernel(*inputs)`` gives
    the output (a tensor or a tuple), ``plain(*inputs)`` the same
    function in differentiable torch ops.  Each model kernel has its own
    subclass, so its ``grad_fn`` names it."""

    @staticmethod
    def forward(ctx, name, kernel, plain, *inputs):
        ctx.name, ctx.plain = name, plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        span = None
        if _SPANS is not None and inputs[0].is_cuda and not _CAPTURES:
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(need)
                  for x, need in zip(inputs, needs)]
            outs = ctx.plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs],
                                           allow_unused=True))
        if span is not None:
            span[1].record()
            _SPANS.append(span)
        for rec in _CAPTURES:
            rec.backwards[ctx.name] += 1
        if not _CAPTURES:
            _BACKWARDS[ctx.name] += 1
        return (None, None, None,
                *(next(got) if need else None for need in needs))


class VecAdd(_KernelFunction):
    """``vecadd_2d``: x + z for x, z (M, N)."""


class RMSNorm(_KernelFunction):
    """``rmsnorm_2d``: x (M, N), gain (N,) float32 (gets its gradient)."""


class Rope(_KernelFunction):
    """``rope_3d``: x (BH, S, D), cos/sin (S, D/2)."""


class FlashAttention(_KernelFunction):
    """``flash_attention_3d``: q (B, Hq, S, D), k/v (B, Hkv, T, D)."""


class SSDIntra(_KernelFunction):
    """``ssd_intra``: (y_intra, s_c) of xdt, b_in, c_in, cum."""

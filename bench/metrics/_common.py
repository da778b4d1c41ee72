"""Shared arithmetic of the per-layer readers: a kernel's roofline share
over the traced launches (each reader names its kernel and the bound of
one launch), the whole step's share of the peak, the device's idle
share.  Each reader returns None where it finds nothing."""
from __future__ import annotations

import math

from bench import counts


def _peaks(ctx: dict):
    return counts.peaks(ctx["device"].get("kind", ""))


def kernel_roofline(ctx: dict, kind: str, fragments: tuple,
                    bound) -> float | None:
    """The share (%) of its bound that a kernel reaches over every traced
    launch whose name holds one of ``fragments``: the sum of the
    launches' bounds over the sum of their device times.  ``bound(dev,
    m, rows, seq)`` is one launch's least time (None where the
    configuration has no such launch).  The launches come a layer each,
    in groups of ``n_layers``; group ``g`` has the shape
    ``ctx["launch_shapes"][g % len(launch_shapes)]`` (rows, sequence):
    a traced serve's calls in turn, a train step's micro-batches."""
    prof, dev = ctx.get("profile"), _peaks(ctx)
    if ctx["kind"] != kind or prof is None or dev is None:
        return None
    m, shapes = ctx["model"], ctx["launch_shapes"]
    per = [bound(dev, m, rows, seq) for rows, seq in shapes]
    times = prof.launches(fragments)
    groups, left = divmod(len(times), m["n_layers"])
    if None in per or not times or left or groups % len(shapes):
        return None
    total = m["n_layers"] * groups // len(shapes) * math.fsum(per)
    return 100.0 * total / math.fsum(times)


def mfu(ctx: dict, kind: str) -> float | None:
    """The model FLOPs of the traced work over the traced window at the
    bf16 peak (%)."""
    prof, dev = ctx.get("profile"), _peaks(ctx)
    if ctx["kind"] != kind or prof is None or dev is None:
        return None
    return 100.0 * ctx["profiled_flops"] / (prof.window_s * dev["bf16_flops"])


def idle_share(ctx: dict, kind: str) -> float | None:
    """The share (%) of the traced window with no device activity."""
    prof = ctx.get("profile")
    if ctx["kind"] != kind or prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)

"""The mean device ms of a decode step (``serve_batch``'s CUDA-event
trace) over every step of the window's calls."""
import statistics


def read(ctx):
    ms = ctx.get("decode_ms") or []
    return statistics.fmean(ms) if ctx["kind"] == "serve" and ms else None

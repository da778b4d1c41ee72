"""The mean device ms of a prefill (``serve_batch``'s CUDA-event trace)
over the window's calls."""
import statistics


def read(ctx):
    ms = ctx.get("prefill_ms") or []
    return statistics.fmean(ms) if ctx["kind"] == "serve" and ms else None

"""The whole train step's model FLOPs over the traced window at the bf16
peak (%)."""
from bench.metrics._common import mfu


def read(ctx):
    return mfu(ctx, "train")

"""The share of the traced window of the serve cells in which no device
operation ran (%)."""
from bench.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx, "serve")

"""flash_attention_3d's share of its roofline in the serve cells' traced
launches (%): ``flash_kernel`` against one causal, windowed launch's
bound."""
from bench import counts
from bench.metrics._common import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "serve", ("flash_kernel",),
                           counts.flash_launch_s)

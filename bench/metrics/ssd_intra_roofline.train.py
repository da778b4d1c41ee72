"""ssd_intra's share of its roofline in the train cells' traced launches
(%): ``ssd_kernel`` or ``ssd_intra_kernel`` against one launch's
bound."""
from bench import counts
from bench.metrics._common import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "train", ("ssd_kernel", "ssd_intra_kernel"),
                           counts.ssd_launch_s)

"""Device kernels in the traced stretch over its coupling steps."""

from benchmark import readings


def read(ctx):
    return readings.kernels_per_step(ctx)

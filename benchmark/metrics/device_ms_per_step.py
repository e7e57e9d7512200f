"""The device's busy time (the union of its operations) in the traced
stretch over its coupling steps."""

from benchmark import readings


def read(ctx):
    return readings.device_ms_per_step(ctx)

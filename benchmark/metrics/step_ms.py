"""The coupling step's time: the whole window over its steps."""

from benchmark import readings


def read(ctx):
    return readings.window_ms_per_step(ctx)

"""The 95th percentile of the window's coupling-step times (CUDA events
at the step ends)."""

from benchmark import readings


def read(ctx):
    return readings.p95(ctx.step_ms)

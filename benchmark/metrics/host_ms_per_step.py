"""The host's time in each ``IcebergsModel.run`` call, with no sync: the
enqueue of a coupling step."""

from benchmark import readings


def read(ctx):
    return readings.mean(ctx.host_ms)

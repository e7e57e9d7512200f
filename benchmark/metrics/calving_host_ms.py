"""The calving buckets' running mean, accumulation and spawn: the host
ms a coupling step of the program's span ``kid.calving``, its mean over
the window's steps (the enqueue, with no sync)."""

from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "kid.calving")

"""The interpolation of the environment onto the bergs: the host ms a
coupling step of the program's span ``kid.interp``, its mean over the
window's steps (the enqueue, with no sync)."""

from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "kid.interp")

"""The gridded fields (K3's spreading): the host ms a coupling step of
the program's span ``kid.spread``, its mean over the window's steps (the
enqueue, with no sync)."""

from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "kid.spread")

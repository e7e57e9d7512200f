"""The contact search (K2, its exact fallback, the tables): the host ms
a coupling step of the program's span ``kid.contacts``, its mean over
the window's steps (the enqueue, with no sync)."""

from benchmark import spans


def read(ctx):
    return spans.phase_ms(ctx, "kid.contacts")

"""Bergs on the exact contact fallback a coupling step (the program's
``contact_fallback`` counter, over the window)."""

from benchmark import readings


def read(ctx):
    return readings.counter(ctx, "contact_fallback")

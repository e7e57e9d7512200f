"""The device's idle share at the window's pace: 1 - the device's busy
time a step (the union of its operations in the traced stretch, over
its steps) over the window's time a step (host clock, untraced).  The
traced stretch itself runs slower than the window, as the profiler
costs the host time, so its own idle share (``busy_s`` over
``window_s``) reads higher."""

from benchmark import readings


def read(ctx):
    busy = readings.device_ms_per_step(ctx)
    step = readings.window_ms_per_step(ctx)
    return None if busy is None or not step else 100. * (1. - busy / step)

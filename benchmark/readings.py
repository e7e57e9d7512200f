"""What the metric readers share: statistics over the window's steps and
look-ups in the traced stretch.  Each returns None where the run has
nothing to read, and the metric is then left out of the line."""

import statistics


def window_ms_per_step(ctx):
    """The whole window (host clock) over the steps completed in it."""
    return ctx.wall_s * 1e3 / ctx.steps if ctx.steps else None


def p95(values):
    """The 95th percentile (``statistics.quantiles``, exclusive)."""
    return statistics.quantiles(values, n=100)[94] if len(values) > 1 \
        else None


def mean(values):
    return statistics.fmean(values) if values else None


def counter(ctx, name):
    """A program counter's mean over the window's steps."""
    return mean(ctx.counters.get(name, []))


def traced(ctx):
    return ctx.trace if ctx.trace and ctx.trace["steps"] else None


def kernels_per_step(ctx):
    t = traced(ctx)
    return len(t["kernels"]) / t["steps"] if t else None


def device_ms_per_step(ctx):
    t = traced(ctx)
    return t["busy_s"] * 1e3 / t["steps"] if t else None


def kernel_calls_us(ctx, name):
    """The durations (µs) of the traced kernels whose name holds
    ``name``, in launch order."""
    t = traced(ctx)
    if not t:
        return []
    return [d for n, _, d in sorted(t["kernels"], key=lambda k: k[1])
            if name in n]

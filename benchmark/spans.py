"""The program's own spans (``icebergs_tpu_torch.trace``, read in
memory): the window's steps phase by phase, and the set-up's parts.

The window's steps are the last ``ctx.steps`` ``kid.run`` spans opened
with no profiler active: the warm-up episode comes before them, the
traced stretches after them, under the profiler.  Each function returns
None where the program has no tracer (a checkout older than it) or where
the spans do not line up with the window: fewer ``kid.run`` spans than
its steps, or one more than ``TOL_MS`` away from the host clock's time
of the same step.  The host clock's step also holds what the window does
around the call, chiefly the release of the state it held two steps
back: 0.015-0.31 ms a step on an H100's host, against steps that differ
from each other by milliseconds."""

import importlib

from benchmark import readings

STEP = "kid.run"
TOL_MS = 1.0
# the program's set-up spans that ``init_s`` sums (the kernels' load, not
# their build: a checkout's first run alone compiles)
SETUP = ("kid.create_bergs", "kid.model_init", "kid.init_state")
SETUP_LAZY = ("kid.kernels_load",)      # absent where no kernel launches


def tracer():
    try:
        return importlib.import_module("icebergs_tpu_torch.trace")
    except ImportError:
        return None


def window_steps(ctx):
    """The window's steps in order, each ``{phase: host ms}`` summed over
    the spans directly inside its ``kid.run``; or None."""
    t = tracer()
    if t is None or not ctx.steps:
        return None
    recs = t.records()
    runs = [r for r in recs if r.name == STEP and not r.profiled]
    runs = runs[-ctx.steps:]
    if len(runs) != ctx.steps or any(
            abs(r.host_ms - h) > TOL_MS for r, h in zip(runs, ctx.host_ms)):
        return None
    steps = {r.step: {} for r in runs}
    for r in recs:
        phases = steps.get(r.step)
        if phases is not None and r.parent == STEP:
            phases[r.name] = phases.get(r.name, 0.) + r.host_ms
    return list(steps.values())


def phase_ms(ctx, name):
    """A phase's host ms a step, its mean over the window's steps (0 in a
    step that did not run it)."""
    steps = window_steps(ctx)
    return (None if steps is None
            else readings.mean([s.get(name, 0.) for s in steps]))


def init_s(ctx):
    """The program's set-up spans, each its last call, in seconds."""
    t = tracer()
    if t is None:
        return None
    tot = t.totals()
    if any(n not in tot for n in SETUP):
        return None
    return sum(tot[n]["last_ms"] for n in SETUP + SETUP_LAZY
               if n in tot) / 1e3

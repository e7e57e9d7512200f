"""The share of the window's coupling steps replayed from CUDA graphs:
the steps whose ``kid.run`` span holds a ``kid.replay`` span (the
program's copy of the step's inputs before it replays the step's
graphs); 0 where the program runs every step eagerly."""

from benchmark import readings, spans

REPLAY = "kid.replay"


def read(ctx):
    steps = spans.window_steps(ctx)
    return None if steps is None else readings.mean(
        [1. if REPLAY in s else 0. for s in steps])

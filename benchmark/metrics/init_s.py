"""The set-up that the program's spans cover, in seconds: the bergs'
creation (``kid.create_bergs``), the model's grid tables
(``kid.model_init``), the initial state (``kid.init_state``) and the
kernels' load (``kid.kernels_load``; not their build)."""

from benchmark import spans


def read(ctx):
    return spans.init_s(ctx)

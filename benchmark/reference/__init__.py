"""The plain references, one module per entry (``<entry>.py``): plain
PyTorch in float64 from the model's equations, importing nothing of the
port.  Each ``run(inputs, conf, world, steps, device, lower, judged)``
takes the inputs the benchmark made from the seed
(``worlds/<world>.inputs``): it runs its own episode, and one step from
the state the ``judged`` side's last step started from; ``lower`` stores
its berg state in bfloat16 after each step (the lower-precision
control)."""

from importlib import import_module


def run(entry, world, conf, seed, device, steps, lower=False, judged=None):
    """The reference of ``entry`` on the world the configuration names,
    from ``seed``."""
    ref = import_module(f"{__name__}.{entry}")
    return ref.run(world.inputs(conf, seed, device), conf, world, steps,
                   device, lower=lower, judged=judged)

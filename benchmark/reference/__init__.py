"""The plain references, one module per entry (``<entry>.py``): plain
PyTorch in float64 from the model's equations, importing nothing of the
port.  Each module gives

- ``run(inputs, conf, world, steps, device, lower, judged)``: from the
  inputs the benchmark made from the seed (``worlds/<world>.inputs``),
  its own episode, and one step from the state the ``judged`` side's
  last step started from; ``lower`` stores its state in the next
  precision down after each step (the lower-precision control).  What
  it returns under ``readers`` (a dict, which it may leave out) the
  metric readers find on their context;
- ``numbers(judged, ref)``: the numbers that decide ``correct``, by
  name, and the worst fields, ``(numbers, worst)``."""

from importlib import import_module


def module(entry):
    """The reference module of ``entry``."""
    return import_module(f"{__name__}.{entry}")


def run(entry, world, conf, seed, device, steps, lower=False, judged=None):
    """The reference of ``entry`` on the world the configuration names,
    from ``seed``."""
    return module(entry).run(world.inputs(conf, seed, device), conf, world,
                             steps, device, lower=lower, judged=judged)


def numbers(entry, judged, ref):
    """``entry``'s comparison of the ``judged`` side's answer with its
    reference's: ``(numbers, worst)``."""
    return module(entry).numbers(judged, ref)

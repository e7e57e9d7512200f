"""Worlds, one module per world a configuration names.  Each
``inputs(conf, seed, device)`` makes every input of a run from the seed
as plain tensors, which the reference takes as they are, and
``build(kid, conf, seed, device)`` puts the same inputs into the port's
(``kid``'s) containers.  For the CPU tests each gives ``TINY``, a small
size written over the configuration (``harness.merge``), and
``VARIANTS``, named changes written over that in turn."""

"""Entries, one module per entry a traffic mix names.  Each holds
a ``Sim(kid, world, traffic, seed)`` over the port ``kid``: ``start()``
gives the episode's first state, ``step(state)`` one step of the entry as
its callers make it, ``counters(out)`` the program's counters of that
step, and ``answer(before, state, outs)`` what the episode produced and
the state its last step started from, for the comparison with the
reference."""

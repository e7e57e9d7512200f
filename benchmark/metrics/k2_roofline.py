"""K2's share of its roofline: the bytes its algorithm needs for each
traced call's inputs (``roofline.k2_work``: the slab, the grid's cells,
and the engaged pairs and their partners, counted by the reference's
exact contact search on the same step of the same episode) over the
call's device time, averaged over the traced calls."""

from benchmark import readings, roofline

KERNEL = "extract_sorted_kernel"


def read(ctx):
    us = readings.kernel_calls_us(ctx, KERNEL)
    contacts = getattr(ctx, "contacts", ())
    if not us or len(contacts) < len(us):
        return None
    n = ctx.conf["bergs"]["capacity"]
    ncells = ctx.conf["grid"]["nx"] * ctx.conf["grid"]["ny"]
    shares = []
    for d, c in zip(us, contacts):
        ms, _ = roofline.bound_ms(*roofline.k2_work(
            n, ncells, -(-n // roofline.K2_BLOCK_ROWS), c["partners"],
            c["engaged"], latlon=True))
        shares.append(100. * ms / (d / 1e3))
    return readings.mean(shares)

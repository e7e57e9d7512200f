"""The yardstick's peaks and the kernels' work, frozen from the port's
kernel table (``chip_smoke.py``'s ``bound`` and ``k2_case``): what each
kernel's algorithm needs for a call's inputs, not what an
implementation does, so that a later kernel is read against the same
work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of
HBM, 67 TFLOP/s of float32 outside the tensor cores.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# K2 per candidate pair test (separation, the criterion, compares), and
# the lat-lon metric's operations on top (the mean latitude's sum and
# half, the angle, cos as one, the two factors' products)
K2_FLOPS_PER_PAIR, K2_LL_FLOPS_PER_PAIR = 12, 6
K2_OUT_ROWS = 24            # float32 rows K2 writes for every slot
K2_PARTNER_ROWS = 6         # feature rows 2-7, read at each partner slot
K2_BLOCK_ROWS = 128         # the slab rows a block of the search holds


def bound_ms(nbytes: float, flops: float):
    """``(ms, by)``: the larger of bytes over the HBM rate and operations
    over the float32 peak, and which of the two it is."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k2_work(n, ncells, nblocks, partners, engaged, group=False,
            latlon=False):
    """``(bytes, operations)`` of one K2 call (the contact search and
    extraction) over ``n`` slots of a grid of ``ncells`` cells in
    ``nblocks`` blocks: the rows of the tests for every slot (lon, lat,
    radius, alive, key, footloose state; the group with
    ``exclude_same_group``), feature rows 2-7 once at each berg that is
    the partner of an engaged pair, each block's two keys, the cell
    starts, the 24 output rows and the bad flags; the operations of the
    ``engaged`` pairs' tests (no exact search can skip those)."""
    rows = 6 + (1 if group else 0)
    nbytes = (4 * rows * n + 4 * K2_PARTNER_ROWS * partners + 8 * nblocks
              + 4 * (ncells + 1) + 4 * K2_OUT_ROWS * n + n)
    flops = (K2_FLOPS_PER_PAIR + (K2_LL_FLOPS_PER_PAIR if latlon else 0)
             ) * engaged
    return nbytes, flops


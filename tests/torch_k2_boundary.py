"""Per-cell counts that put K2's blocks at each edge of its bad rule.

Shared by the CPU test of the rule against the JAX wrapper
(``test_torch_extract.py``) and the card test of the kernel that builds
the rule's tables itself (``test_torch_cuda.py``).
"""

import numpy as np


def k2_boundary_counts(nx, ny, block_n, radius, wl, seed=0):
    """Per-cell berg counts (ny * nx,) whose slab, sorted by cell, puts
    blocks of ``block_n`` rows at each edge of K2's bad rule (the TPU
    wrapper's, ``extract.block_tables``) at window width ``wl``: a block
    with a strip whose window need ``cs[chi+1] - 128 * (cs[clo] // 128)``
    is exactly ``wl`` (good) and one with ``wl + 1`` (bad), each with a
    span within ``nx - (2r+1)``, and blocks spanning exactly ``nx -
    (2r+1)`` cells (good) and one more (bad), each within ``wl``.  Returns
    ``(counts, blocks)``, ``blocks`` naming each such block's index
    (``"wl"``, ``"wl+1"``, ``"span"``, ``"span+1"``).  Each edge is made by
    setting the counts of cells past every earlier block's strips, so the
    earlier blocks keep their rows and tables."""
    ns = 2 * radius + 1
    ncells = nx * ny
    rng = np.random.RandomState(seed)
    counts = rng.poisson(max(1, round(2 * block_n / nx)), ncells)

    def tables():
        """(cell starts, c0, c1, the strips' window need) of the whole
        blocks of live rows."""
        cs = np.concatenate([[0], np.cumsum(counts)])
        key = np.repeat(np.arange(ncells), counts)
        nb = key.size // block_n
        c0 = key[:nb * block_n:block_n]
        c1 = key[block_n - 1:nb * block_n:block_n]
        offs = np.arange(-radius, radius + 1) * nx
        lo = np.clip(c0[:, None] - radius + offs, 0, ncells - 1)
        hi = np.clip(c1[:, None] + radius + offs, -1, ncells - 1)
        return cs, c0, c1, cs[hi + 1] - cs[lo] // 128 * 128

    blocks, floor = {}, 0
    # the top strip's last cell lies past the block's rows and its other
    # strips: raising its count raises that strip's need alone
    for name, target in (("wl", wl), ("wl+1", wl + 1)):
        cs, c0, c1, need = tables()
        top = c1 + radius + radius * nx
        b = np.flatnonzero((c0 > floor) & (c1 - c0 <= nx - ns)
                           & (need.max(1) < target) & (top < ncells - 1))[0]
        counts[top[b]] += target - need[b, -1]
        blocks[name], floor = b, top[b]
    # the rows of the block's first cell from its first row, then cells
    # c0 + 1 .. c0 + span - 1 filled so that its last row opens c0 + span
    for name, span in (("span", nx - ns), ("span+1", nx - ns + 1)):
        cs, c0, c1, need = tables()
        m0 = cs[c0 + 1] - np.arange(c0.size) * block_n
        for b in np.flatnonzero((c0 > floor) & (m0 < block_n)
                                & (c0 + span + radius + radius * nx
                                   < ncells - 1)):
            keep = counts.copy()
            fill = block_n - 1 - m0[b]
            counts[c0[b] + 1:c0[b] + span] = (
                fill // (span - 1)
                + (np.arange(span - 1) < fill % (span - 1)))
            counts[c0[b] + span] = max(counts[c0[b] + span], 1)
            if tables()[3][b].max() <= wl:
                break
            counts[:] = keep
        blocks[name], floor = b, c0[b] + span + radius + radius * nx
    cs, c0, c1, need = tables()
    assert [int(need[blocks[k]].max()) for k in ("wl", "wl+1")] == [
        wl, wl + 1]
    assert [int(c1[blocks[k]] - c0[blocks[k]]) for k in ("span", "span+1")
            ] == [nx - ns, nx - ns + 1]
    assert int(need[[blocks["span"], blocks["span+1"]]].max()) <= wl
    return counts, blocks

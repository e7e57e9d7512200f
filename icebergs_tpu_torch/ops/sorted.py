"""Cell-sorted particle layout: the (cell, id) re-sort of the whole state.

Counterpart of ``icebergs_tpu/ops/sorted.py`` on its production branch
(``sort_state_by_cell`` with ``packed_permute=True, pack_kernel=True``,
``sorted.py:83-143, 251-324``): a key-only sort, then every non-uniform
state column moved by K1 (:func:`..ops.pack.permute_cols_u32`, which
reads the columns in place, at most 128 a launch).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import IcebergsConfig
from ..grid import Grid
from .pack import from_bits, permute_cols_u32, to_bits


def lex_cell_id_order(key, id_cnt, id_ij):
    """The (key, id_cnt, id_ij) lexicographic permutation (int32).

    ``lax.sort((key, id_cnt, id_ij, iota), num_keys=3)`` in the JAX
    package; torch has no multi-key sort, so three stable sorts run from
    the least significant key up — the same signed int32 comparator."""
    order = torch.argsort(id_ij, stable=True)
    order = order[torch.argsort(id_cnt[order], stable=True)]
    order = order[torch.argsort(key[order], stable=True)]
    return order.to(torch.int32)


def starts_from_sorted_key(sorted_key, ncells: int):
    """``searchsorted(sorted_key, arange(ncells + 1))`` (left), int32."""
    q = torch.arange(ncells + 1, dtype=sorted_key.dtype,
                     device=sorted_key.device)
    return torch.searchsorted(sorted_key, q).to(torch.int32)


def uniform_state_fields(cfg: IcebergsConfig):
    """Field names that hold the same value in every slot under ``cfg``
    (a row permutation is the identity on them, so the re-sort skips
    them)."""
    out = []
    if not cfg.iceberg_bonds_on:
        out += ["bond_idx", "bond_id_cnt", "bond_id_ij", "bond_broken",
                "bond_length", "bond_tangd1", "bond_tangd2",
                "bond_nstress", "bond_sstress", "bond_rel_rotation",
                "n_bonds"]
    if not cfg.mts:
        out += ["axn_fast", "ayn_fast", "bxn_fast", "byn_fast",
                "conglom_id"]
        if not cfg.dem:
            out += ["ang_vel", "ang_accel", "rot"]
    return tuple(out)


def sort_state_by_cell(st, grid: Grid, *, static_fields=(),
                       via_rows: bool = False):
    """Reorder every state leaf by (cell key, id_cnt, id_ij), dead bergs
    (key = ncells) last.  Returns ``(sorted_state, cell_starts)`` with
    ``cell_starts`` (ncells+1,) int32 the first sorted slot of each cell.

    ``static_fields`` (see :func:`uniform_state_fields`) are left in
    place.  Bond partner slots are remapped through the permutation.
    ``via_rows`` moves the columns by K1's row route (for a slab in
    random order; bitwise the same)."""
    nx, ny = grid.nx, grid.ny
    ncells = nx * ny
    N = st.capacity
    key = torch.where(st.alive, st.jne * nx + st.ine,
                      ncells).to(torch.int32)
    order = lex_cell_id_order(key, st.id_cnt, st.id_ij)
    ol = order.long()
    sorted_key = key[ol]
    new = {"id_cnt": st.id_cnt[ol], "id_ij": st.id_ij[ol],
           "alive": sorted_key < ncells}

    skip = set(static_fields) | set(new)
    cols = []                       # (field, bond column or None, dtype)
    lanes = []
    for f in dataclasses.fields(st):
        if f.name in skip:
            continue
        leaf = getattr(st, f.name)
        subs = ([(None, leaf)] if leaf.dim() == 1 else
                [(b, leaf[:, b]) for b in range(leaf.shape[1])])
        for b, col in subs:
            cols.append((f.name, b, col.dtype))
            lanes.append(to_bits(col))
    packs = {}
    # K1 reads the leaves' columns where they lie (no stack), 128 a launch
    moved = permute_cols_u32(lanes, order, via_rows=via_rows)
    for k, (nm, b, dt) in enumerate(cols):
        col = from_bits(moved[k], dt)
        if b is None:
            new[nm] = col
        else:
            packs.setdefault(nm, {})[b] = col
    for nm, colmap in packs.items():
        new[nm] = torch.stack([colmap[b] for b in range(len(colmap))],
                              dim=1)
    if "bond_idx" not in static_fields:
        inv = torch.empty_like(order)
        inv[ol] = torch.arange(N, dtype=order.dtype, device=order.device)
        bidx = new["bond_idx"]
        new["bond_idx"] = torch.where(
            bidx >= 0, inv[bidx.clamp(min=0).long()], -1).to(torch.int32)
    return st.replace(**new), starts_from_sorted_key(sorted_key, ncells)

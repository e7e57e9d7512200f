"""Cell-sorted particle layout: the (cell, id) re-sort of the whole state.

Counterpart of ``icebergs_tpu/ops/sorted.py`` (``sort_state_by_cell``,
``starts_from_sorted_key``, ``_payload_sort_state``,
``_packed_permute_state``, ``uniform_state_fields``,
``strip_neighbor_tables``, and the strips of the fused searches'
fallback): a key-only sort,
then every non-uniform state column moved by the permutation.  The
production transport (``sort_packed_permute``, ``pack_kernel``) is K1
(:func:`..ops.pack.permute_cols_u32`, which reads the columns in place,
at most 128 a launch); ``pack_kernel=False`` moves the columns as one
stacked (N, C) matrix by a row gather and ``sort_packed_permute=False``
gathers each column by the order (the JAX variadic payload sort's
result); ``starts_via_scatter`` takes the cell starts from a scatter-min
and a reverse running minimum.  All give the same bits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import IcebergsConfig
from ..grid import Grid
from .forces import NeighborTables
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


def starts_from_sorted_key(sorted_key, ncells: int, *,
                           via_scatter: bool = False):
    """``searchsorted(sorted_key, arange(ncells + 1))`` (left), int32; with
    ``via_scatter`` the same values from a scatter-min of each present
    key's first row into its slot and a reverse running minimum that
    fills the absent keys (``sorted.py:146-168``)."""
    dev = sorted_key.device
    if not via_scatter:
        q = torch.arange(ncells + 1, dtype=sorted_key.dtype, device=dev)
        return torch.searchsorted(sorted_key, q).to(torch.int32)
    N = sorted_key.shape[0]
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    tgt = torch.where(first, sorted_key.to(torch.int64), ncells + 1)
    tgt = tgt.clamp(max=ncells + 1)
    starts = torch.full((ncells + 2,), N, dtype=torch.int32, device=dev)
    starts.scatter_reduce_(0, tgt, torch.arange(N, dtype=torch.int32,
                                                device=dev), reduce="amin")
    starts = starts[:ncells + 1].flip(0).cummin(0).values.flip(0)
    return starts.contiguous()


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


def _state_columns(st, skip):
    """The state's (N,) columns outside ``skip``, each bond-table column
    on its own: ``[(field, bond column or None, tensor)]``."""
    out = []
    for f in dataclasses.fields(st):
        if f.name in skip:
            continue
        leaf = getattr(st, f.name)
        if leaf.dim() == 1:
            out.append((f.name, None, leaf))
        else:
            out += [(f.name, b, leaf[:, b]) for b in range(leaf.shape[1])]
    return out


def _move_columns(cols, order, *, packed_permute: bool, pack_kernel: bool,
                  via_rows: bool):
    """The columns reordered by ``order``: K1 (``packed_permute`` and
    ``pack_kernel``), a row gather of the stacked u32 matrix
    (``pack_kernel=False``), or one gather per column
    (``packed_permute=False``)."""
    ol = order.long()
    if not packed_permute:
        return [c[ol] for c in cols]
    lanes = [to_bits(c) for c in cols]
    if pack_kernel:
        moved = permute_cols_u32(lanes, order, via_rows=via_rows)
    else:
        # stack_cols (sorted.py:43-58) and one row gather
        moved = torch.stack(lanes, dim=1)[ol].T.contiguous()
    return [from_bits(m, c.dtype) for m, c in zip(moved, cols)]


def sort_state_by_cell(st, grid: Grid, *, static_fields=(),
                       via_rows: bool = False, packed_permute: bool = True,
                       pack_kernel: bool = True,
                       starts_via_scatter: bool = False):
    """Reorder every state leaf by (cell key, id_cnt, id_ij), dead bergs
    (key = ncells) last.  Returns ``(sorted_state, cell_starts)`` with
    ``cell_starts`` (ncells+1,) int32 the first sorted slot of each cell.

    ``static_fields`` (see :func:`uniform_state_fields`) are left in
    place.  Bond partner slots are remapped through the permutation.
    ``via_rows`` moves the columns by K1's row route (for a slab in
    random order); ``packed_permute``, ``pack_kernel`` and
    ``starts_via_scatter`` are the config's transport knobs.  Every
    choice gives the same bits."""
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
    cols = _state_columns(st, set(static_fields) | set(new))
    moved = _move_columns([c for _, _, c in cols], order,
                          packed_permute=packed_permute,
                          pack_kernel=pack_kernel, via_rows=via_rows)
    packs = {}
    for (nm, b, _), col in zip(cols, moved):
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
    return st.replace(**new), starts_from_sorted_key(
        sorted_key, ncells, via_scatter=starts_via_scatter)


def sort_kw(cfg: IcebergsConfig) -> dict:
    """:func:`sort_state_by_cell`'s transport knobs from the config."""
    return dict(packed_permute=cfg.sort_packed_permute,
                pack_kernel=cfg.pack_kernel,
                starts_via_scatter=cfg.starts_via_scatter)


def strip_tables(sub, self_ids, full_alive, capacity, cell_starts, grid,
                 strip_width: int, radius: int = 1):
    """(2r+1) row strips of candidate slots of a (cell, id)-sorted slab
    for the rows ``sub`` (``ine``, ``jne``, ``alive``: the slab itself,
    ``self_ids`` its slots, or a compacted subset): row j' of rows
    j-r..j+r holds the slots of cells (i-r..i+r, j') in ``[start(j',
    i-r), end(j', i+r))``, capped at ``strip_width``.  Returns
    ``(cand_idx (int64), valid, truncated)``, ``truncated`` the
    candidates beyond the caps (int32)."""
    nx, ny = grid.nx, grid.ny
    ncells = nx * ny
    cs = cell_starts.long()
    offs = torch.arange(strip_width, device=cs.device)
    cands, valids = [], []
    truncated = torch.zeros((), dtype=torch.int64, device=cs.device)
    for dj in range(-radius, radius + 1):
        jrow = sub.jne + dj
        ilo = (sub.ine - radius).clamp(0, nx - 1)
        ihi = (sub.ine + radius).clamp(0, nx - 1)
        ok_row = (jrow >= 0) & (jrow < ny) & sub.alive
        jrow_c = jrow.clamp(0, ny - 1)
        s = cs[torch.where(ok_row, jrow_c * nx + ilo, ncells).long()]
        e = cs[torch.where(ok_row, jrow_c * nx + ihi + 1, ncells).long()]
        idx = s[:, None] + offs[None, :]
        valid = ok_row[:, None] & (idx < e[:, None])
        truncated = truncated + torch.where(
            ok_row, (e - s - strip_width).clamp(min=0), 0).sum()
        cands.append(torch.where(valid, idx, 0))
        valids.append(valid)
    cand_idx = torch.cat(cands, dim=1)
    valid = torch.cat(valids, dim=1)
    valid = valid & (cand_idx != self_ids[:, None])
    valid = valid & full_alive[cand_idx.clamp(max=capacity - 1)]
    return cand_idx, valid, truncated.to(torch.int32)


def strip_neighbor_tables(st, grid: Grid, cfg: IcebergsConfig, cell_starts,
                          strip_width: int = 16,
                          ncells_radius: int = 1) -> NeighborTables:
    """Candidate partners of each berg of a (cell, id)-sorted slab as
    2r+1 contiguous strips (:func:`strip_tables`), (N, (2r+1) *
    strip_width) int32, with the bond-partner flag under
    ``iceberg_bonds_on``."""
    N = st.capacity
    cand_idx, valid, _ = strip_tables(
        st, torch.arange(N, dtype=torch.int32, device=st.device), st.alive,
        N, cell_starts, grid, strip_width, radius=ncells_radius)
    cand_idx = cand_idx.to(torch.int32)
    if cfg.iceberg_bonds_on:
        bonds = torch.where(st.bond_idx >= 0, st.bond_idx, -2)
        is_bonded = (cand_idx[:, :, None] == bonds[:, None, :]).any(-1) \
            & valid
    else:
        is_bonded = torch.zeros_like(valid)
    return NeighborTables(cand_idx=cand_idx, cand_valid=valid,
                          is_bond_partner=is_bonded)

"""Fused interactive-force closures over the contact searches (K2, K5).

Counterpart of ``icebergs_tpu/ops/fused_contact.py``
(``FusedContactStats``, ``_subset_strip_tables`` (as
:func:`.sorted.strip_tables`),
``_fallback_group``, ``_scatter_fold``,
``_origin_frame_groups_extract``, ``make_ia_fn_fused3``,
``make_ia_fn_fused_mts1``; ``_sorted_contact_groups`` and
``make_ia_fn_fused``; ``_origin_frame_search``, ``_origin_frame_groups``
and ``make_ia_fn_fused2``):

1. K2 (:func:`.extract.extract_sorted`) searches each berg's strips and
   returns the count, min/max partner slots and both partners' features;
   on a slab that is not cell-sorted the search runs on a sorted view
   (the feature rows moved by K1) and its results come back to the
   origin frame through one inverse K1 transport.  K5
   (:func:`.prepass.contact_prepass_sorted`) is the same search without
   the features: ``make_ia_fn_fused`` (the persistent sorted slab) and
   ``make_ia_fn_fused2`` (a sorted view, partner slots mapped back to
   the origin frame) gather the partners' fields instead;
2. bergs with 1-2 partners outside bad blocks are evaluated on a
   two-partner table;
3. bergs with >= 3 partners or in bad blocks go through the exact
   fallback over their (2r+1)-row strips, compacted to ``fallback_cap``
   rows (``_compact``, :func:`.forces.compact_rows`) and folded back
   with one small scatter per field (``make_ia_fn_fused``: one
   rank-table gather per field, as the JAX function folds them).

With ``contact_epilogue`` (and ``extract_impl="gathered"``, as the JAX
package runs it) K2 also runs the two-partner group's pair precompute
and the pair data are assembled from its rows (``fused_contact.py:
580-606``).  With ``pack_kernel=False`` the search's results come back
to the origin frame by one gather per row instead of K1.

Overflow (fallback rows beyond the cap, strips wider than the strip
width) is counted in ``FusedContactStats.overflow``; a nonzero count
means the result is not exact and the caller must grow the cap.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..config import IcebergsConfig
from . import forces as _forces
from .accel import IA
from .extract import (EX_CNT, EX_EPI_NP, EX_F1, EX_F2, EX_IAX, EX_IAY,
                      EX_VMAX, EX_VMIN, PT_ALIVE, PT_AREA, PT_FLK, PT_GRP,
                      PT_KEY, PT_LAT, PT_LON, PT_MASS, PT_NEVAL, PT_NF,
                      PT_RAD, PT_U, PT_V, extract_sorted)
from .pack import from_bits, permute_cols_u32, to_bits
from .prepass import contact_prepass_sorted, prepass_features
from .sorted import lex_cell_id_order, starts_from_sorted_key, strip_tables


class FusedContactStats(NamedTuple):
    overflow: torch.Tensor      # engaged bergs dropped by cap overflow
    n_fallback: torch.Tensor    # bergs routed through the exact fallback


def _fallback_group(st, bad, order, key_s, cell_starts, grid, cfg, *,
                    fallback_cap, fallback_strip_width, radius=1,
                    exclude_same_group=False):
    """Exact fallback for >= 3-partner / bad-block rows: compacted in the
    frame of ``st``; candidate strips address the sorted slab and map
    back through ``order`` (None when ``st`` is the sorted slab).
    Returns ``(pd_f, sel_f, vrow_f, stats)``."""
    N = st.capacity
    sel_f, vrow_f, drop_f = _forces.compact_rows(bad, fallback_cap)
    s = sel_f.long()
    sub_f = SimpleNamespace(ine=st.ine[s], jne=st.jne[s],
                            alive=st.alive[s] & vrow_f)
    cand_s, valid_f, trunc_f = strip_tables(
        sub_f, torch.full_like(sel_f, -1), key_s < grid.nx * grid.ny, N,
        cell_starts, grid, fallback_strip_width, radius=radius)
    cand_f = cand_s.clamp(max=N - 1)
    cand_f = (cand_f.to(torch.int32) if order is None
              else order[cand_f])
    valid_f = valid_f & (cand_f != sel_f[:, None])
    if exclude_same_group:
        valid_f = valid_f & (st.conglom_id[cand_f.long()]
                             != st.conglom_id[s][:, None])
    pd_f = _forces.precompute_pair_data(
        _forces.take_rows(st, sel_f), cfg, cand_f, valid_f & vrow_f[:, None],
        partner_st=st)
    stats = FusedContactStats(overflow=drop_f + trunc_f,
                              n_fallback=bad.sum(dtype=torch.int32))
    return pd_f, sel_f, vrow_f, stats


def _scatter_fold(sel_f, vrow_f, capacity):
    """Fold a compact fallback result back into full-length fields: a
    scatter into a zero delta (one extra dump row) and an add."""
    tgt = torch.where(vrow_f, sel_f, capacity).long()

    def fold(x, f):
        delta = x.new_zeros(capacity + 1).index_add_(
            0, tgt, torch.where(vrow_f, f, 0.))
        return x + delta[:capacity]
    return fold


def contact_features(st, grid, cfg: IcebergsConfig,
                     exclude_same_group: bool = False):
    """K2's inputs in the frame of ``st``: the (PT_NF, N) feature rows
    and the cell keys (dead rows = ncells); ``exclude_same_group`` adds
    the conglomerate id row ``PT_GRP``."""
    rows, key = contact_feature_rows(st, grid, cfg, exclude_same_group)
    z = torch.zeros(st.capacity, dtype=st.lon.dtype, device=st.device)
    return torch.stack([z if r is None else r for r in rows]), key


def contact_feature_rows(st, grid, cfg: IcebergsConfig,
                         exclude_same_group: bool = False):
    """:func:`contact_features` before the stack: the PT_NF rows as a
    list (``None`` for the rows that are zero) and the cell keys."""
    ncells = grid.nx * grid.ny
    dtype = st.lon.dtype
    key = torch.where(st.alive, st.jne * grid.nx + st.ine,
                      ncells).to(torch.int32)
    A = st.length * st.width
    rows = [None] * PT_NF
    feats = [(PT_LON, st.lon_old), (PT_LAT, st.lat_old),
             (PT_U, st.uvel_old), (PT_V, st.vvel_old), (PT_AREA, A),
             (PT_MASS, st.mass),
             (PT_RAD, _forces._interaction_radius(cfg, A)),
             (PT_ALIVE, st.alive.to(dtype)), (PT_KEY, key.to(dtype)),
             (PT_FLK, st.fl_k)]
    if exclude_same_group:
        feats.append((PT_GRP, st.conglom_id.to(dtype)))
    for r, f in feats:
        rows[r] = f
    return rows, key


def _extract_groups(st, grid, cfg: IcebergsConfig, *, block_n, window,
                    fallback_cap, fallback_strip_width, presorted,
                    cell_starts=None, radius=1, exclude_same_group=False,
                    with_partner_slots=False, epilogue=False):
    """Search + pair data (``_origin_frame_groups_extract``).

    ``presorted``: ``st`` is the (cell, id)-sorted slab and everything
    stays in its frame.  Otherwise the search runs on a sorted view —
    the (cell, id_cnt, id_ij) order, the feature rows moved by K1 — and
    count, bad flag, partner slots and the 12 partner-feature rows come
    back to the origin frame in one inverse K1 transport.
    ``with_partner_slots`` keeps origin-frame partner slots in the pair
    data for :func:`forces.refresh_pair_velocities`.

    ``epilogue``: K2's pair epilogue makes the two-partner group's pair
    data.  Returns ``(pd_n, pd_f, sel_f, vrow_f, stats)``."""
    N = st.capacity
    ncells = grid.nx * grid.ny
    if presorted:
        PT, key = contact_features(st, grid, cfg, exclude_same_group)
        order = inv = None
        key_s = key
        if cell_starts is None:
            cell_starts = starts_from_sorted_key(key_s, ncells)
    else:
        rows, key = contact_feature_rows(st, grid, cfg, exclude_same_group)
        order = lex_cell_id_order(key, st.id_cnt, st.id_ij)
        inv = torch.empty_like(order)
        inv[order.long()] = torch.arange(N, dtype=order.dtype,
                                         device=order.device)
        # K1 writes the sorted feature matrix from the rows (no stack)
        PT = from_bits(permute_cols_u32([to_bits(r) for r in rows], order),
                       st.lon.dtype)
        key_s = key[order.long()]
        cell_starts = starts_from_sorted_key(key_s, ncells)
    out, bad_block = extract_sorted(PT, key_s, cell_starts, grid, cfg,
                                    block_n=block_n, window=window,
                                    radius=radius,
                                    exclude_same_group=exclude_same_group,
                                    epilogue=epilogue)
    cnt = out[EX_CNT].to(torch.int32)
    bad = (bad_block | (cnt > 2)) & (key_s < ncells)
    lanes = [cnt, bad.to(torch.int32)]
    if with_partner_slots:
        # min/max engaged sorted slots -> origin-frame partner slots
        i1 = out[EX_VMIN].clamp(0, N - 1).to(torch.int32)
        i2 = out[EX_VMAX].clamp(0, N - 1).to(torch.int32)
        if order is not None:
            i1, i2 = order[i1.long()], order[i2.long()]
        zero = torch.zeros_like(cnt)
        lanes += [torch.where(cnt >= 1, i1, zero),
                  torch.where(cnt >= 2, i2, zero)]
    npr = EX_EPI_NP if epilogue else PT_NEVAL
    frows = ([out[EX_F1 + k] for k in range(npr)]
             + [out[EX_F2 + k] for k in range(npr)])
    if epilogue:
        frows += [out[EX_IAX], out[EX_IAY]]
    if inv is not None and cfg.pack_kernel:
        R = permute_cols_u32(lanes + [to_bits(f) for f in frows], inv)
        nl = len(lanes)
        lanes = list(R[:nl])
        frows = [from_bits(R[nl + k], out.dtype) for k in range(len(frows))]
    elif inv is not None:
        # the per-row origin-frame gathers (fused_contact.py:566-572)
        il = inv.long()
        lanes = [x[il] for x in lanes]
        frows = [f[il] for f in frows]
    cnt, bad = lanes[0], lanes[1] > 0
    other_T = torch.stack(lanes[2:4]) if with_partner_slots else None

    normal = (cnt > 0) & ~bad & st.alive
    m_n = torch.stack([normal, normal & (cnt >= 2)])
    if epilogue:
        pd_n = _epilogue_pair_data(frows, m_n, normal, cfg)
    else:
        names = ("lon2", "lat2", "u2", "v2", "A2g", "M2g")
        partner_fields = {nm: torch.stack([frows[k], frows[PT_NEVAL + k]])
                          for k, nm in enumerate(names)}
        pd_n = _forces.precompute_pair_data_T(
            st, cfg, m_n, partner_fields=partner_fields, other_T=other_T)
    pd_f, sel_f, vrow_f, stats = _fallback_group(
        st, bad, order, key_s, cell_starts, grid, cfg,
        fallback_cap=fallback_cap,
        fallback_strip_width=fallback_strip_width, radius=radius,
        exclude_same_group=exclude_same_group)
    return pd_n, pd_f, sel_f, vrow_f, stats


def _epilogue_pair_data(frows, m_n, normal, cfg: IcebergsConfig):
    """(2, N) pair data from K2's epilogue rows (``fused_contact.py:
    580-606``): the kernel already decided exact engagement and summed
    the spring accelerations; damping coefficients scale its mass
    ratios."""
    def prow(k):
        return torch.stack([frows[k], frows[EX_EPI_NP + k]])

    # the JAX function takes these square roots in float64 (math.sqrt),
    # rounded to float32 where they multiply
    s = math.sqrt(cfg.contact_spring_coef_eff)
    if cfg.critical_interaction_damping_on:
        rad_d = 2. * s
        tan_d = (2. * s / 4. if cfg.tang_crit_int_damp_on
                 else cfg.tangental_damping_coef)
    else:
        rad_d, tan_d = cfg.radial_damping_coef, cfg.tangental_damping_coef
    mm, ex = prow(5), prow(6)
    return _forces.PairData(
        active=m_n & (ex > 0.5),
        IA_x=torch.where(normal, frows[2 * EX_EPI_NP], 0.),
        IA_y=torch.where(normal, frows[2 * EX_EPI_NP + 1], 0.),
        P11=prow(2), P12=prow(3), P22=prow(4),
        crad=rad_d * mm, ctan=tan_d * mm, u2=prow(0), v2=prow(1))


def _check_legacy(cfg: IcebergsConfig):
    if not cfg.legacy_contact_dispatch:
        raise ValueError("the fused contact searches cover the legacy "
                         "contact dispatch only (no MTS, contact_distance "
                         "or separate contact spring)")


def _bond_group(st, cfg: IcebergsConfig):
    """The bonded spring group over the (N, max_bonds) bond table
    (``fused_contact.py:382-395, 669-680, 836-840``), or None without
    bonds: ``ia(u0, v0, u1, v1) -> IA`` through K7 at M = max_bonds.  The
    JAX fused2 / fused3 closures hold it transposed as (B, N); the sums
    over a row's few over-stretched bonds are the same terms."""
    if not cfg.iceberg_bonds_on:
        return None
    from .pairs import eval_pair_ia_kernel
    other, valid = _forces.bond_partner_table(st)
    pd_b = _forces.precompute_pair_data(st, cfg, other, valid, bonded=True)

    def ia(u0, v0, u1, v1):
        return eval_pair_ia_kernel(pd_b, cfg, u0, v0, u1, v1)
    return ia


def _add(total, bond, u0, v0, u1, v1):
    if bond is None:
        return total
    return IA(*(x + y for x, y in zip(total, bond(u0, v0, u1, v1))))


def make_ia_fn_fused3(st, grid, cfg: IcebergsConfig, *, block_n: int = 128,
                      window: int = 160, fallback_cap: int = 1024,
                      fallback_strip_width: int = 64,
                      presorted: bool = True, cell_starts=None):
    """Interactive-force closure ``ia_fn(u1, v1) -> IA`` over the
    extraction search, plus its ``FusedContactStats``: on a slab that is
    physically (cell, id) sorted (``presorted``), or on a sorted view of
    any slab with the results in its own frame.  Legacy contact dispatch
    only (no MTS, contact_distance or separate contact spring); the
    bonded springs, if any, are added through the bond table."""
    _check_legacy(cfg)
    pd_n, pd_f, sel_f, vrow_f, stats = _extract_groups(
        st, grid, cfg, block_n=block_n, window=window,
        fallback_cap=fallback_cap,
        fallback_strip_width=fallback_strip_width, presorted=presorted,
        cell_starts=cell_starts,
        epilogue=cfg.contact_epilogue and cfg.extract_impl == "gathered")
    u0, v0 = st.uvel, st.vvel
    s = sel_f.long()
    fold = _scatter_fold(sel_f, vrow_f, st.capacity)
    bond = _bond_group(st, cfg)

    def ia_fn(u1, v1):
        bn = _forces.eval_pair_ia_T(pd_n, cfg, u0, v0, u1, v1)
        bf = _forces.eval_pair_ia(pd_f, cfg, u0[s], v0[s], u1[s], v1[s])
        return _add(IA(*(fold(x, f) for x, f in zip(bn, bf))), bond, u0,
                    v0, u1, v1)

    return ia_fn, stats


def make_ia_fn_fused_mts1(st, grid, cfg: IcebergsConfig, *,
                          block_n: int = 256, window: int = 512,
                          fallback_cap: int = 4096,
                          fallback_strip_width: int = 64,
                          radius: int = None):
    """The MTS Part-1 cross-conglomerate collision group (accel_mts
    mts_part=1 -> interactive_force's cross-conglomerate branch,
    icebergs.F90:565-607): crit = max(R1 + R2, contact_distance) with the
    contact spring, searched by K2 with the conglomerate filter over
    (2r+1)-row strips of the unsorted slab, evaluated on an origin-frame
    (2, N) partner table plus the exact strip fallback.

    Returns ``(refresh, stats)``: ``refresh(s) -> ia_fn`` regathers the
    partners' ``*_old`` velocities from ``s`` into the frozen pair
    geometry (the force-convergence loop's contract,
    icebergs.F90:6663-6743)."""
    if not cfg.mts:
        raise ValueError("the mts1 group is the MTS Part-1 collision group")
    if radius is None:
        radius = _forces.neighbor_radius(grid, cfg)
    pd_n, pd_f, sel_f, vrow_f, stats = _extract_groups(
        st, grid, cfg, block_n=block_n, window=window,
        fallback_cap=fallback_cap,
        fallback_strip_width=fallback_strip_width, presorted=False,
        radius=radius, exclude_same_group=True, with_partner_slots=True)
    u0, v0 = st.uvel, st.vvel
    s = sel_f.long()
    fold = _scatter_fold(sel_f, vrow_f, st.capacity)

    def refresh(cur):
        pdn = _forces.refresh_pair_velocities(pd_n, cur)
        pdf = _forces.refresh_pair_velocities(pd_f, cur)

        def ia_fn(u1, v1):
            bn = _forces.eval_pair_ia_T(pdn, cfg, u0, v0, u1, v1)
            bf = _forces.eval_pair_ia(pdf, cfg, u0[s], v0[s], u1[s],
                                      v1[s])
            return IA(*(fold(x, f) for x, f in zip(bn, bf)))

        return ia_fn

    return refresh, stats


def _rank_fold(bad, vrow_f, fallback_cap: int):
    """Fold a compact fallback result back with one rank-table gather per
    field (``x + tab[code_f]``, ``fused_contact.py:161-183``)."""
    rank = torch.cumsum(bad.to(torch.int32), 0, dtype=torch.int32) - 1
    code = torch.where(bad & (rank < fallback_cap), rank,
                       fallback_cap).long()

    def fold(x, f):
        return x + torch.cat([torch.where(vrow_f, f, 0.),
                              f.new_zeros(1)])[code]
    return fold


def make_ia_fn_fused(ss, cell_starts, grid, cfg: IcebergsConfig, *,
                     block_n: int = 128, window: int = 160,
                     fallback_cap: int = 1024,
                     fallback_strip_width: int = 64):
    """Interactive-force closure over the persistent (cell, id)-sorted
    slab ``ss`` through K5 (``_sorted_contact_groups``): bergs with 1-2
    engaged partners on an (N, 2) partner table {pmin, pmax} whose
    fields are gathered from the slab, the rest through the exact strip
    fallback, folded back through a rank table, plus the bonded springs
    through the bond table.  Returns ``(ia_fn, FusedContactStats)``;
    legacy contact dispatch only."""
    _check_legacy(cfg)
    N = ss.capacity
    nx = grid.nx
    ncells = nx * grid.ny
    P, key_s = prepass_features(ss, grid, cfg)
    cnt, pmin, pmax, bad_block = contact_prepass_sorted(
        P, key_s, cell_starts, grid, cfg, block_n=block_n, window=window)
    alive_s = key_s < ncells
    # in a bad block the count itself is untrustworthy (a truncated
    # window can hide partners): every alive berg there takes the fallback
    bad = (bad_block | (cnt > 2)) & alive_s
    normal = (cnt > 0) & ~bad_block & (cnt <= 2) & alive_s
    others_n = torch.stack([pmin.clamp(min=0), pmax.clamp(min=0)], dim=-1)
    m_n = normal[:, None] & torch.stack([pmin >= 0, (pmax >= 0) & (cnt > 1)],
                                        dim=-1)
    pd_n = _forces.precompute_pair_data(ss, cfg, others_n, m_n,
                                        partner_st=ss)

    sel_f, vrow_f, drop_f = _forces.compact_rows(bad, fallback_cap)
    s = sel_f.long()
    sub_f = SimpleNamespace(ine=(key_s % nx)[s],
                            jne=torch.div(key_s, nx,
                                          rounding_mode="floor")[s],
                            alive=alive_s[s])
    cand_f, valid_f, trunc_f = strip_tables(
        sub_f, sel_f, alive_s, N, cell_starts, grid, fallback_strip_width)
    pd_f = _forces.precompute_pair_data(
        _forces.take_rows(ss, sel_f), cfg, cand_f.to(torch.int32),
        valid_f & vrow_f[:, None], partner_st=ss)
    stats = FusedContactStats(overflow=drop_f + trunc_f,
                              n_fallback=bad.sum(dtype=torch.int32))
    fold = _rank_fold(bad, vrow_f, fallback_cap)
    u0, v0 = ss.uvel, ss.vvel
    bond = _bond_group(ss, cfg)

    def ia_fn(u1, v1):
        bn = _forces.eval_pair_ia(pd_n, cfg, u0, v0, u1, v1)
        bf = _forces.eval_pair_ia(pd_f, cfg, u0[s], v0[s], u1[s], v1[s])
        return _add(IA(*(fold(x, f) for x, f in zip(bn, bf))), bond, u0,
                    v0, u1, v1)

    return ia_fn, stats


def _origin_frame_groups(st, grid, cfg: IcebergsConfig, *, block_n, window,
                         fallback_cap, fallback_strip_width, radius=1,
                         exclude_same_group=False):
    """``_origin_frame_search`` + ``_origin_frame_groups``: K5 on the
    (cell, id_cnt, id_ij)-sorted view of ``st``, its partner slots mapped
    back to the origin frame through ``order`` and everything else
    through its inverse; the normal group as a (2, N) partner table
    gathered from ``st`` and the exact fallback compacted in the origin
    frame.  Returns ``(pd_n, pd_f, sel_f, vrow_f, stats)``."""
    N = st.capacity
    ncells = grid.nx * grid.ny
    P, key = prepass_features(st, grid, cfg, exclude_same_group)
    order = lex_cell_id_order(key, st.id_cnt, st.id_ij)
    ol = order.long()
    inv = torch.empty_like(ol)
    inv[ol] = torch.arange(N, device=ol.device)
    key_s = key[ol]
    cell_starts = starts_from_sorted_key(key_s, ncells)
    cnt, pmin, pmax, bad_block = contact_prepass_sorted(
        P[ol], key_s, cell_starts, grid, cfg, block_n=block_n,
        window=window, radius=radius,
        exclude_same_group=exclude_same_group)
    alive_s = key_s < ncells
    bad = (bad_block | (cnt > 2)) & alive_s
    normal = (cnt > 0) & ~bad_block & (cnt <= 2) & alive_s
    p1 = torch.where(normal & (pmin >= 0), order[pmin.clamp(min=0).long()],
                     -1)
    p2 = torch.where(normal & (pmax >= 0) & (cnt > 1),
                     order[pmax.clamp(min=0).long()], -1)
    p1_o, p2_o, bad_o = p1[inv], p2[inv], bad[inv]
    others_T = torch.stack([p1_o.clamp(min=0), p2_o.clamp(min=0)])
    m_T = torch.stack([p1_o >= 0, p2_o >= 0])
    pd_n = _forces.precompute_pair_data_T(st, cfg, m_T, other_T=others_T)
    pd_f, sel_f, vrow_f, stats = _fallback_group(
        st, bad_o, order, key_s, cell_starts, grid, cfg,
        fallback_cap=fallback_cap,
        fallback_strip_width=fallback_strip_width, radius=radius,
        exclude_same_group=exclude_same_group)
    return pd_n, pd_f, sel_f, vrow_f, stats


def make_ia_fn_fused2(st, grid, cfg: IcebergsConfig, *, block_n: int = 128,
                      window: int = 160, fallback_cap: int = 1024,
                      fallback_strip_width: int = 64):
    """Sortless interactive-force closure (the origin slot order) through
    K5 on a sorted view: the state is never reordered, partner slots map
    back once, and the pair evaluation runs on the origin frame.
    Per-berg results equal :func:`make_ia_fn_fused3`'s bit for bit (the
    same partners, the same values, the same arithmetic).  Legacy
    contact dispatch only; bonded springs through the bond table."""
    _check_legacy(cfg)
    pd_n, pd_f, sel_f, vrow_f, stats = _origin_frame_groups(
        st, grid, cfg, block_n=block_n, window=window,
        fallback_cap=fallback_cap,
        fallback_strip_width=fallback_strip_width)
    u0, v0 = st.uvel, st.vvel
    s = sel_f.long()
    fold = _scatter_fold(sel_f, vrow_f, st.capacity)
    bond = _bond_group(st, cfg)

    def ia_fn(u1, v1):
        bn = _forces.eval_pair_ia_T(pd_n, cfg, u0, v0, u1, v1)
        bf = _forces.eval_pair_ia(pd_f, cfg, u0[s], v0[s], u1[s], v1[s])
        return _add(IA(*(fold(x, f) for x, f in zip(bn, bf))), bond, u0,
                    v0, u1, v1)

    return ia_fn, stats

"""Berg-berg contact forces: the cell-binned neighbour search, pair
precompute and evaluation, and the host-side bond setup.

Counterpart of ``icebergs_tpu/ops/forces.py``: ``NeighborTables``,
``bin_bergs``, ``neighbor_radius`` and ``build_neighbor_tables``
(``forces.py:25-140``); ``_interaction_radius``, ``PairData``,
``precompute_pair_data``, ``precompute_pair_data_T``,
``refresh_pair_velocities``, ``eval_pair_ia`` and ``eval_pair_ia_T``
(port of ``calculate_force``, ``src/icebergs.F90:611-804``; pair
separations through the metric factors at the pair's mean latitude on
a lat-lon grid, :func:`..grid.pair_separation`): the contact groups of
the legacy and the modern dispatch (``contact_distance`` crit, separate
contact spring, ``use_c_crit_dist``) and the bonded springs (legacy
bonds pull only when over-stretched); the ``contact_cap`` compaction
(``active_contact_bergs``, ``compacted_contact_pairdata``,
``scatter_ia``), ``pair_forces``, ``bond_partner_table`` and
``make_ia_fn`` with its bond, same-conglomerate and cross-conglomerate
groups, their MTS parts and the Part-1 velocity refresh
(``forces.py:559-769``); the constant interaction area of MTS bonds;
``check_bond_reciprocity``; the driver's host checks
``can_use_quadrant_window`` and
``set_constant_interaction_length_and_width``; and
``initialize_bonds_host``, ``compute_conglom_ids_host`` (numpy, or the
native library of :mod:`..native` above 512 elements) and
``count_bonds``; and the bond id stamps that carry bonds across tiles,
``stamp_bond_ids`` and ``connect_bonds_by_id`` (``forces.py:912-967``).

``*_T`` functions hold pair slabs as (M, N) with the partner axis first
(the fused search's two partners); the plain ones as (N, M) (the exact
fallback's candidate strips).
"""

from __future__ import annotations

import warnings
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as C
from ..config import IcebergsConfig
from ..grid import pair_separation
from .accel import IA, divc, f32_scalar, zero_ia
from .pack import from_bits, permute_cols_u32, to_bits


class NeighborTables(NamedTuple):
    cand_idx: torch.Tensor         # (N, M) candidate partner slots (>= 0)
    cand_valid: torch.Tensor       # (N, M) bool
    is_bond_partner: torch.Tensor  # (N, M) candidate is bonded to this berg


def bin_bergs(st, grid, cfg: IcebergsConfig, max_per_cell: int):
    """Bucket alive bergs by cell (the reference's per-cell linked lists
    as a dense table): ``(buckets (ncells+1, K) int32, counts (ncells+1,)
    int32)``, bergs in slot order within a cell, those beyond ``K``
    dropped from the table and from ``counts``; row ``ncells`` takes the
    dead bergs and stays empty."""
    nx, ny = grid.nx, grid.ny
    ncells = nx * ny
    N = st.capacity
    dev = st.device
    cell = torch.where(st.alive, st.jne * nx + st.ine,
                       ncells).to(torch.int32)
    # jnp.argsort is stable: a berg's rank in its cell follows slot order
    order = torch.argsort(cell, stable=True)
    sorted_cell = cell[order]
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    first = torch.searchsorted(sorted_cell, sorted_cell, side="left")
    rank = torch.empty_like(idx)
    rank[order] = idx - first.to(torch.int32)
    ok = st.alive & (rank < max_per_cell)
    c_safe = torch.where(ok, cell, ncells).long()
    r_safe = torch.where(ok, rank, 0).long()
    buckets = torch.full((ncells + 1, max_per_cell), -1, dtype=torch.int32,
                         device=dev)
    # every row that is not ok writes -1 to (ncells, 0): the duplicates
    # agree, so the unordered put is deterministic
    buckets.index_put_((c_safe, r_safe), torch.where(ok, idx, -1))
    counts = torch.zeros(ncells + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, c_safe, ok.to(torch.int32))
    return buckets, counts


def neighbor_radius(grid, cfg: IcebergsConfig) -> int:
    """Contact-cell search radius in cells (contact_cells from
    contact_distance, icebergs_framework.F90:1493-1527): 2 for the
    same-conglomerate window of the modern dispatch with bonds, 1 on the
    legacy path, widened to cover ``contact_distance``.  Reads the grid
    spacing on the host."""
    r = 2 if (not _legacy(cfg) and cfg.iceberg_bonds_on) else 1
    if cfg.contact_distance > 0.:
        dx = grid.dx[1:-1, 1:-1].detach().cpu().numpy()
        dmin = float(np.min(np.where(dx > 0, dx, np.inf)))
        if dmin > 0 and np.isfinite(dmin):
            r = max(r, int(np.ceil(cfg.contact_distance / dmin)))
    return r


def build_neighbor_tables(st, grid, cfg: IcebergsConfig,
                          max_per_cell: int = 16,
                          ncells_radius: Optional[int] = None,
                          window: str = "full") -> NeighborTables:
    """Candidate partners of every berg: the buckets of its (2r+1)^2
    surrounding cells, or with ``window="quadrant"`` (radius 1 only) the
    2x2 block of cells nearest its position in its cell.  (N, M) tables
    with M = cells x ``max_per_cell``."""
    nx, ny = grid.nx, grid.ny
    ncells = nx * ny
    r = neighbor_radius(grid, cfg) if ncells_radius is None \
        else ncells_radius
    buckets, _ = bin_bergs(st, grid, cfg, max_per_cell)
    if window == "quadrant":
        if r != 1:
            raise ValueError("the quadrant window needs a 3x3-equivalent "
                             "radius")
        sx = torch.where(st.xi >= 0.5, 1, -1).to(torch.int32)
        sy = torch.where(st.yj >= 0.5, 1, -1).to(torch.int32)
        z = torch.zeros_like(sx)
        offsets = [(z, z), (sx, z), (z, sy), (sx, sy)]
    elif window == "full":
        offsets = [(di, dj) for dj in range(-r, r + 1)
                   for di in range(-r, r + 1)]
    else:
        raise ValueError(f"window={window!r}")
    cand = []
    for di, dj in offsets:
        ci = st.ine + di
        cj = st.jne + dj
        ok = (ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny) & st.alive
        cand.append(buckets[torch.where(ok, cj * nx + ci, ncells).long()])
    cand_idx = torch.cat(cand, dim=1)
    self_idx = torch.arange(st.capacity, device=st.device)[:, None]
    valid = (cand_idx >= 0) & (cand_idx != self_idx)
    cand_safe = cand_idx.clamp(min=0)
    valid = valid & st.alive[cand_safe.long()] & st.alive[:, None]
    if cfg.iceberg_bonds_on:
        bonds = torch.where(st.bond_idx >= 0, st.bond_idx, -2)
        is_bonded = (cand_idx[:, :, None] == bonds[:, None, :]).any(-1) \
            & valid
    else:
        is_bonded = torch.zeros_like(valid)
    return NeighborTables(cand_idx=cand_safe, cand_valid=valid,
                          is_bond_partner=is_bonded)


def _interaction_radius(cfg: IcebergsConfig, A):
    """Inscribed-circle radius by packing shape (Stern et al 2017 Eq 4)."""
    if cfg.hexagonal_icebergs:
        return torch.sqrt(divc(A, 2. * f32_scalar(torch.sqrt, 3., A.dtype)))
    if cfg.iceberg_bonds_on:
        return 0.5 * torch.sqrt(A)
    return torch.sqrt(A / C.PI)


def can_use_quadrant_window(st, grid, cfg: IcebergsConfig) -> bool:
    """Host-side check: is the 2x2 quadrant candidate window exact?
    (``icebergs_tpu.ops.forces.can_use_quadrant_window``).  True when
    the largest possible pair cutoff (R1 + R2 of the biggest two bergs,
    or ``contact_distance``) is at most half the smallest cell extent.
    Rolling can widen a berg (W <-> T exchange), so the area is bounded
    by its largest dimension squared."""
    alive = st.alive.cpu().numpy()
    if not alive.any():
        return True

    def host(x):
        return x.cpu().numpy().astype(np.float64)
    dmax_berg = np.maximum(np.maximum(host(st.length), host(st.width)),
                           host(st.thickness))[alive]
    A = torch.as_tensor(dmax_berg ** 2, dtype=st.dtype)
    rmax = float(_interaction_radius(cfg, A).max())
    cutoff = max(2. * rmax, float(cfg.contact_distance))
    dx = grid.dx.cpu().numpy()[1:-1, 1:-1]
    dy = grid.dy.cpu().numpy()[1:-1, 1:-1]
    dmin = float(min(np.min(np.where(dx > 0, dx, np.inf)),
                     np.min(np.where(dy > 0, dy, np.inf))))
    return bool(np.isfinite(dmin) and cutoff <= 0.5 * dmin)


class PairData(NamedTuple):
    """Velocity-independent pair quantities, precomputed once per step."""
    active: torch.Tensor
    IA_x: torch.Tensor       # (N,) spring accel
    IA_y: torch.Tensor
    P11: torch.Tensor        # radial projection per pair
    P12: torch.Tensor
    P22: torch.Tensor
    crad: torch.Tensor       # radial damping coef x (M_min/M1)
    ctan: torch.Tensor
    u2: torch.Tensor         # partner *_old velocity
    v2: torch.Tensor
    # partner slots, kept where u2/v2 are refreshed mid-step (the MTS
    # force-convergence loop; :func:`refresh_pair_velocities`)
    other: Optional[torch.Tensor] = None


def _damping(cfg: IcebergsConfig, spring_coef: float):
    """(radial, tangential) damping coefficients; the critical values
    are float32 square roots as in the reference's weak-typed math (the
    power-of-two scalings are exact either way)."""
    if cfg.critical_interaction_damping_on:
        s = f32_scalar(torch.sqrt, spring_coef)
        radial = 2. * s
        tangental = (2. * s / 4. if cfg.tang_crit_int_damp_on
                     else cfg.tangental_damping_coef)
        return radial, tangental
    return cfg.radial_damping_coef, cfg.tangental_damping_coef


def _legacy(cfg: IcebergsConfig) -> bool:
    return not (cfg.mts or cfg.contact_distance > 0.
                or cfg.contact_spring_coef_eff != cfg.spring_coef)


def _pair_terms(cfg, lon1, lat1, A1, M1, lon2, lat2, A2, M2, mask, u2,
                v2, axis, other=None, bonded=False, use_c_crit_dist=False):
    """The shared geometry / spring / projection chain of both layouts.
    Contact pairs: crit = max(R1 + R2, contact_distance) with the contact
    spring (the legacy dispatch too: ``contact_distance`` 0, contact
    spring = spring), engaged below crit.  Bonded pairs and
    ``use_c_crit_dist``: crit = R1 + R2 with the bond spring; a bond is
    engaged when over-stretched on the legacy dispatch, always on the
    modern one (icebergs.F90:698-703).  The caller gives the areas and
    masses (:func:`_areas_masses`).  ``axis`` is the partner axis the
    spring sums reduce over."""
    r_dist_x, r_dist_y = pair_separation(lon1, lat1, lon2, lat2,
                                         cfg.grid_is_latlon, cfg.Rearth)
    r_dist = torch.sqrt(r_dist_x * r_dist_x + r_dist_y * r_dist_y)
    R1 = _interaction_radius(cfg, A1)
    R2 = _interaction_radius(cfg, A2)
    M_min = torch.minimum(M1, M2)
    if bonded or use_c_crit_dist:
        crit_dist = R1 + R2
        spring_coef = cfg.spring_coef
    else:
        crit_dist = (R1 + R2).clamp(min=cfg.contact_distance)
        spring_coef = cfg.contact_spring_coef_eff
    radial_damping, tangental_damping = _damping(cfg, spring_coef)
    if bonded and _legacy(cfg):
        engaged = r_dist > crit_dist
    elif bonded:
        engaged = torch.ones_like(mask)
    else:
        engaged = r_dist < crit_dist
    active = mask & (r_dist > 0.) & engaged

    rsafe = torch.where(r_dist > 0., r_dist, 1.)
    accel_spring = spring_coef * (M_min / M1) * (crit_dist - r_dist)
    IA_x = torch.where(active, accel_spring * r_dist_x / rsafe,
                       0.).sum(axis)
    IA_y = torch.where(active, accel_spring * r_dist_y / rsafe,
                       0.).sum(axis)
    rs2 = rsafe * rsafe
    mm = M_min / M1
    return PairData(active=active, IA_x=IA_x, IA_y=IA_y,
                    P11=(r_dist_x * r_dist_x) / rs2,
                    P12=(r_dist_x * r_dist_y) / rs2,
                    P22=(r_dist_y * r_dist_y) / rs2,
                    crad=radial_damping * mm, ctan=tangental_damping * mm,
                    u2=u2, v2=v2, other=other)


def _areas_masses(cfg: IcebergsConfig, bonded: bool, T1, A1, M1, T2,
                  A2g, M2g):
    """``(A1, M1, A2, M2)`` of a pair slab: the elements' own, or for MTS
    bonds with ``constant_interaction_LW`` the constant interaction
    area and its mass (``precompute_pair_data``'s ``const_LW``)."""
    if not (cfg.constant_interaction_LW and cfg.mts and bonded):
        return A1, M1, A2g, M2g
    A1 = cfg.constant_length * cfg.constant_width * torch.ones_like(T1)
    A2 = A1.expand(T2.shape)
    return A1, A1 * T1 * cfg.rho_bergs, A2, A2 * T2 * cfg.rho_bergs


def precompute_pair_data(st, cfg: IcebergsConfig, other, mask, *,
                         bonded: bool = False, use_c_crit_dist: bool = False,
                         partner_st=None) -> PairData:
    """(N, M) pair data of primaries ``st`` (any object with the fields
    read here) against ``partner_st`` rows (``st`` by default) ``other``
    (N, M) int32, which the result keeps for
    :func:`refresh_pair_velocities`; ``bonded`` / ``use_c_crit_dist`` as
    the JAX function's."""
    if partner_st is None:
        partner_st = st
    o = other.long()
    fl_k2 = partner_st.fl_k[o]
    mask = mask & (st.fl_k[:, None] != -1.) & (fl_k2 != -1.)
    T1 = st.thickness[:, None]
    A1, M1, A2, M2 = _areas_masses(
        cfg, bonded, T1, (st.length * st.width)[:, None], st.mass[:, None],
        partner_st.thickness[o] if bonded else T1,
        partner_st.length[o] * partner_st.width[o], partner_st.mass[o])
    return _pair_terms(
        cfg, st.lon_old[:, None], st.lat_old[:, None], A1, M1,
        partner_st.lon_old[o], partner_st.lat_old[o], A2, M2,
        mask, partner_st.uvel_old[o], partner_st.vvel_old[o], -1,
        other=other, bonded=bonded, use_c_crit_dist=use_c_crit_dist)


def precompute_pair_data_T(st, cfg: IcebergsConfig, mask_T, *,
                           partner_fields=None, other_T=None,
                           bonded: bool = False,
                           use_c_crit_dist: bool = False) -> PairData:
    """(M, N) pair data with the partners' fields handed in
    (``partner_fields``: (M, N) lon2, lat2, u2, v2, A2g, M2g — the
    extraction kernel's output, whose engagement test already excluded
    fl_k == -1 on both sides), or without them gathered from ``st`` at
    the (M, N) partner slots ``other_T`` with the fl_k == -1 mask.
    ``other_T`` is kept for :func:`refresh_pair_velocities`."""
    T1 = st.thickness[None, :]
    T2 = T1
    if partner_fields is None:
        o = other_T.long()
        mask_T = mask_T & (st.fl_k[None, :] != -1.) & (st.fl_k[o] != -1.)
        partner_fields = dict(
            lon2=st.lon_old[o], lat2=st.lat_old[o], u2=st.uvel_old[o],
            v2=st.vvel_old[o], A2g=st.length[o] * st.width[o],
            M2g=st.mass[o])
        if bonded:
            T2 = st.thickness[o]
    elif cfg.constant_interaction_LW and cfg.mts and bonded:
        raise ValueError("constant_interaction_LW bonds read the partners' "
                         "thickness: gather them (partner_fields=None)")
    pf = partner_fields
    A1, M1, A2, M2 = _areas_masses(
        cfg, bonded, T1, (st.length * st.width)[None, :], st.mass[None, :],
        T2, pf["A2g"], pf["M2g"])
    return _pair_terms(
        cfg, st.lon_old[None, :], st.lat_old[None, :], A1, M1,
        pf["lon2"], pf["lat2"], A2, M2, mask_T,
        pf["u2"], pf["v2"], 0, other=other_T, bonded=bonded,
        use_c_crit_dist=use_c_crit_dist)


def refresh_pair_velocities(pd: PairData, st) -> PairData:
    """Regather the partners' ``*_old`` velocities into frozen pair
    geometry (the MTS Part-1 convergence loop, icebergs.F90:6663-6743:
    positions stay frozen, only the velocities iterate).  Both columns
    move in one K1 pass (``permute_cols_u32``) as the JAX package's
    packed u32 transport moves them; bitwise a gather."""
    moved = permute_cols_u32([to_bits(st.uvel_old), to_bits(st.vvel_old)],
                             pd.other.reshape(-1))
    shape = pd.other.shape
    return pd._replace(u2=from_bits(moved[0], st.uvel_old.dtype
                                    ).reshape(shape),
                       v2=from_bits(moved[1], st.vvel_old.dtype
                                    ).reshape(shape))


def _eval(pd: PairData, cfg: IcebergsConfig, u0, v0, u1, v1, axis):
    P11, P12, P22 = pd.P11, pd.P12, pd.P22
    u2, v2 = pd.u2, pd.v2

    def pmag(P11, P12, P22, coef):
        if not cfg.scale_damping_by_pmag:
            return coef
        du1, dv1 = u2 - u1, v2 - v1
        du0, dv0 = u2 - u0, v2 - v0
        a1 = P11 * du1 + P12 * dv1
        b1 = P12 * du1 + P22 * dv1
        a0 = P11 * du0 + P12 * dv0
        b0 = P12 * du0 + P22 * dv0
        m1 = torch.sqrt(a1 * a1 + b1 * b1)
        m0 = torch.sqrt(a0 * a0 + b0 * b0)
        return coef * 0.5 * (m1 + m0)

    wr = torch.where(pd.active, pmag(P11, P12, P22, pd.crad), 0.)
    wt = torch.where(pd.active, pmag(1. - P11, -P12, 1. - P22, pd.ctan), 0.)
    D11 = wr * P11 + wt * (1. - P11)
    D12 = wr * P12 + wt * (-P12)
    D22 = wr * P22 + wt * (1. - P22)
    oP12 = D12.sum(axis)
    return IA(IA_x=pd.IA_x, IA_y=pd.IA_y, P11=D11.sum(axis), P12=oP12,
              P21=oP12, P22=D22.sum(axis),
              Pu_x=(D11 * u2 + D12 * v2).sum(axis),
              Pu_y=(D12 * u2 + D22 * v2).sum(axis))


def eval_pair_ia(pd: PairData, cfg: IcebergsConfig, u0, v0, u1, v1) -> IA:
    """Velocity-dependent part of calculate_force on (N, M) slabs."""
    return _eval(pd, cfg, u0[:, None], v0[:, None], u1[:, None],
                 v1[:, None], -1)


def eval_pair_ia_T(pd: PairData, cfg: IcebergsConfig, u0, v0, u1,
                   v1) -> IA:
    """(M, N)-layout twin of :func:`eval_pair_ia`."""
    return _eval(pd, cfg, u0[None, :], v0[None, :], u1[None, :],
                 v1[None, :], 0)


def active_contact_bergs(st, cfg: IcebergsConfig, other, mask,
                         use_c_crit_dist: bool = False):
    """Which bergs have any engaged (r < crit) candidate: the cheap pass
    in front of the ``contact_cap`` compaction (r^2 against crit^2, crit
    = max(R1 + R2, contact_distance), or R1 + R2 with
    ``use_c_crit_dist``)."""
    o = other.long()
    mask = mask & (st.fl_k[:, None] != -1.) & (st.fl_k[o] != -1.)
    rx, ry = pair_separation(st.lon_old[:, None], st.lat_old[:, None],
                             st.lon_old[o], st.lat_old[o],
                             cfg.grid_is_latlon, cfg.Rearth)
    r2 = rx * rx + ry * ry
    R1 = _interaction_radius(cfg, (st.length * st.width)[:, None])
    R2 = _interaction_radius(cfg, st.length[o] * st.width[o])
    crit = R1 + R2
    if not use_c_crit_dist:
        crit = crit.clamp(min=cfg.contact_distance)
    return (mask & (r2 > 0.) & (r2 < crit * crit)).any(dim=1)


_TAKE_FIELDS = ("lon_old", "lat_old", "fl_k", "uvel_old", "vvel_old",
                "thickness", "length", "width", "mass")


def take_rows(st, sel):
    """The rows ``sel`` of the fields :func:`precompute_pair_data` reads
    of its primaries (a compact primary view)."""
    s = sel.long()
    return SimpleNamespace(**{f: getattr(st, f)[s] for f in _TAKE_FIELDS})


def compact_rows(flag, cap: int):
    """Rank-compact the True rows of ``flag`` into ``[0, cap)``: returns
    ``(sel, valid_row, n_dropped)``, ``sel`` ascending."""
    N = flag.shape[0]
    dev = flag.device
    rank = torch.cumsum(flag.to(torch.int32), 0, dtype=torch.int32) - 1
    granted = flag & (rank < cap)
    buf = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    buf.index_copy_(0, torch.where(granted, rank, cap).long(),
                    torch.arange(N, dtype=torch.int32, device=dev))
    valid_row = torch.arange(cap, device=dev) < granted.sum(
        dtype=torch.int32)
    return buf[:cap], valid_row, (flag & ~granted).sum(dtype=torch.int32)


def compacted_contact_pairdata(st, cfg: IcebergsConfig, other, mask, *,
                               cap: int, use_c_crit_dist: bool = False):
    """Pair data of the bergs with an engaged candidate, rank-compacted
    into ``cap`` rows.  Returns ``(pd, sel, valid_row, overflow)``:
    ``sel`` maps compact rows to slots, ``overflow`` counts the engaged
    bergs beyond the cap (dropped)."""
    sel, valid_row, overflow = compact_rows(
        active_contact_bergs(st, cfg, other, mask, use_c_crit_dist), cap)
    s = sel.long()
    pd = precompute_pair_data(take_rows(st, sel), cfg, other[s],
                              mask[s] & valid_row[:, None],
                              use_c_crit_dist=use_c_crit_dist,
                              partner_st=st)
    return pd, sel, valid_row, overflow


def scatter_ia(ia_sub: IA, sel, valid_row, N: int) -> IA:
    """A compact-subset IA back in full-length fields (zeros elsewhere);
    invalid rows go to a dump row."""
    tgt = torch.where(valid_row, sel, N).long()

    def put(a):
        out = a.new_zeros(N + 1)
        out.index_copy_(0, tgt, torch.where(valid_row, a, 0.))
        return out[:N]
    return IA(*(put(x) for x in ia_sub))


def bond_partner_table(st):
    """(N, B) partner slots and validity from the bond table."""
    other = st.bond_idx.clamp(min=0)
    valid = (st.bond_idx >= 0) & st.alive[:, None] & st.alive[other.long()]
    return other, valid


def pair_forces(st, cfg: IcebergsConfig, other, mask, *, bonded: bool,
                use_c_crit_dist: bool, u0, v0, u1, v1) -> IA:
    """Vectorized ``calculate_force`` (icebergs.F90:610-804): spring and
    damping sums over (N, M) candidate pairs, evaluated through K7 (the
    plain :func:`eval_pair_ia` for CPU tensors)."""
    from .pairs import eval_pair_ia_kernel
    pd = precompute_pair_data(st, cfg, other, mask, bonded=bonded,
                              use_c_crit_dist=use_c_crit_dist)
    return eval_pair_ia_kernel(pd, cfg, u0, v0, u1, v1)


def make_ia_fn(st, nbr: NeighborTables, cfg: IcebergsConfig, *,
               mts_part: int = 0, contact_cap: Optional[int] = None,
               return_refresh: bool = False):
    """The interactive-force closure ``ia_fn(u1, v1) -> IA`` over
    candidate tables, with the dispatch of ``interactive_force``
    (icebergs.F90:479-607): on the legacy dispatch the all-pairs contact
    group, then the bond group; on the modern one the bond group and the
    same-conglomerate non-bonded contact group (``use_c_crit_dist``),
    then the cross-conglomerate contact group.  Under MTS ``mts_part``
    picks: 3 the bond and same-conglomerate groups (the inner substeps),
    1 the cross-conglomerate group (Part 1), 0 none (a zero IA).  The
    groups are summed in that order, each evaluated through K7
    (:func:`.pairs.eval_pair_ia_kernel`; the bond group at M =
    ``max_bonds``; the plain :func:`eval_pair_ia` for CPU tensors).
    ``contact_cap`` first compacts each contact group's bergs with an
    engaged candidate into that many rows, and the result's ``overflow``
    then counts the engaged bergs it dropped (the JAX package drops them
    uncounted).

    ``return_refresh=True`` returns ``refresh(s) -> ia_fn`` instead: the
    pair geometry is computed here (positions frozen) and each call
    regathers only the partners' ``*_old`` velocities from ``s`` (the
    MTS Part-1 convergence loop, icebergs.F90:6663-6743)."""
    from .pairs import eval_pair_ia_kernel as ev
    u0, v0 = st.uvel, st.vvel
    N = st.capacity
    groups = []          # (pd, sel or None, valid_row)
    overflow = []

    def add_contact(m, c_crit):
        if contact_cap is None:
            groups.append((precompute_pair_data(
                st, cfg, nbr.cand_idx, m, use_c_crit_dist=c_crit), None,
                None))
            return
        pd, sel, vrow, ov = compacted_contact_pairdata(
            st, cfg, nbr.cand_idx, m, cap=contact_cap,
            use_c_crit_dist=c_crit)
        groups.append((pd, sel, vrow))
        overflow.append(ov)

    def add_bonds():
        other, valid = bond_partner_table(st)
        groups.append((precompute_pair_data(st, cfg, other, valid,
                                            bonded=True), None, None))

    if _legacy(cfg):
        add_contact(nbr.cand_valid, False)
        if cfg.iceberg_bonds_on:
            add_bonds()
    else:
        cong = st.conglom_id
        same = cong[:, None] == cong[nbr.cand_idx.long()]
        if (not cfg.mts or mts_part == 3) and cfg.iceberg_bonds_on:
            add_bonds()
            add_contact(nbr.cand_valid & same & ~nbr.is_bond_partner, True)
        if not cfg.mts or mts_part == 1:
            add_contact(nbr.cand_valid & ~same, False)

    def make(gs):
        def ia_fn(u1, v1):
            total = None
            for pd, sel, vrow in gs:
                if sel is None:
                    b = ev(pd, cfg, u0, v0, u1, v1)
                else:
                    s = sel.long()
                    b = scatter_ia(ev(pd, cfg, u0[s], v0[s], u1[s], v1[s]),
                                   sel, vrow, N)
                total = b if total is None else IA(*(x + y for x, y
                                                     in zip(total, b)))
            return zero_ia(u0) if total is None else total
        return ia_fn

    if return_refresh:
        def out(s):
            return make([(refresh_pair_velocities(pd, s), sel, vrow)
                         for pd, sel, vrow in groups])
    else:
        out = make(groups)
    out.overflow = (None if not overflow
                    else torch.stack(overflow).sum(dtype=torch.int32))
    return out


def check_bond_reciprocity(st):
    """The number of live directed bonds whose partner holds no bond back
    (count_bonds' check_bond_quality branch,
    icebergs_framework.F90:4860-4941); 0 is healthy.  A 0-dim int32."""
    hasb = st.bond_idx >= 0
    other = st.bond_idx.clamp(min=0).long()
    me = torch.arange(st.capacity, dtype=st.bond_idx.dtype,
                      device=st.device)[:, None, None]
    back = (st.bond_idx[other] == me).any(-1)
    return (hasb & ~back & st.alive[:, None]).sum(dtype=torch.int32)


# --------------------------------------------------------------------------
# bond setup (host side, at init)
# --------------------------------------------------------------------------

def set_constant_interaction_length_and_width(cfg: IcebergsConfig, st):
    """Fill ``constant_length`` / ``constant_width`` from the mean live
    element (set_constant_interaction_length_and_width,
    icebergs_framework.F90:4641-4671), when ``constant_interaction_LW``
    is on and the namelist left either at 0 (icebergs.F90:175-177).
    Host side; returns the updated config.  The means are numpy's sums
    of the float32 host copies, as the JAX package takes them: another
    association moves ``constant_length`` by an ulp, and with it every
    DEM radius."""
    if not cfg.constant_interaction_LW or (cfg.constant_length != 0.
                                           and cfg.constant_width != 0.):
        return cfg
    alive = st.alive.cpu().numpy()
    n = max(int(alive.sum()), 1)
    return cfg.replace(
        constant_length=float(st.length.cpu().numpy()[alive].sum() / n),
        constant_width=float(st.width.cpu().numpy()[alive].sum() / n))


def _native_or_numpy(what: str, n: int, limit):
    """The native library for ``n`` elements, or None where the numpy
    route takes the size (``limit``; None: any size) and the library
    does not build, with a warning naming the compiler's error."""
    from .. import native
    try:
        native.library()
        return native
    except RuntimeError as e:
        if limit is not None and n > limit:
            raise RuntimeError(f"{what} of {n} elements needs the native "
                               f"library (the numpy route holds at most "
                               f"{limit}): {e}") from e
        warnings.warn(f"{what}: the native library did not build, the "
                      f"numpy route runs instead: {e}")
        return None


def initialize_bonds_host(st, cfg: IcebergsConfig, max_pairwise=8192):
    """Form bonds between nearby bergs (initialize_iceberg_bonds,
    icebergs.F90:355-442): bond when the distance is below
    ``length_for_manually_initialize_bonds`` or, with the radius
    criterion, below 1.25 x (R1 + R2); partners in slot order, at most
    ``max_bonds`` each.  Then labels conglomerates
    (:func:`compute_conglom_ids_host`).

    Host side.  Above :data:`..native.MIN_ELEMENTS` live bergs the
    cell-hashed native library forms them, in O(n), as the JAX package
    does; else numpy on the O(n^2) pairwise matrix, which also serves up
    to ``max_pairwise`` bergs when the library does not build (with a
    warning; beyond that it raises)."""
    from .. import native
    alive = st.alive.cpu().numpy()
    n = int(alive.sum())
    idx = np.nonzero(alive)[0]

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)[idx]

    lon, lat, L, W = host(st.lon), host(st.lat), host(st.length), \
        host(st.width)
    A = L * W
    R = (np.sqrt(A / (2. * np.sqrt(3.))) if cfg.hexagonal_icebergs
         else 0.5 * np.sqrt(A))
    B = st.max_bonds
    bond_idx = np.full((st.capacity, B), -1, np.int32)
    bond_len = np.zeros((st.capacity, B))
    nb = np.zeros((st.capacity,))
    lib = (_native_or_numpy("bond formation", n, max_pairwise)
           if n > native.MIN_ELEMENTS else None)
    if lib is not None:
        crit_const = (-1.0 if cfg.manually_initialize_bonds_from_radii
                      else cfg.length_for_manually_initialize_bonds)
        bi, blen, nbv = lib.bond_init(lon, lat, R, crit_const,
                                      cfg.grid_is_latlon, cfg.Rearth, B)
        # compact row / partner indices back to state slots
        bond_idx[idx] = np.where(bi >= 0, idx[np.clip(bi, 0, None)], -1)
        bond_len[idx] = blen
        nb[idx] = np.minimum(nbv, B)
    else:
        lat_ref = 0.5 * (lat[:, None] + lat[None, :])
        if cfg.grid_is_latlon:
            dxl = (np.pi / 180.) * cfg.Rearth * np.cos(
                (np.pi / 180.) * lat_ref)
            dyl = (np.pi / 180.) * cfg.Rearth
        else:
            dxl = np.ones_like(lat_ref)
            dyl = 1.0
        rx = (lon[:, None] - lon[None, :]) * dxl
        ry = (lat[:, None] - lat[None, :]) * dyl
        r = np.hypot(rx, ry)
        np.fill_diagonal(r, np.inf)
        if cfg.manually_initialize_bonds_from_radii:
            crit = 1.25 * (R[:, None] + R[None, :])
        else:
            crit = cfg.length_for_manually_initialize_bonds
        pairs = r < crit
        for a in range(n):
            partners = np.nonzero(pairs[a])[0]
            for k, b in enumerate(partners[:B]):
                bond_idx[idx[a], k] = idx[b]
                bond_len[idx[a], k] = r[a, b]
            nb[idx[a]] = min(len(partners), B)
    dev, dt = st.device, st.dtype
    st = st.replace(bond_idx=torch.as_tensor(bond_idx, device=dev),
                    bond_length=torch.as_tensor(bond_len).to(dev, dt),
                    n_bonds=torch.as_tensor(nb).to(dev, dt))
    return compute_conglom_ids_host(st)


def compute_conglom_ids_host(st):
    """Label bonded conglomerates (set_conglom_ids,
    icebergs_framework.F90:2737): the connected components of the bond
    graph, each a positive label shared by its members; unbonded bergs
    get singleton labels.  Host side: above
    :data:`..native.MIN_ELEMENTS` slots the native union-find (bonded
    components numbered from 1 in order of first appearance, the
    unbonded bergs after them, as the JAX package labels them there),
    else scipy's connected components numbered from 1 (and there when
    the library does not build, with a warning)."""
    from .. import native
    N = st.capacity
    bond_idx = st.bond_idx.cpu().numpy()
    lib = (_native_or_numpy("conglomerate labels", N, None)
           if N > native.MIN_ELEMENTS else None)
    if lib is not None:
        labels = lib.conglom_label(bond_idx).astype(np.int64)
        unb = labels == 0
        labels[unb] = labels.max() + 1 + np.arange(int(unb.sum()))
    else:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components
        m = bond_idx >= 0
        rows = np.nonzero(m)[0]
        cols = bond_idx[m]
        g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(N, N))
        _, labels = connected_components(g, directed=False)
        labels = labels + 1
    return st.replace(conglom_id=torch.as_tensor(
        labels.astype(np.int32), device=st.device))


def count_bonds(st):
    """Refresh n_bonds from the bond table (count_bonds,
    icebergs_framework.F90:4860)."""
    dem_alive = (st.bond_idx >= 0) & (st.bond_broken != 1)
    return st.replace(n_bonds=dem_alive.sum(dim=1).to(st.dtype))


def stamp_bond_ids(st):
    """Fill (bond_id_cnt, bond_id_ij) from the current partner slots, so
    that bonds survive a redistribution (the pack side of the
    reference's bond serialization, icebergs_framework.F90:3250-3381).
    A slot with ``bond_idx < 0`` keeps its stamp: a cleared index means
    "partner not connected here", not "no bond"."""
    other = st.bond_idx.clamp(min=0).long()
    hasb = st.bond_idx >= 0
    return st.replace(
        bond_id_cnt=torch.where(hasb, st.id_cnt[other], st.bond_id_cnt),
        bond_id_ij=torch.where(hasb, st.id_ij[other], st.bond_id_ij))


def _lex_key(cnt, ij):
    """int64 keys ordered as (cnt, ij) lexicographically, both signed."""
    return cnt.to(torch.int64) * (1 << 32) + (ij.to(torch.int64) + (1 << 31))


def connect_bonds_by_id(st):
    """Re-match the bond partner slots from the (bond_id_cnt, bond_id_ij)
    stamps against every live slot (``connect_all_bonds``,
    icebergs_framework.F90:4713-...): after bergs moved between tiles the
    slot indices are stale.  The JAX package's two stable argsorts (by
    id_ij, then id_cnt; dead slots last) and binary search: a stamp
    names the first live slot of its id in that order, the lowest."""
    N, B = st.bond_idx.shape
    has = ((st.bond_id_cnt != 0) | (st.bond_id_ij != 0)) & st.alive[:, None]
    dead = torch.full_like(st.id_cnt, 2147483647)
    key = _lex_key(torch.where(st.alive, st.id_cnt, dead), st.id_ij)
    ks, order = torch.sort(key, stable=True)
    q = _lex_key(st.bond_id_cnt, st.bond_id_ij)
    pos = torch.searchsorted(ks, q.reshape(-1)).reshape(N, B).clamp(max=N - 1)
    found = ks[pos] == q
    slot = order[pos].to(torch.int32)
    return st.replace(bond_idx=torch.where(has & found, slot, -1).to(
        torch.int32))

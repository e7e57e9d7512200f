"""Mass spreading of bergs onto the ocean grid + derived gridded fields.

Counterpart of ``icebergs_tpu/ops/spread.py`` (``berg_spread_mass``,
``find_orientation_using_iceberg_bonds``, ``spread_weights``' rectangle
and hexagon branches, ``make_sort_ctx``,
``scatter9_slots``, ``scatter_cell_deterministic``, ``_scatter9_packed``,
``calculate_mass_on_ocean``, ``create_gridded_icebergs_fields``,
``sum_slots``, ``_gridded_epilogue``; port of ``src/icebergs.F90:
3390-3491, 3895-4243, 4970-5013``).  Every berg's 9 weighted products and
its own cell's columns are summed per owning cell, shifted into the 9
neighbour slots of each cell and summed in the reference's fixed slot
order.  The per-cell sums take one of the JAX package's associations:

- ``slot_sum_method="pallas"`` (with ``parallel_reprod``): K3
  (:mod:`.segment_spread`) on its own payload, sequential in (cell, id)
  order, or the slot tree when a block overflows the TPU kernel's window;
  K3 builds in the rectangle weights, so hexagonal elements take
  ``"scatter"`` instead, as in the JAX package;
- ``"scatter"``, and ``"scatter_t"`` on a presorted slab: the slot tree
  (ranks k < K-1 in slot k, the rest added into slot K-1 in (cell, id)
  order, a pairwise tree over K = ``reprod_max_per_cell``);
- ``"scatter_t"`` on an unsorted slab: the same tree, slot K-1 adding its
  rows in the slab's own order (the XLA scatter's update order);
- ``"gather"`` and ``"gather_raw"`` (the same bits): a tree over each
  block of K rows, the blocks added in order;
- ``"gather_mm"``: each block's weight x value products contracted by
  ``einsum`` (a different association, within a float tolerance of the
  JAX package's matmul), its cell columns as ``"gather"``;
- ``parallel_reprod=False``: one accumulating scatter, in no fixed order.

Each berg's 9 weights are scaled by its ``I_fraction_used`` (1 for
rectangles; for hexagons the inverse of the wet share of its footprint)
before any sum, as the JAX package scales them.  Cells with at most K
bergs get the same bits from every reproducing method.  No reproducing method uses atomics: the per-row products are
PyTorch elementwise ops, the block trees and slot placements write each
slot once, and the sequential sums run in K3 with the association fixed
(:func:`.segment_spread.segment_sums`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as C
from ..config import IcebergsConfig
from ..grid import convert_from_grid_to_meters
from . import segment_spread as ss
from .accel import rdiv
from .dem import tdiv
from .hexagon import hexagon_into_quadrants_using_triangles, slot_sum
from .pack import from_bits, permute_cols_u32, to_bits
from .sorted import lex_cell_id_order, starts_from_sorted_key
from .thermo import fl_bits_dimensions


# K3's overflow rule, as the JAX package's PALLAS_SPREAD_CB /
# PALLAS_SPREAD_WINDOW (icebergs_tpu/ops/spread.py:779-780) set it: the
# TPU kernel's cells per block and window rows (None = its auto window).
# Read at each call, so that a test can force the overflow association in
# both packages the same way
SPREAD_CB = 128
SPREAD_WINDOW = None


class SpreadDiags(NamedTuple):
    spread_mass: torch.Tensor     # (nx+2, ny+2) kg/m2
    spread_area: torch.Tensor
    spread_uvel: torch.Tensor
    spread_vvel: torch.Tensor
    ustar_iceberg: torch.Tensor
    mass_on_ocean: torch.Tensor   # kg per cell
    u_iceberg: torch.Tensor
    v_iceberg: torch.Tensor
    mass: torch.Tensor
    virtual_area: torch.Tensor
    bergy_mass: torch.Tensor
    fl_bits_mass: torch.Tensor
    fl_bergy_bits_mass: torch.Tensor


def berg_spread_mass(st, grid, frc, cfg: IcebergsConfig):
    """Per-berg total mass to spread, incl. grounding trim and clipping
    (icebergs.F90:3929-3958; the reference's local rho_seawater = 1035)."""
    rho_sw = 1035.0
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    Mass_berg = st.mass
    Mfl = st.mass_of_fl_bits
    if cfg.grounding_fraction > 0.:
        Hocean = cfg.grounding_fraction * (grid.ocean_depth[I, J]
                                           + frc.ssh[I, J])
        Dn = (cfg.rho_bergs / rho_sw) * st.thickness
        trim = (Hocean / Dn.clamp(min=1e-30)).clamp(max=1.)
        Mass_berg = torch.where(Dn > Hocean, Mass_berg * trim, Mass_berg)
        Lfl, Wfl, Tfl = fl_bits_dimensions(cfg, st.thickness)
        Dnf = (cfg.rho_bergs / rho_sw) * Tfl
        trimf = (Hocean / Dnf.clamp(min=1e-30)).clamp(max=1.)
        Mfl = torch.where((Mfl > 0.) & (Dnf > Hocean), Mfl * trimf, Mfl)
    Mass = (Mass_berg + Mfl + st.mass_of_bits
            + st.mass_of_fl_bergy_bits) * st.mass_scaling
    if cfg.clipping_depth > 0.:
        Mass = torch.minimum(Mass, cfg.clipping_depth * grid.area[I, J]
                             * rho_sw)
    return Mass


def sum_slots(out9):
    """Fixed-order sum over the 9 slots (sum_up_spread_fields,
    icebergs.F90:6077-6152): a list of F (nx+2, ny+2) fields."""
    acc = out9[:, :, 0, :]
    for k in range(1, 9):
        acc = acc + out9[:, :, k, :]
    return [acc[..., f] for f in range(out9.shape[-1])]


def find_orientation_using_iceberg_bonds(st, cfg: IcebergsConfig,
                                         orientation):
    """Each element's hexagon orientation from its bonds' directions
    (find_orientation_using_iceberg_bonds, icebergs.F90:3829-3894): the
    mean over its intact bonds to live partners (``bond_idx >= 0``, both
    ends alive) of each bond's angle, mod pi/3.

    Bug-compatible with the reference and the JAX package: the angle is
    in radians, but the hexagon rotation takes degrees
    (rotate_and_translate, icebergs.F90:4537)."""
    other = st.bond_idx.clamp(min=0).long()
    valid = (st.bond_idx >= 0) & st.alive[:, None] & st.alive[other]
    lat1, lon1 = st.lat[:, None], st.lon[:, None]
    lat2, lon2 = st.lat[other], st.lon[other]
    dx_dlon, dy_dlat = convert_from_grid_to_meters(
        0.5 * (lat1 + lat2), cfg.grid_is_latlon, cfg.Rearth)
    rx = (lon2 - lon1) * dx_dlon
    ry = (lat2 - lat1) * dy_dlat
    halfpi = C.PI / 2.
    ang = torch.where(
        rx == 0., halfpi,
        torch.remainder((halfpi - orientation[:, None] * (C.PI / 180.))
                        - torch.atan(ry / torch.where(rx == 0., 1., rx)),
                        C.PI / 3.))
    cnt = valid.sum(dim=1).to(st.dtype)
    avg = slot_sum(torch.where(valid, ang, 0.), 1) / cnt.clamp(min=1.)
    return torch.where(cnt > 0., torch.remainder(avg, C.PI / 3.),
                       torch.remainder(torch.zeros_like(avg), C.PI / 3.))


def spread_weights(st, grid, cfg: IcebergsConfig):
    """Per-berg 3x3 spreading weights (9, N), (dj, di) row-major, and the
    inverse of the footprint's wet fraction, ``I_fraction_used`` (N,):
    the rectangle model (icebergs.F90:3960-4001; ones) or the hexagon
    model (icebergs.F90:4003-4090)."""
    x, y = st.xi, st.yj
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    msk = grid.msk
    area_cell = grid.area[I, J]
    Area = st.length * st.width
    m = {(di, dj): msk[I + di, J + dj]
         for dj in (-1, 0, 1) for di in (-1, 0, 1)}
    if cfg.hexagonal_icebergs:
        return _hexagon_weights(st, cfg, x, y, m, Area, area_cell)
    if cfg.use_old_spreading:
        xL = (0.5 - x).clamp(min=0.).clamp(max=0.5)
        xR = (x - 0.5).clamp(min=0.).clamp(max=0.5)
        yD = (0.5 - y).clamp(min=0.).clamp(max=0.5)
        yU = (y - 0.5).clamp(min=0.).clamp(max=0.5)
    else:
        L = torch.where(area_cell > 0.,
                        torch.sqrt(Area / area_cell.clamp(min=1e-30)
                                   ).clamp(max=1.0), 1.0)
        Ls = L.clamp(min=1e-30)
        inv = rdiv(1., Ls)
        xL = (0.5 - x / Ls).clamp(min=0.).clamp(max=0.5)
        xR = (x / Ls + (0.5 - inv)).clamp(min=0.).clamp(max=0.5)
        yD = (0.5 - y / Ls).clamp(min=0.).clamp(max=0.5)
        yU = (y / Ls + (0.5 - inv)).clamp(min=0.).clamp(max=0.5)
    xC = (1. - (xL + xR)).clamp(min=0.)
    yC = (1. - (yD + yU)).clamp(min=0.)
    yDxL = yD * xL * m[(-1, -1)]
    yDxC = yD * xC * m[(0, -1)]
    yDxR = yD * xR * m[(1, -1)]
    yCxL = yC * xL * m[(-1, 0)]
    yCxR = yC * xR * m[(1, 0)]
    yUxL = yU * xL * m[(-1, 1)]
    yUxC = yU * xC * m[(0, 1)]
    yUxR = yU * xR * m[(1, 1)]
    yCxC = 1. - (((yDxL + yUxR) + (yDxR + yUxL))
                 + ((yCxL + yCxR) + (yDxC + yUxC)))
    return (torch.stack([yDxL, yDxC, yDxR, yCxL, yCxC, yCxR, yUxL, yUxC,
                         yUxR]), torch.ones_like(x))


def _hexagon_weights(st, cfg, x, y, m, Area, area_cell):
    """The hexagon model: the quadrant areas of a hexagon of the berg's
    area around the cell corner nearest to it, each quadrant's share in
    the cell it covers (unmasked), and ``I_fraction_used`` from the wet
    cells' shares (the centre's as ``yCxC ** msk``, as the reference and
    the JAX package write it, so a land centre counts 1)."""
    orientation = torch.full_like(x, cfg.initial_orientation)
    if cfg.iceberg_bonds_on and cfg.rotate_icebergs_for_mass_spreading:
        orientation = find_orientation_using_iceberg_bonds(st, cfg,
                                                           orientation)
    H = torch.where(area_cell > 0.,
                    (torch.sqrt(tdiv(Area, 2. * math.sqrt(3.)))
                     / torch.sqrt(area_cell.clamp(min=1e-30))).clamp(max=1.),
                    (math.sqrt(3.) / 2.) * 0.49)
    x0 = x - torch.where(x < 0.5, 0., 1.)
    y0 = y - torch.where(y < 0.5, 0., 1.)
    A_hex, Q1, Q2, Q3, Q4 = hexagon_into_quadrants_using_triangles(
        x0, y0, H, orientation)
    Ah = A_hex.clamp(min=1e-30)
    Q1, Q2, Q3, Q4 = Q1 / Ah, Q2 / Ah, Q3 / Ah, Q4 / Ah
    right, top = x >= 0.5, y >= 0.5
    z = torch.zeros_like(x)
    # each quadrant to the cell it covers, by the nearest corner
    # (icebergs.F90:4043-4064)
    yUxR = torch.where(right & top, Q1, z)
    yUxC = torch.where(right & top, Q2, torch.where(~right & top, Q1, z))
    yUxL = torch.where(~right & top, Q2, z)
    yCxL = torch.where(~right & top, Q3, torch.where(~right & ~top, Q2, z))
    yCxC = torch.where(right & top, Q3,
                       torch.where(~right & top, Q4,
                                   torch.where(~right & ~top, Q1, Q2)))
    yCxR = torch.where(right & top, Q4, torch.where(right & ~top, Q1, z))
    yDxL = torch.where(~right & ~top, Q3, z)
    yDxC = torch.where(~right & ~top, Q4, torch.where(right & ~top, Q3, z))
    yDxR = torch.where(right & ~top, Q4, z)
    frac = (yDxL * m[(-1, -1)] + yDxC * m[(0, -1)] + yDxR * m[(1, -1)]
            + yCxL * m[(-1, 0)] + yCxR * m[(1, 0)] + yUxL * m[(-1, 1)]
            + yUxC * m[(0, 1)] + yUxR * m[(1, 1)]
            + torch.pow(yCxC, m[(0, 0)]))
    frac = torch.where(st.static_berg == 1., 1., frac)
    return (torch.stack([yDxL, yDxC, yDxR, yCxL, yCxC, yCxR, yUxL, yUxC,
                         yUxR]), rdiv(1., frac.clamp(min=1e-30)))


def make_sort_ctx(st, grid, alive=None):
    """``(order, key_s, rank)`` of the reproducing scatters: the (cell,
    id) order, the sorted cell keys (dead rows ncells, last) and each
    sorted row's rank in its cell; int32."""
    ncells = grid.nx * grid.ny
    if alive is None:
        alive = st.alive
    key = torch.where(alive, st.jne * grid.nx + st.ine,
                      ncells).to(torch.int32)
    order = lex_cell_id_order(key, st.id_cnt, st.id_ij)
    key_s = key[order.long()]
    return order, key_s, sorted_ranks(key_s, ncells)


def sorted_ranks(key_s, ncells: int):
    """Each sorted row's rank in its cell (int32)."""
    starts = starts_from_sorted_key(key_s, ncells)
    return (torch.arange(key_s.shape[0], dtype=torch.int32,
                         device=key_s.device)
            - starts[key_s.clamp(max=ncells).long()])


def _block_trees(cols_s, key_s, rank, ncells: int, K: int, mm_rows=None):
    """Blocks of K consecutive rows of each cell (rank // K): each
    block's tree over its K slots, zero-padded, in (cell, block) order;
    with ``mm_rows = (w9, vals)`` (sorted rows) the block's 9 x F
    products first, contracted over the block by ``einsum``.  Returns
    ``(T (F, N + 1) block sums, block cell keys (N + 1,))``: unused
    blocks carry the dead key ncells, so the keys stay sorted."""
    N = key_s.shape[0]
    dev = key_s.device
    live = key_s < ncells
    first = live & (rank % K == 0)
    blk = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    blk = torch.where(live, blk, N).long()
    p = torch.where(live, rank % K, 0).long()
    bkey = torch.full((N + 1,), ncells, dtype=torch.int32, device=dev)
    bkey.index_put_((blk,), key_s)
    bkey[N] = ncells

    def place(rows):                       # (F, N) -> (F, N + 1, K)
        X = rows.new_zeros(rows.shape[0], N + 1, K)
        X[:, blk, p] = rows
        X[:, N] = 0.
        return X
    parts = []
    if mm_rows is not None:
        w9, vals = mm_rows
        S9 = torch.einsum("wbk,fbk->wfb", place(w9), place(vals))
        parts.append(S9.reshape(-1, N + 1))
    for c0 in range(0, len(cols_s), 8):
        parts.append(ss.slot_tree(place(torch.stack(cols_s[c0:c0 + 8]))))
    return torch.cat(parts), bkey


def _slot_sums(cols, sort_ctx, ncells: int, K: int, method: str,
               mm=None):
    """Per-cell sums (ncells, F) of the (N,) columns ``cols`` in the
    association of ``method`` (the module docstring).  ``sort_ctx`` =
    ``(order, key_s, rank)``, ``order`` None when the columns are already
    in (cell, id) order.  ``mm = (w9, vals)``: ``"gather_mm"``'s weight
    and value rows, whose products make the first 9 x F sums."""
    order, key_s, rank = sort_ctx

    def to_sorted(rows):
        if order is None:
            return list(rows)
        moved = permute_cols_u32([to_bits(r) for r in rows], order)
        return list(from_bits(moved, rows[0].dtype))

    cols_s = to_sorted(cols)
    if method in ("gather", "gather_raw", "gather_mm"):
        mm_rows = None
        if method == "gather_mm":
            w9, vals = mm
            mm_rows = (torch.stack(to_sorted(list(w9))),
                       torch.stack(to_sorted(list(vals))))
        T, bkey = _block_trees(cols_s, key_s, rank, ncells, K, mm_rows)
        return ss.segment_sums(T, starts_from_sorted_key(bkey, ncells),
                               K, tree=False)
    if method == "scatter_t" and order is not None:
        # slot K-1 adds its rows in the slab's own order: rows of rank
        # >= K-1 move behind the first K-1 of their cell in origin order
        N = key_s.shape[0]
        t = torch.where(rank < K - 1, rank.long(), K - 1 + order.long())
        perm = torch.argsort(key_s.long() * (N + K) + t, stable=True)
        cols_s = [c[perm] for c in cols_s]
    elif method not in ("scatter", "scatter_t"):
        raise ValueError(f"slot_sum_method={method!r}")
    return ss.segment_sums(cols_s, starts_from_sorted_key(key_s, ncells),
                           K, tree=True)


def _cell_grid(S, nx, ny):
    """(ncells, F) cell sums -> F halo-padded (nx+2, ny+2) fields."""
    F = S.shape[1]
    out = S.new_zeros(nx + 2, ny + 2, F)
    out[1:-1, 1:-1, :] = S.reshape(ny, nx, F).permute(1, 0, 2)
    return list(out.unbind(-1))


def _spread9(S9, nx, ny, F):
    """(ncells, 9F) owning-cell products -> out9 (nx+2, ny+2, 9, F): slot
    k of each cell holds its (dj, di) neighbour's k-th products."""
    Sg = S9.reshape(ny, nx, 9, F).permute(1, 0, 2, 3)
    out9 = S9.new_zeros(nx + 2, ny + 2, 9, F)
    k = 0
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out9[1 + di:nx + 1 + di, 1 + dj:ny + 1 + dj, k] += Sg[:, :, k]
            k += 1
    return out9


def scatter_cell_deterministic(grid, st, value_list, alive, K: int = 16,
                               sort_ctx=None, method: str = "scatter"):
    """Reproducing owning-cell sums (no spreading) of ``value_list`` in
    (cell, id) order: F (nx+2, ny+2) fields."""
    if sort_ctx is None:
        sort_ctx = make_sort_ctx(st, grid, alive)
    S = _slot_sums(list(value_list), sort_ctx, grid.nx * grid.ny, K,
                   "gather" if method == "gather_mm" else method)
    return _cell_grid(S, grid.nx, grid.ny)


def scatter_cells(grid, I, J, cols):
    """One accumulating scatter of F per-berg columns at cells (I, J),
    in no fixed order: F (nx+2, ny+2) fields (``.at[I, J].add``)."""
    out = cols[0].new_zeros(grid.nx + 2, grid.ny + 2, len(cols))
    out.index_put_((I, J), torch.stack(cols, dim=-1), accumulate=True)
    return list(out.unbind(-1))


def spread_products(st, grid, frc, cfg: IcebergsConfig):
    """``(w9, vals)``: each berg's 9 spreading weights times its
    ``I_fraction_used`` (0 when dead), and the 4 values they spread
    (mass, area, the two area momenta), as ``calculate_mass_on_ocean``
    forms them."""
    w, I_frac = spread_weights(st, grid, cfg)
    Area = st.length * st.width
    vals = [berg_spread_mass(st, grid, frc, cfg), Area * st.mass_scaling,
            st.uvel * Area * st.mass_scaling,
            st.vvel * Area * st.mass_scaling]
    return w * torch.where(st.alive, I_frac, 0.)[None, :], vals


def calculate_mass_on_ocean(st, grid, frc, cfg: IcebergsConfig,
                            sort_ctx=None, extra_value_list=None):
    """Mass, area and momentum on the grid (calculate_mass_on_ocean,
    icebergs.F90:4970-5013): the 9-slot reproducing sums with
    ``cfg.parallel_reprod`` (``extra_value_list`` summed per owning cell
    in the same pass, returned as a fifth item), else one accumulating
    scatter of the 9 footprints (``_scatter9_packed``)."""
    nx, ny = grid.nx, grid.ny
    w9, vals = spread_products(st, grid, frc, cfg)
    F = len(vals)
    if not cfg.parallel_reprod:
        I, J = st.ine + 1, st.jne + 1
        Ik, Jk, parts = [], [], []
        k = 0
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                Ik.append(I + di)
                Jk.append(J + dj)
                parts.append(torch.stack([v * w9[k] for v in vals], dim=-1))
                k += 1
        out = w9.new_zeros(nx + 2, ny + 2, F)
        out.index_put_((torch.cat(Ik).long(), torch.cat(Jk).long()),
                       torch.cat(parts), accumulate=True)
        return list(out.unbind(-1))
    method = cfg.slot_sum_method_eff
    if sort_ctx is None:
        sort_ctx = make_sort_ctx(st, grid)
    extra = list(extra_value_list or [])
    if method == "gather_mm":
        cols, mm = extra, (list(w9), vals)
    else:
        cols = [wk * v for wk in w9 for v in vals] + extra
        mm = None
    S = _slot_sums(cols, sort_ctx, nx * ny, cfg.reprod_max_per_cell,
                   method, mm=mm)
    out = sum_slots(_spread9(S[:, :9 * F], nx, ny, F))
    if extra_value_list is None:
        return out
    return out + [_cell_grid(S[:, 9 * F:], nx, ny)]


def bits_areas(st, cfg: IcebergsConfig):
    """The virtual areas of a berg's bergy bits, footloose bits and
    footloose bergy bits (calculate_sum_over_bergs_diagnositcs,
    icebergs.F90:5026-5070), zeros where the config has none."""
    L, W, T = st.length, st.width, st.thickness
    zeros = torch.zeros_like(L)
    Abits = Abits_fl = Abits_flb = zeros
    if cfg.bergy_bit_erosion_fraction > 0.:
        Lbits = torch.minimum(torch.minimum(L, W),
                              T.clamp(max=40.)).clamp(min=1e-30)
        Abits = (st.mass_of_bits / cfg.rho_bergs) / Lbits
    if cfg.fl_style == 'fl_bits':
        Lfl, Wfl, Tfl = fl_bits_dimensions(cfg, T)
        Abits_fl = (st.mass_of_fl_bits / cfg.rho_bergs) \
            / Tfl.clamp(min=1e-30)
        if cfg.bergy_bit_erosion_fraction > 0.:
            Lb2 = torch.minimum(torch.minimum(Lfl, Wfl),
                                Tfl.clamp(max=40.)).clamp(min=1e-30)
            Abits_flb = (st.mass_of_fl_bergy_bits / cfg.rho_bergs) / Lb2
    return Abits, Abits_fl, Abits_flb


def cell_columns(st, grid, cfg: IcebergsConfig):
    """The 7 per-berg columns of the per-cell sums
    (calculate_sum_over_bergs_diagnositcs, icebergs.F90:5026-5070): mass,
    the two momenta, virtual area, bergy mass, footloose-bits and
    footloose-bergy-bits mass, masked by aliveness."""
    alive = st.alive
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    area_c = grid.area[I, J].clamp(min=1e-30)
    w_cell = torch.where(alive, st.mass_scaling / area_c, 0.)
    L, W = st.length, st.width
    Abits, Abits_fl, Abits_flb = bits_areas(st, cfg)
    cols = [st.mass * w_cell, st.mass * w_cell * st.uvel,
            st.mass * w_cell * st.vvel,
            (W * L + Abits + Abits_fl + Abits_flb)
            * torch.where(alive, st.mass_scaling, 0.),
            (st.mass_of_bits + st.mass_of_fl_bergy_bits) * w_cell,
            st.mass_of_fl_bits * w_cell,
            st.mass_of_fl_bergy_bits * w_cell]
    return [torch.where(alive, c, 0.) for c in cols]


def uses_spread_kernel(cfg: IcebergsConfig) -> bool:
    """Whether the spreading runs in K3 (:mod:`.segment_spread`): with
    ``parallel_reprod`` and ``slot_sum_method="pallas"``, for the
    rectangle model K3 builds in; hexagons take the slot scatter, as in
    the JAX package (``icebergs_tpu/ops/spread.py:798-800``)."""
    return (cfg.parallel_reprod and cfg.slot_sum_method == "pallas"
            and not cfg.hexagonal_icebergs)


def create_gridded_icebergs_fields(st, grid, frc, cfg: IcebergsConfig, *,
                                   key_alive=None, cell_starts=None,
                                   extra_cell_cols=None, cell_table=None,
                                   sort_ctx=None):
    """The coupler fields.  With ``parallel_reprod`` and
    ``slot_sum_method="pallas"`` (rectangles, :func:`uses_spread_kernel`):
    one K3 pass over the presorted slab when
    ``cell_starts`` is given, else behind a payload sort (K1);
    ``cell_table`` is the grid's ``segment_spread.cell_tables`` (built
    here when not given; a step keeps it) and ``key_alive`` the sort
    key's aliveness (pre-thermodynamics: rows that died in
    thermodynamics keep their cell, so their deferred melt still lands).
    Other methods sum through ``sort_ctx`` (:func:`make_sort_ctx`, made
    here when None; ``order`` None on a presorted slab); without
    ``parallel_reprod`` every sum is an accumulating scatter.

    ``extra_cell_cols`` (reproducing only) are per-berg columns summed per
    owning cell in the same pass.  Returns ``SpreadDiags`` or, with extra
    columns, ``(SpreadDiags, extra_fields)``."""
    nx, ny = grid.nx, grid.ny
    if uses_spread_kernel(cfg):
        FX = len(extra_cell_cols or [])
        S, _ = ss.spread_cell_sums(st, grid, frc, cfg, extra_cell_cols,
                                   key_alive=key_alive,
                                   cell_starts=cell_starts,
                                   tbl=cell_table, cell_block=SPREAD_CB,
                                   window=SPREAD_WINDOW)
        mass_on, area_on, U_on, V_on = sum_slots(
            _spread9(S[:, :36], nx, ny, 4))
        cell = _cell_grid(S[:, 36:43], nx, ny)
        extra_fields = _cell_grid(S[:, 43:], nx, ny) if FX else None
        return _gridded_epilogue(grid, frc, cfg, mass_on, area_on, U_on,
                                 V_on, *cell, extra_fields,
                                 extra_cell_cols is not None)
    if cfg.parallel_reprod and sort_ctx is None:
        sort_ctx = make_sort_ctx(st, grid)
    # per-cell sums, in the same pass as the spreading
    cols = cell_columns(st, grid, cfg)
    extra_fields = None
    if cfg.parallel_reprod:
        mass_on, area_on, U_on, V_on, cell_fields = \
            calculate_mass_on_ocean(st, grid, frc, cfg, sort_ctx=sort_ctx,
                                    extra_value_list=cols + list(
                                        extra_cell_cols or []))
        cell, extra_fields = cell_fields[:7], cell_fields[7:]
    else:
        mass_on, area_on, U_on, V_on = calculate_mass_on_ocean(
            st, grid, frc, cfg)
        cell = scatter_cells(grid, (st.ine + 1).long(), (st.jne + 1).long(),
                             cols)
    return _gridded_epilogue(grid, frc, cfg, mass_on, area_on, U_on, V_on,
                             *cell, extra_fields,
                             extra_cell_cols is not None)


def _gridded_epilogue(grid, frc, cfg, mass_on, area_on, U_on, V_on,
                      mass_cell, mom_u, mom_v, virtual_area, bergy_mass,
                      fl_bits_mass, fl_bergy_bits_mass, extra_fields,
                      want_extras):
    """Gridded-field derivations (icebergs.F90:3440-3491)."""
    area_g = grid.area.clamp(min=1e-30)
    wet = grid.msk > 0.
    spread_mass = mass_on / area_g * wet
    spread_area = area_on / area_g * wet
    asafe = area_on.clamp(min=1e-30)
    spread_uvel = torch.where(area_on > 0., U_on / asafe, 0.)
    spread_vvel = torch.where(area_on > 0., V_on / asafe, 0.)

    def centers(f):
        return 0.25 * (f[:-1, :-1] + f[1:, :-1] + f[:-1, 1:] + f[1:, 1:])

    uo_p = torch.zeros_like(spread_mass)
    vo_p = torch.zeros_like(spread_mass)
    uo_p[1:-1, 1:-1] = centers(frc.uo)
    vo_p[1:-1, 1:-1] = centers(frc.vo)
    du, dv = spread_uvel - uo_p, spread_vvel - vo_p
    dvo = torch.sqrt(du * du + dv * dv)
    ustar = torch.sqrt(cfg.cdrag_icebergs
                       * (dvo * dvo + cfg.utide_icebergs ** 2))
    ustar_h = ustar.clamp(min=cfg.ustar_icebergs_bg)
    ustar_iceberg = torch.where(spread_area == 0., 0., ustar_h)

    msafe = mass_cell.clamp(min=1e-30)
    u_ice = torch.where(mass_cell > 0., mom_u / msafe, 0.)
    v_ice = torch.where(mass_cell > 0., mom_v / msafe, 0.)
    diags = SpreadDiags(spread_mass=spread_mass, spread_area=spread_area,
                        spread_uvel=spread_uvel, spread_vvel=spread_vvel,
                        ustar_iceberg=ustar_iceberg, mass_on_ocean=mass_on,
                        u_iceberg=u_ice, v_iceberg=v_ice, mass=mass_cell,
                        virtual_area=virtual_area, bergy_mass=bergy_mass,
                        fl_bits_mass=fl_bits_mass,
                        fl_bergy_bits_mass=fl_bergy_bits_mass)
    if want_extras:
        return diags, extra_fields
    return diags

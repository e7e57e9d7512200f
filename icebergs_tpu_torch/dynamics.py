"""Time stepping: Verlet and RK4 evolution and position bookkeeping.

Counterpart of ``icebergs_tpu/dynamics.py``: ``verlet_step``,
``rk4_step``, ``evolve_icebergs``, ``_advance_position`` (the lat-lon
metric, and the polar tangent plane above 89 degrees with
``rotpos_/rotvec_{to,from}_tang``), ``adjust_index_and_ground`` with the
gather-free 9x9-anchor walk (``_walk4``, ``_walk4_compact``),
``_msk25_table`` and ``_msk81_rows`` on regular grids (Cartesian, or
lat-lon periodic in ``Lx``), and on curvilinear grids
(``grid_is_regular=False``) the quad-cell walk
``adjust_index_and_ground_curvilinear`` over :mod:`.geometry`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import constants as C
from .config import IcebergsConfig
from .geometry import cell_corners, pos_within_cell_curvilinear
from .grid import (Grid, apply_modulo_around_point, cell_to_pos,
                   convert_from_meters_to_grid)
from .ops.accel import accel, divc
from .ops.interp import Env, interp_flds

POSN_EPS = 0.05  # pushback after a coast bounce (icebergs.F90:7836)

# mover compaction of the walk, off by default as in the JAX package
# (dynamics.py:242-257: the compacted walk measured slower than the
# dense one); kept bitwise identical to the dense walk
WALK_COMPACT_MIN_N = 1 << 60
WALK_COMPACT_FRAC = 4
WALK_COMPACT_CAP_FLOOR = 4096


def _lx(cfg: IcebergsConfig) -> float:
    """The x periodicity the grid routines take: ``Lx`` on a lat-lon
    grid, none (-1) on a Cartesian one."""
    return cfg.Lx if cfg.grid_is_latlon else -1.


def _frac_coords(grid: Grid, lon, lat, Lx: float = -1.):
    """Global fractional cell coordinates on a regular grid (with ``Lx``
    > 0, longitudes brought within half a period of the grid's
    middle); on a tile, from the global origin."""
    cx = lon if Lx <= 0. else apply_modulo_around_point(
        lon, grid.lon0 + 0.5 * grid.dlon * grid.nx, Lx)
    frame = _global_frame(grid)[0]
    return (cx - frame.lon0) / grid.dlon, (lat - frame.lat0) / grid.dlat


def _global_frame(grid: Grid):
    """``(grid, i_off, j_off)``: on a tile (``grid.lon0g`` set) the grid
    seen from the global origin, whose cells are the tile's shifted by
    the offsets; an untiled grid as it is, with 0 and 0.  The walk runs
    in this frame, so a tile's ``fx - i`` has the untiled grid's bits."""
    if grid.lon0g is None:
        return grid, 0, 0
    return (grid.replace(lon0=grid.lon0g, lat0=grid.lat0g), grid.i_off,
            grid.j_off)


def _cell_to_pos_curvilinear(grid: Grid, cfg: IcebergsConfig, i, j, xi,
                             yj):
    """Bilinear map (xi, yj) -> position from the cell's corners, the
    inverse of ``calc_xiyj`` (pos_within_cell's yj2x / xi2y,
    icebergs_framework.F90:6350-6364)."""
    Lx = _lx(cfg)
    x1, x2, x3, x4, y1, y2, y3, y4 = cell_corners(grid, i, j)
    x2 = apply_modulo_around_point(x2, x1, Lx)
    x3 = apply_modulo_around_point(x3, x1, Lx)
    x4 = apply_modulo_around_point(x4, x1, Lx)
    w1 = (1. - xi) * (1. - yj)
    w2 = xi * (1. - yj)
    w3 = xi * yj
    w4 = (1. - xi) * yj
    return (w1 * x1 + w2 * x2 + w3 * x3 + w4 * x4,
            w1 * y1 + w2 * y2 + w3 * y3 + w4 * y4)


def adjust_index_and_ground_curvilinear(grid: Grid, cfg: IcebergsConfig,
                                        lon, lat, i, j):
    """The quad-cell walk of ``adjust_index_and_ground``
    (icebergs.F90:7819-8100) on a curvilinear grid: four steps of at
    most one cell in x then y, driven by ``calc_xiyj``'s coordinates in
    the current cell, bouncing (clamped just inside the current cell)
    where a step would enter land or leave the grid.  Returns ``(lon,
    lat, i, j, xi, yj, bounced)``."""
    Lx = _lx(cfg)
    msk = grid.msk
    bounced = torch.zeros(lon.shape, dtype=torch.bool, device=lon.device)
    for _ in range(4):  # icount < 4 (icebergs.F90:7941)
        xi, yj, in_cell = pos_within_cell_curvilinear(grid, lon, lat, i, j,
                                                      Lx)
        move_w = xi < 0.
        move_e = xi >= 1.
        ti = (i - move_w.to(torch.int32) + move_e.to(torch.int32)).clamp(
            0, grid.nx - 1)
        ocean_x = msk[(ti + 1).long(), (j + 1).long()] > 0.
        stepped_x = (~in_cell) & (move_w | move_e)
        b_x = stepped_x & ((~ocean_x) | (ti == i))
        i = torch.where(stepped_x & ocean_x, ti, i)

        move_s = yj < 0.
        move_n = yj >= 1.
        tj = (j - move_s.to(torch.int32) + move_n.to(torch.int32)).clamp(
            0, grid.ny - 1)
        ocean_y = msk[(i + 1).long(), (tj + 1).long()] > 0.
        stepped_y = (~in_cell) & (move_s | move_n)
        b_y = stepped_y & ((~ocean_y) | (tj == j))
        j = torch.where(stepped_y & ocean_y, tj, j)

        newly_bounced = b_x | b_y
        bounced = bounced | newly_bounced
        xi2, yj2, _ = pos_within_cell_curvilinear(grid, lon, lat, i, j, Lx)
        blon, blat = _cell_to_pos_curvilinear(
            grid, cfg, i, j, xi2.clamp(POSN_EPS, 1. - POSN_EPS),
            yj2.clamp(POSN_EPS, 1. - POSN_EPS))
        lon = torch.where(newly_bounced, blon, lon)
        lat = torch.where(newly_bounced, blat, lat)

    # final safety clamp (icebergs.F90:8058-8066)
    xi, yj, _ = pos_within_cell_curvilinear(grid, lon, lat, i, j, Lx)
    bad = (xi < 0.) | (xi >= 1.) | (yj <= 0.) | (yj > 1.)
    xi_c = xi.clamp(POSN_EPS, 1. - POSN_EPS)
    yj_c = yj.clamp(POSN_EPS, 1. - POSN_EPS)
    clon, clat = _cell_to_pos_curvilinear(grid, cfg, i, j, xi_c, yj_c)
    lon = torch.where(bad, clon, lon)
    lat = torch.where(bad, clat, lat)
    xi = torch.where(bad, xi_c, xi)
    yj = torch.where(bad, yj_c, yj)
    return lon, lat, i, j, xi, yj, bounced


def _msk25_table(msk):
    """(nx+6, ny+6) int32: bit (dy+2)*5+(dx+2) of cell (p, q) is
    ``msk2[p+dx, q+dy] > 0`` on a 2-ring zero-padded mask."""
    msk2 = F.pad(msk, (2, 2, 2, 2))
    m25 = torch.zeros(msk2.shape, dtype=torch.int32, device=msk.device)
    kbit = 0
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            nb = torch.roll(msk2, (-dx, -dy), (0, 1)) > 0.
            m25 = m25 | (nb.to(torch.int32) << kbit)
            kbit += 1
    return m25


def _msk81_rows(msk):
    """(9, nx+10, ny+10) int32: row k, bit (dx+4) of cell (p, q) is
    ``msk4[p+dx, q+(k-4)] > 0`` on a 4-ring zero-padded mask — the 9x9
    neighbourhood every 4-iteration walk stays inside."""
    msk4 = F.pad(msk, (4, 4, 4, 4))
    rows = []
    for dy in range(-4, 5):
        r = torch.zeros(msk4.shape, dtype=torch.int32, device=msk.device)
        for dx in range(-4, 5):
            nb = torch.roll(msk4, (-dx, -dy), (0, 1)) > 0.
            r = r | (nb.to(torch.int32) << (dx + 4))
        rows.append(r)
    return torch.stack(rows)


def _walk4(grid: Grid, lon, lat, i, j, fx, fy, m81_pre, i_lo=0, j_lo=0):
    """The 4-iteration masked land-bounce walk of
    ``adjust_index_and_ground`` (icebergs.F90:7941-8057) reading the land
    mask from the berg's 9x9 anchor rows ``m81_pre`` (9, N), the cells
    held within ``[i_lo, i_lo + nx)`` x ``[j_lo, j_lo + ny)`` (a tile's
    in the global frame).  Returns ``(lon, lat, i, j, fx, fy,
    bounced)``."""
    dtype = lon.dtype
    bounced = torch.zeros(lon.shape, dtype=torch.bool, device=lon.device)

    def ocean(oi_off, oj_off):
        # offsets stay within +-4 over 4 iterations, so the row index is
        # always in [0, 8]
        row = m81_pre.gather(0, (oj_off + 4).long()[None])[0]
        return ((row >> (oi_off + 4)) & 1) > 0

    oi = torch.zeros_like(i)               # offset from the anchor cell
    oj = torch.zeros_like(j)
    for _ in range(4):
        xi = fx - i.to(dtype)
        yj = fy - j.to(dtype)
        in_cell = (xi >= 0.) & (xi < 1.) & (yj >= 0.) & (yj < 1.)

        move_w = xi < 0.
        move_e = xi >= 1.
        ti = (i - move_w.to(torch.int32) + move_e.to(torch.int32)).clamp(
            i_lo, i_lo + grid.nx - 1)
        dix = ti - i
        ocean_x = ocean(oi + dix, oj)
        stepped_x = (~in_cell) & (move_w | move_e)
        b_x = stepped_x & ((~ocean_x) | (ti == i))
        moved_x = stepped_x & ocean_x
        i = torch.where(moved_x, ti, i)
        oi = torch.where(moved_x, oi + dix, oi)

        move_s = yj < 0.
        move_n = yj >= 1.
        tj = (j - move_s.to(torch.int32) + move_n.to(torch.int32)).clamp(
            j_lo, j_lo + grid.ny - 1)
        djy = tj - j
        ocean_y = ocean(oi, oj + djy)
        stepped_y = (~in_cell) & (move_s | move_n)
        b_y = stepped_y & ((~ocean_y) | (tj == j))
        moved_y = stepped_y & ocean_y
        j = torch.where(moved_y, tj, j)
        oj = torch.where(moved_y, oj + djy, oj)

        newly_bounced = b_x | b_y
        bounced = bounced | newly_bounced

        xi = fx - i.to(dtype)
        yj = fy - j.to(dtype)
        xi_c = xi.clamp(POSN_EPS, 1. - POSN_EPS)
        yj_c = yj.clamp(POSN_EPS, 1. - POSN_EPS)
        blon, blat = cell_to_pos(grid, i, j, xi_c, yj_c)
        lon = torch.where(newly_bounced, blon, lon)
        lat = torch.where(newly_bounced, blat, lat)
        fx = torch.where(newly_bounced, i.to(dtype) + xi_c, fx)
        fy = torch.where(newly_bounced, j.to(dtype) + yj_c, fy)
    return lon, lat, i, j, fx, fy, bounced


def _walk4_compact(grid: Grid, lon, lat, i, j, fx, fy, m81_pre):
    """:func:`_walk4` on the rows that left their cell only, folded back
    through a rank table; the dense walk when the movers exceed the cap.
    Bitwise identical to the dense walk.  The branch reads the mover
    count on the host (one sync)."""
    N = lon.shape[0]
    cap = max(WALK_COMPACT_CAP_FLOOR, N // WALK_COMPACT_FRAC)
    dtype = lon.dtype
    xi = fx - i.to(dtype)
    yj = fy - j.to(dtype)
    mover = ~((xi >= 0.) & (xi < 1.) & (yj >= 0.) & (yj < 1.))
    if int(mover.sum()) > cap:
        return _walk4(grid, lon, lat, i, j, fx, fy, m81_pre)
    rank = torch.cumsum(mover.to(torch.int32), 0, dtype=torch.int32) - 1
    granted = mover & (rank < cap)
    code = torch.where(granted, rank, cap).long()
    sel = torch.zeros(cap + 1, dtype=torch.int64, device=lon.device)
    sel.index_copy_(0, code, torch.arange(N, device=lon.device))
    sel = sel[:cap]
    sub = _walk4(grid, lon[sel], lat[sel], i[sel], j[sel], fx[sel],
                 fy[sel], m81_pre[:, sel])

    def fold(orig, s):
        tab = torch.cat([s, s.new_zeros(1)])
        return torch.where(granted, tab[code], orig)

    return tuple(fold(o, s) for o, s in zip(
        (lon, lat, i, j, fx, fy, torch.zeros_like(mover)), sub))


def adjust_index_and_ground(grid: Grid, cfg: IcebergsConfig, lon, lat,
                            i, j, m25_pre):
    """Re-localize bergs after motion, bouncing off land cells
    (icebergs.F90:7819-8100, regular grid): walk at most 4 cells toward
    the new position, clamping just inside the current cell where the
    walk would enter land.  A curvilinear grid (``grid_is_regular``
    false) takes :func:`adjust_index_and_ground_curvilinear` instead.
    ``m25_pre`` is the table interpolation's ``(m25, m81)`` anchor pair;
    the walk reads ``m81``.  Without it (the
    ``with_interp=False`` probe) the 9x9 rows are gathered from the grid:
    the same mask bits the JAX package's 5x5-anchor walk reads.

    Returns ``(lon, lat, i, j, xi, yj, bounced)``."""
    if not cfg.grid_is_regular:
        return adjust_index_and_ground_curvilinear(grid, cfg, lon, lat, i,
                                                   j)
    if isinstance(m25_pre, tuple) and m25_pre[1] is not None:
        m81_pre = m25_pre[1]
    else:
        m81_pre = _msk81_rows(grid.msk)[:, (i + 5).long(), (j + 5).long()]
    dtype = lon.dtype
    fx, fy = _frac_coords(grid, lon, lat, _lx(cfg))
    frame, io, jo = _global_frame(grid)
    if io or jo:
        i, j = i + io, j + jo
    if io or jo or lon.shape[0] < WALK_COMPACT_MIN_N:
        lon, lat, i, j, fx, fy, bounced = _walk4(
            frame, lon, lat, i, j, fx, fy, m81_pre, io, jo)
    else:
        lon, lat, i, j, fx, fy, bounced = _walk4_compact(
            grid, lon, lat, i, j, fx, fy, m81_pre)
    # final safety clamp (icebergs.F90:8058-8066)
    xi = fx - i.to(dtype)
    yj = fy - j.to(dtype)
    bad = (xi < 0.) | (xi >= 1.) | (yj <= 0.) | (yj > 1.)
    xi_c = xi.clamp(POSN_EPS, 1. - POSN_EPS)
    yj_c = yj.clamp(POSN_EPS, 1. - POSN_EPS)
    clon, clat = cell_to_pos(frame, i, j, xi_c, yj_c)
    lon = torch.where(bad, clon, lon)
    lat = torch.where(bad, clat, lat)
    xi = torch.where(bad, xi_c, xi)
    yj = torch.where(bad, yj_c, yj)
    if io or jo:
        i, j = i - io, j - jo
    return lon, lat, i, j, xi, yj, bounced


def rotpos_to_tang(lon, lat, Rearth: float):
    """Position on the polar tangent plane (icebergs.F90:7767-7818)."""
    r = Rearth * ((90. - lat) * C.PI_180)
    return r * torch.cos(lon * C.PI_180), r * torch.sin(lon * C.PI_180)


def rotpos_from_tang(x, y, Rearth: float):
    r = torch.sqrt(x * x + y * y)
    lat = 90. - divc(C.R180_PI * r, Rearth)
    lon = C.R180_PI * torch.arccos(
        (x / r.clamp(min=1e-30)).clamp(-1., 1.)) * torch.sign(y)
    return lon, lat


def rotvec_to_tang(lon, u, v):
    clon = torch.cos(lon * C.PI_180)
    slon = torch.sin(lon * C.PI_180)
    return -slon * u - clon * v, clon * u - slon * v


def rotvec_from_tang(lon, xdot, ydot):
    clon = torch.cos(lon * C.PI_180)
    slon = torch.sin(lon * C.PI_180)
    return -slon * xdot + clon * ydot, -clon * xdot - slon * ydot


def _advance_position(cfg: IcebergsConfig, lon, lat, u, v, dt):
    """Position update ``X + dt V`` through the metric factors (ones on
    a Cartesian grid, where the product is the step itself); on a lat-lon
    grid the bergs above 89 degrees move on the polar tangent plane."""
    if not cfg.grid_is_latlon:
        return lon + dt * u, lat + dt * v
    dxdl, dydl = convert_from_meters_to_grid(lat, cfg.grid_is_latlon,
                                             cfg.Rearth)
    lonn = lon + dt * u * dxdl
    latn = lat + dt * v * dydl
    on_tang = lat > 89.
    x1, y1 = rotpos_to_tang(lon, lat, cfg.Rearth)
    xd, yd = rotvec_to_tang(lon, u, v)
    tlon, tlat = rotpos_from_tang(x1 + dt * xd, y1 + dt * yd, cfg.Rearth)
    return torch.where(on_tang, tlon, lonn), torch.where(on_tang, tlat,
                                                         latn)


class EvolveOut(NamedTuple):
    state: object
    tickets: torch.Tensor   # speeding tickets this step (0-dim int32)
    bounced: torch.Tensor   # coast bounces this step (0-dim int32)


def _loc_dx(grid: Grid, i, j):
    """min(dx, dy) around the berg cell (icebergs.F90:2313)."""
    I, J = (i + 1).long(), (j + 1).long()
    return torch.minimum(0.5 * (grid.dx[I, J] + grid.dx[I, J - 1]),
                         0.5 * (grid.dy[I, J] + grid.dy[I - 1, J]))


def _cached_env(st) -> Env:
    return Env(uo=st.uo, vo=st.vo, ui=st.ui, vi=st.vi, ua=st.ua, va=st.va,
               ssh_x=st.ssh_x, ssh_y=st.ssh_y, sst=st.sst, sss=st.sss,
               cn=st.cn, hi=st.hi, od=st.od)


def verlet_step(st, grid: Grid, frc, cfg: IcebergsConfig, ia_fn=None,
                m25_pre=None):
    """Velocity-Verlet step (verlet_stepping + update_verlet_position,
    icebergs.F90:7203-7330 and 7684-7766)."""
    dt = cfg.dt
    dt_2 = 0.5 * dt
    uvel1, vvel1 = st.uvel, st.vvel
    axn_p, ayn_p = st.axn, st.ayn
    uvel_prev = uvel1 - dt_2 * st.bxn
    vvel_prev = vvel1 - dt_2 * st.byn

    out = accel(cfg, grid, lat=st.lat, mass=st.mass,
                thickness=st.thickness, width=st.width, length=st.length,
                n_bonds=st.n_bonds, env=_cached_env(st),
                uvel=uvel1, vvel=vvel1, uvel0=uvel1, vvel0=vvel1, dt=dt,
                axn_in=axn_p, ayn_in=ayn_p,
                loc_dx=_loc_dx(grid, st.ine, st.jne), ia_fn=ia_fn)

    uveln = (uvel1 + dt_2 * axn_p) + dt * out.ax
    vveln = (vvel1 + dt_2 * ayn_p) + dt * out.ay
    if cfg.override_iceberg_velocities:
        uveln = torch.full_like(uveln, cfg.u_override)
        vveln = torch.full_like(vveln, cfg.v_override)

    moving = st.alive & (st.static_berg < 0.5)

    def sel(new, old):
        return torch.where(moving, new, old)

    st = st.replace(
        axn=sel(out.axn, st.axn), ayn=sel(out.ayn, st.ayn),
        bxn=sel(out.bxn, st.bxn), byn=sel(out.byn, st.byn),
        uvel=sel(uveln, st.uvel), vvel=sel(vveln, st.vvel),
        uvel_prev=sel(uvel_prev, st.uvel_prev),
        vvel_prev=sel(vvel_prev, st.vvel_prev))

    uvel2 = st.uvel + dt_2 * (st.axn + st.bxn)
    vvel2 = st.vvel + dt_2 * (st.ayn + st.byn)
    lonn, latn = _advance_position(cfg, st.lon, st.lat, uvel2, vvel2, dt)
    lonn, latn, i, j, xi, yj, bounced = adjust_index_and_ground(
        grid, cfg, lonn, latn, st.ine, st.jne, m25_pre)

    st = st.replace(
        lon=sel(lonn, st.lon), lat=sel(latn, st.lat),
        ine=torch.where(moving, i, st.ine),
        jne=torch.where(moving, j, st.jne),
        xi=sel(xi, st.xi), yj=sel(yj, st.yj))
    tickets = (out.tickets & moving).sum(dtype=torch.int32)
    nbounce = (bounced & moving).sum(dtype=torch.int32)
    return EvolveOut(st, tickets, nbounce)


def rk4_step(st, grid: Grid, frc, cfg: IcebergsConfig, ia_fn=None,
             m25_pre=None):
    """Fourth-order Runge-Kutta step (Runge_Kutta_stepping,
    icebergs.F90:7331).  Every stage reads the environment cached at the
    step start, or with ``old_interp_flds_order`` re-interpolates it at
    the stage position (:func:`.ops.interp.interp_flds`); every stage's
    walk starts from the step's cell with the same anchors ``m25_pre``.
    ``ia_fn`` is called at each stage's velocities."""
    dt = cfg.dt
    # dt / 6 in float64, then a tensor times a Python scalar, as the JAX
    # weak-typed product rounds it; the stage combine divides by a 0-d
    # float32 tensor, so the card divides rather than multiplying by a
    # reciprocal
    dt_2, dt_6 = 0.5 * dt, dt / 6.
    env1 = _cached_env(st)
    lon1, lat1 = st.lon, st.lat
    uvel1, vvel1 = st.uvel, st.vvel
    i1, j1 = st.ine, st.jne
    axn_p, ayn_p = st.axn, st.ayn
    moving = st.alive & (st.static_berg < 0.5)
    six = st.lon.new_full((), 6.)

    def stage_env(lon, lat, i, j, xi, yj):
        if cfg.old_interp_flds_order:
            return interp_flds(grid, frc, cfg, lon, lat, i, j, xi, yj)
        return env1

    def call_accel(envk, i, j, u, v, dtk):
        return accel(cfg, grid, lat=st.lat, mass=st.mass,
                     thickness=st.thickness, width=st.width,
                     length=st.length, n_bonds=st.n_bonds, env=envk,
                     uvel=u, vvel=v, uvel0=uvel1, vvel0=vvel1, dt=dtk,
                     axn_in=axn_p, ayn_in=ayn_p, loc_dx=_loc_dx(grid, i, j),
                     ia_fn=ia_fn)

    def stage(u, v, dtk):
        """X1 + dtk (u, v), walked from the step's cell."""
        lon, lat = _advance_position(cfg, lon1, lat1, u, v, dtk)
        return adjust_index_and_ground(grid, cfg, lon, lat, i1, j1, m25_pre)

    def rate(uvel, vvel, lat):
        """The stage's position rates: the velocities through the
        metric factors (ones on a Cartesian grid, where the product is
        the velocity itself); dlat/dy is stage 1's throughout."""
        if not cfg.grid_is_latlon:
            return uvel, vvel
        dxdl, _ = convert_from_meters_to_grid(lat, True, cfg.Rearth)
        return uvel * dxdl, vvel * dydl

    if cfg.grid_is_latlon:
        _, dydl = convert_from_meters_to_grid(lat1, True, cfg.Rearth)
    o1 = call_accel(env1, i1, j1, uvel1, vvel1, dt_2)
    u1, v1 = rate(uvel1, vvel1, lat1)
    uvel2, vvel2 = uvel1 + dt_2 * o1.ax, vvel1 + dt_2 * o1.ay
    lon2, lat2, i2, j2, xi2, yj2, b2 = stage(uvel1, vvel1, dt_2)
    u2, v2 = rate(uvel2, vvel2, lat2)
    o2 = call_accel(stage_env(lon2, lat2, i2, j2, xi2, yj2), i2, j2,
                    uvel2, vvel2, dt_2)
    uvel3, vvel3 = uvel1 + dt_2 * o2.ax, vvel1 + dt_2 * o2.ay
    lon3, lat3, i3, j3, xi3, yj3, b3 = stage(uvel2, vvel2, dt_2)
    u3, v3 = rate(uvel3, vvel3, lat3)
    o3 = call_accel(stage_env(lon3, lat3, i3, j3, xi3, yj3), i3, j3,
                    uvel3, vvel3, dt)
    uvel4, vvel4 = uvel1 + dt * o3.ax, vvel1 + dt * o3.ay
    lon4, lat4, i4, j4, xi4, yj4, b4 = stage(uvel3, vvel3, dt)
    u4, v4 = rate(uvel4, vvel4, lat4)
    o4 = call_accel(stage_env(lon4, lat4, i4, j4, xi4, yj4), i4, j4,
                    uvel4, vvel4, dt)

    def comb(a1, a2, a3, a4):
        return (a1 + a4) + 2. * (a2 + a3)

    lonn = lon1 + dt_6 * comb(u1, u2, u3, u4)
    latn = lat1 + dt_6 * comb(v1, v2, v3, v4)
    uveln = uvel1 + dt_6 * comb(o1.ax, o2.ax, o3.ax, o4.ax)
    vveln = vvel1 + dt_6 * comb(o1.ay, o2.ay, o3.ay, o4.ay)
    axn = comb(o1.axn, o2.axn, o3.axn, o4.axn) / six
    ayn = comb(o1.ayn, o2.ayn, o3.ayn, o4.ayn) / six
    bxn = comb(o1.ax, o2.ax, o3.ax, o4.ax) / six - axn / 2.
    byn = comb(o1.ay, o2.ay, o3.ay, o4.ay) / six - ayn / 2.
    if cfg.override_iceberg_velocities:
        uveln = torch.full_like(uveln, cfg.u_override)
        vveln = torch.full_like(vveln, cfg.v_override)
    lonn, latn, i, j, xi, yj, bn = adjust_index_and_ground(
        grid, cfg, lonn, latn, i1, j1, m25_pre)

    def sel(new, old):
        return torch.where(moving, new, old)

    st = st.replace(
        axn=sel(axn, st.axn), ayn=sel(ayn, st.ayn),
        bxn=sel(bxn, st.bxn), byn=sel(byn, st.byn),
        uvel=sel(uveln, st.uvel), vvel=sel(vveln, st.vvel),
        lon=sel(lonn, st.lon), lat=sel(latn, st.lat),
        ine=torch.where(moving, i, st.ine),
        jne=torch.where(moving, j, st.jne),
        xi=sel(xi, st.xi), yj=sel(yj, st.yj))
    tickets = ((o1.tickets | o2.tickets | o3.tickets | o4.tickets)
               & moving).sum(dtype=torch.int32)
    nbounce = ((b2 | b3 | b4 | bn) & moving).sum(dtype=torch.int32)
    return EvolveOut(st, tickets, nbounce)


def evolve_icebergs(st, grid: Grid, frc, cfg: IcebergsConfig, ia_fn=None,
                    m25_pre=None):
    """One dynamics step for all bergs (evolve_icebergs, icebergs.F90:7081),
    then the order-invariance copies (7185-7198)."""
    step = rk4_step if cfg.Runge_not_Verlet else verlet_step
    out = step(st, grid, frc, cfg, ia_fn=ia_fn, m25_pre=m25_pre)
    st = out.state
    if cfg.interactive_icebergs_on:
        moving = st.alive & (st.static_berg < 0.5)

        def sel(new, old):
            return torch.where(moving, new, old)

        st = st.replace(uvel_old=sel(st.uvel, st.uvel_old),
                        vvel_old=sel(st.vvel, st.vvel_old),
                        lon_old=sel(st.lon, st.lon_old),
                        lat_old=sel(st.lat, st.lat_old))
    return EvolveOut(st, out.tickets, out.bounced)

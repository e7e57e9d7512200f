"""Field -> berg interpolation by per-field gathers (``interp_flds``).

Counterpart of ``icebergs_tpu/ops/interp.py`` (``Env``,
``quad_interp_from_agrid``, ``interp_flds``; port of
``src/icebergs.F90:4718-4969`` and ``icebergs_framework.F90:7168-7255``)
and of ``icebergs_tpu/model.py::interp_to_bergs``: corner-B-grid
bilinear velocities, PCM A-grid scalars, the SSH-gradient stencil with
its NaN scrub, coastal and tidal drift, the grid rotation and the ocean
depth (PCM, the quadratic A-grid stencil under MTS, or the A68 test's
analytic depth).  Every berg reads the grid arrays it needs by index,
with the JAX table's edge clamping; the arithmetic follows the JAX
function term for term.  The reads are cell-local, so Cartesian,
lat-lon and curvilinear grids take the same code (the rotation
``cosc`` / ``sinc`` turns grid-aligned vectors east and north); the
quadratic depth stencil is the regular-grid one, as in the JAX package.

The step takes this path wherever the JAX ``make_step`` takes it
(``interp_mode="xla"``, per-step ``"kernel"``, coastal or tidal drift,
MTS with ``A68_test``); the fast lane reads the environment through
:mod:`.interp_table` (K1) or :mod:`.interp_sorted` (K6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import IcebergsConfig
from ..grid import Grid


class Env(NamedTuple):
    uo: torch.Tensor
    vo: torch.Tensor
    ui: torch.Tensor
    vi: torch.Tensor
    ua: torch.Tensor
    va: torch.Tensor
    ssh_x: torch.Tensor
    ssh_y: torch.Tensor
    sst: torch.Tensor
    sss: torch.Tensor
    cn: torch.Tensor
    hi: torch.Tensor
    od: torch.Tensor


def global_offsets(grid: Grid):
    """``(i_off, j_off, lon0, lat0)`` of the global frame: a tile's
    (``lon0g`` set, as :func:`..dynamics._global_frame` reads it), or an
    untiled grid's own (0, 0, lon0, lat0)."""
    if grid.lon0g is None:
        return 0, 0, grid.lon0, grid.lat0
    return grid.i_off, grid.j_off, grid.lon0g, grid.lat0g


def stencil_lo(i, frac, n: int, off: int, ng: int, mind: int):
    """The low cell of the quadratic stencil's 3-node window along one
    axis: staggered by the parity of the 1-based global cell index
    ``i + off + 1`` and clamped to the global grid's [-1, ng - 2] (``ng``
    0: this grid's ``n``) and to the tile's [-1, n - 2].  On a tile the
    global frame picks the untiled grid's window (the JAX package's
    tiles take the tile-local parity); untiled, ``off`` is 0."""
    par = (i + off + 1) % 2
    lo = torch.where(par == mind, torch.where(frac >= 0.5, i, i - 2), i - 1)
    return lo.clamp(max(-1, -1 - off), min(n - 2, (ng or n) - 2 - off))


def quad_interp_from_agrid(grid: Grid, fld, lon, lat, i, j, xi, yj,
                           cfg: IcebergsConfig):
    """Bi-quadratic Lagrange interpolation of a halo-padded A-grid field
    on a regular grid, the 3x3 node window staggered by the parity of the
    1-based cell index (``mind`` / ``rev_mind``), both taken in the global
    frame on a tile (:func:`stencil_lo`; the window placed from the
    global origin ``lon0g`` / ``lat0g``)."""
    mind = 0 if cfg.rev_mind else 1
    io, jo, x0, y0 = global_offsets(grid)
    is_lo = stencil_lo(i, xi, grid.nx, io, grid.nxg, mind)
    js_lo = stencil_lo(j, yj, grid.ny, jo, grid.nyg, mind)
    x_mid = x0 + ((is_lo + io).to(xi.dtype) + 1.5) * grid.dlon
    y_mid = y0 + ((js_lo + jo).to(yj.dtype) + 1.5) * grid.dlat
    xloc = (lon - x_mid) / (2. * grid.dlon) + 0.5
    yloc = (lat - y_mid) / (2. * grid.dlat) + 0.5
    xloc = xloc * 2. - 1.
    yloc = yloc * 2. - 1.
    xb = (0.5 * xloc * (xloc - 1.), (1. + xloc) * (1. - xloc),
          0.5 * xloc * (xloc + 1.))
    yb = (0.5 * yloc * (yloc - 1.), (1. + yloc) * (1. - yloc),
          0.5 * yloc * (yloc + 1.))
    Il, Jl = (is_lo + 1).long(), (js_lo + 1).long()
    out = torch.zeros_like(lon)
    for a in range(3):
        for b in range(3):
            out = out + xb[a] * yb[b] * fld[Il + a, Jl + b]
    return out


def interp_flds(grid: Grid, frc, cfg: IcebergsConfig, lon, lat, i, j, xi,
                yj, rx=0., ry=0.) -> Env:
    """Interpolate every forcing field to the bergs' positions
    (icebergs.F90:4718-4969)."""
    nx, ny = grid.nx, grid.ny
    I, J = (i + 1).long(), (j + 1).long()

    def kread(f, io, jo):                 # corner (i+io, j+jo)
        return f[I - 1 + io, J - 1 + jo]

    def a(f, di, dj):                     # padded center, edge-clamped
        return f[(I + di).clamp(0, nx + 1), (J + dj).clamp(0, ny + 1)]

    vals = []
    for f in (grid.cosc, grid.sinc, frc.uo, frc.vo, frc.ui, frc.vi, frc.ua,
              frc.va):
        f00, f01 = kread(f, 0, 0), kread(f, 0, 1)
        f10, f11 = kread(f, 1, 0), kread(f, 1, 1)
        if cfg.old_bug_bilin:
            vals.append((f11 * (1. - xi) + f01 * xi) * (1. - yj)
                        + (f10 * (1. - xi) + f00 * xi) * yj)
        else:
            vals.append((f11 * xi + f01 * (1. - xi)) * yj
                        + (f10 * xi + f00 * (1. - xi)) * (1. - yj))
    cos_rot, sin_rot, uo, vo, ui, vi, ua, va = vals
    msk = grid.msk

    if cfg.coastal_drift > 0.:
        # away from coastlines (icebergs.F90:4770-4778)
        du = cfg.coastal_drift * (a(msk, 1, 0) - a(msk, -1, 0)) \
            * a(msk, 0, 0)
        dv = cfg.coastal_drift * (a(msk, 0, 1) - a(msk, 0, -1)) \
            * a(msk, 0, 0)
        uo, ui = uo + du, ui + du
        vo, vi = vo + dv, vi + dv

    if cfg.tidal_drift > 0.:
        # tidal drift, masked so as not to push into land
        # (icebergs.F90:4782-4794)
        du = (min(0., rx) * a(msk, -1, 0) + max(0., rx) * a(msk, 1, 0)) \
            * (1. - a(msk, 0, -1) * a(msk, 0, 1))
        dv = (min(0., ry) * a(msk, 0, -1) + max(0., ry) * a(msk, 0, 1)) \
            * (1. - a(msk, -1, 0) * a(msk, 1, 0))
        du = du * cfg.tidal_drift * a(msk, 0, 0)
        dv = dv * cfg.tidal_drift * a(msk, 0, 0)
        uo, ui = uo + du, ui + du
        vo, vi = vo + dv, vi + dv

    ssh, dx, dy = frc.ssh, grid.dx, grid.dy

    # the stencil divides by a clamped denominator and flags den == 0;
    # the flags of the slots a branch touches scrub ssh_x / ssh_y (the
    # reference's post-rotation isnan scrub, icebergs.F90:4893-4894)
    def ddx(o0, o1):
        dxp = 0.5 * (a(dx, o0 + 1, o1) + a(dx, o0 + 1, o1 - 1))
        dx0 = 0.5 * (a(dx, o0, o1) + a(dx, o0, o1 - 1))
        den = dx0 + dxp
        v = 2. * (a(ssh, o0 + 1, o1) - a(ssh, o0, o1)) \
            / den.clamp(min=1e-30) * a(msk, o0 + 1, o1) * a(msk, o0, o1)
        return v, den == 0.

    def ddy(o0, o1):
        dyp = 0.5 * (a(dy, o0, o1 + 1) + a(dy, o0 - 1, o1 + 1))
        dy0 = 0.5 * (a(dy, o0, o1) + a(dy, o0 - 1, o1))
        den = dy0 + dyp
        v = 2. * (a(ssh, o0, o1 + 1) - a(ssh, o0, o1)) \
            / den.clamp(min=1e-30) * a(msk, o0, o1 + 1) * a(msk, o0, o1)
        return v, den == 0.

    x01, px01 = ddx(0, 1)
    x00, px00 = ddx(0, 0)
    x0m, px0m = ddx(0, -1)
    xm1, pxm1 = ddx(-1, 1)
    xm0, pxm0 = ddx(-1, 0)
    xmm, pxmm = ddx(-1, -1)
    up = yj >= 0.5
    hxp = torch.where(up, (yj - 0.5) * x01 + (1.5 - yj) * x00,
                      (yj + 0.5) * x00 + (0.5 - yj) * x0m)
    hxm = torch.where(up, (yj - 0.5) * xm1 + (1.5 - yj) * xm0,
                      (yj + 0.5) * xm0 + (0.5 - yj) * xmm)
    ssh_x = xi * hxp + (1. - xi) * hxm
    poison_x = torch.where(up, px01 | px00 | pxm1 | pxm0,
                           px00 | px0m | pxm0 | pxmm)

    y10, py10 = ddy(1, 0)
    y00, py00 = ddy(0, 0)
    ym0, pym0 = ddy(-1, 0)
    y1m, py1m = ddy(1, -1)
    y0m, py0m = ddy(0, -1)
    ymm, pymm = ddy(-1, -1)
    right = xi >= 0.5
    hyp = torch.where(right, (xi - 0.5) * y10 + (1.5 - xi) * y00,
                      (xi + 0.5) * y00 + (0.5 - xi) * ym0)
    hym = torch.where(right, (xi - 0.5) * y1m + (1.5 - xi) * y0m,
                      (xi + 0.5) * y0m + (0.5 - xi) * ymm)
    ssh_y = yj * hyp + (1. - yj) * hym
    poison_y = torch.where(right, py10 | py00 | py1m | py0m,
                           py00 | pym0 | py0m | pymm)

    def rot(u, v):
        return cos_rot * u + sin_rot * v, cos_rot * v - sin_rot * u

    uo, vo = rot(uo, vo)
    ui, vi = rot(ui, vi)
    ua, va = rot(ua, va)
    ssh_x, ssh_y = rot(ssh_x, ssh_y)
    poison = poison_x | poison_y
    ssh_x = torch.where(poison, 0., ssh_x)
    ssh_y = torch.where(poison, 0., ssh_y)

    # ocean depth + ssh: quadratic A-grid under MTS, PCM otherwise
    # (icebergs.F90:4930-4950)
    if cfg.mts:
        if cfg.A68_test:
            od = torch.where((lon > cfg.A68_xdisp + 360.)
                             & (lat > cfg.A68_ydisp), 0., 1000.)
        else:
            od = quad_interp_from_agrid(grid, grid.ocean_depth + frc.ssh,
                                        lon, lat, i, j, xi, yj, cfg)
    else:
        od = a(grid.ocean_depth, 0, 0) + a(ssh, 0, 0)
    return Env(uo=uo, vo=vo, ui=ui, vi=vi, ua=ua, va=va, ssh_x=ssh_x,
               ssh_y=ssh_y, sst=a(frc.sst, 0, 0), sss=a(frc.sss, 0, 0),
               cn=a(frc.cn, 0, 0), hi=a(frc.hi, 0, 0), od=od)


def interp_to_bergs(st, grid: Grid, frc, cfg: IcebergsConfig, rx=0.,
                    ry=0.):
    """Cache the interpolated environment on every berg
    (interp_gridded_fields_to_bergs, icebergs.F90:4673-4716)."""
    env = interp_flds(grid, frc, cfg, st.lon, st.lat, st.ine, st.jne,
                      st.xi, st.yj, rx, ry)
    return st.replace(**env._asdict())


def use_interp_table(cfg: IcebergsConfig) -> bool:
    """Whether the per-step path reads the table (K1) rather than
    :func:`interp_flds`: the JAX ``make_step``'s rule
    (``icebergs_tpu/model.py:166-169``)."""
    return (cfg.interp_mode == "table"
            and cfg.coastal_drift == 0. and cfg.tidal_drift == 0.
            and not (cfg.mts and (cfg.A68_test or not cfg.grid_is_regular)))

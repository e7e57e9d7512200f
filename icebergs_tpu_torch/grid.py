"""Eulerian grid container, the grid builders and the metric factors.

PyTorch counterpart of ``icebergs_tpu/grid.py`` (``Grid``,
``make_uniform_grid``, ``make_curvilinear_grid``, ``make_tripolar_grid``,
``pos_to_cell``, ``cell_to_pos``, ``bilin_corner``, ``center_at`` and
``convert_from_grid_to_meters`` / ``convert_from_meters_to_grid``), with
the same layout conventions: corner arrays ``(nx+1, ny+1)``, halo-padded
center arrays ``(nx+2, ny+2)`` with cell ``(i, j)`` at ``[i+1, j+1]``,
and 0-dim float32 tensors for the regular-grid metadata.  The builders
work in float64 numpy and round once to the grid's dtype, as the JAX
package's do, so the corners are the JAX grid's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import constants as C
from .ops.accel import rdiv


@dataclasses.dataclass(frozen=True)
class Grid:
    nx: int
    ny: int
    lonc: torch.Tensor           # (nx+1, ny+1) corner coordinates
    latc: torch.Tensor
    cosc: torch.Tensor           # grid rotation at corners
    sinc: torch.Tensor
    msk: torch.Tensor            # (nx+2, ny+2) 1=ocean 0=land
    area: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    ocean_depth: torch.Tensor
    lat_center: torch.Tensor
    lon0: torch.Tensor           # 0-dim: west corner (lonc[0, 0])
    lat0: torch.Tensor
    dlon: torch.Tensor           # corner spacing (deg or m)
    dlat: torch.Tensor
    # tile metadata (``icebergs_tpu/grid.py:57-69``): the global cell of
    # local cell (0, 0), for globally unique spawn ids; the global extent
    # (0: this grid's own); the width of the ring of cells this tile does
    # not own, where nothing spawns.  The defaults are an untiled grid
    i_off: int = 0
    j_off: int = 0
    nxg: int = 0
    nyg: int = 0
    own_halo_x: int = 0
    own_halo_y: int = 0
    # a tile's global origin (0-dim, the untiled grid's lon0 / lat0): the
    # walk measures a berg's place in its cell from it, in global cells,
    # so that a tile rounds it as the untiled grid does (the JAX package
    # measures from the tile's own corner, an ulp apart).  None untiled
    lon0g: Optional[torch.Tensor] = None
    lat0g: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "Grid":
        return dataclasses.replace(self, **kw)

    @property
    def device(self):
        return self.msk.device

    def to(self, device) -> "Grid":
        return Grid(**{f.name: (v.to(device) if torch.is_tensor(v) else v)
                       for f in dataclasses.fields(self)
                       for v in [getattr(self, f.name)]})


def make_uniform_grid(nx: int, ny: int, lon0: float, lat0: float,
                      dlon: float, dlat: float, *, grid_is_latlon: bool,
                      Rearth: float = C.REARTH_DEFAULT, msk=None,
                      ocean_depth=None, dtype=torch.float32,
                      device) -> Grid:
    """A uniform Cartesian or lat-lon grid, built in float64 numpy and
    rounded once to ``dtype`` as ``icebergs_tpu.grid.make_uniform_grid``
    builds it."""
    xc = lon0 + dlon * np.arange(nx + 1)
    yc = lat0 + dlat * np.arange(ny + 1)
    lonc, latc = np.meshgrid(xc, yc, indexing="ij")
    xm = lon0 + dlon * (np.arange(nx) + 0.5)
    ym = lat0 + dlat * (np.arange(ny) + 0.5)
    lonm, latm = np.meshgrid(xm, ym, indexing="ij")
    if grid_is_latlon:
        dx = (C.PI_180 * Rearth * np.cos(C.PI_180 * latm)) * dlon
        dy = (C.PI_180 * Rearth) * dlat * np.ones_like(latm)
    else:
        dx = dlon * np.ones_like(lonm)
        dy = dlat * np.ones_like(latm)
    if msk is None:
        msk = np.ones((nx, ny))
    if ocean_depth is None:
        ocean_depth = np.zeros((nx, ny))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)

    def pad_center(a):
        return t(np.pad(np.asarray(a, np.float64), 1))

    return Grid(
        nx=nx, ny=ny, lonc=t(lonc), latc=t(latc),
        cosc=torch.ones(nx + 1, ny + 1, dtype=dtype, device=device),
        sinc=torch.zeros(nx + 1, ny + 1, dtype=dtype, device=device),
        msk=pad_center(msk), area=pad_center(dx * dy),
        dx=pad_center(dx), dy=pad_center(dy),
        ocean_depth=pad_center(ocean_depth), lat_center=pad_center(latm),
        lon0=t(lon0), lat0=t(lat0), dlon=t(dlon), dlat=t(dlat))


def apply_modulo_around_point(x, y, Lx: float):
    """x in the range [y-Lx/2, y+Lx/2] (icebergs_framework.F90:6576)."""
    if Lx > 0.:
        return torch.remainder(x - (y - 0.5 * Lx), Lx) + (y - 0.5 * Lx)
    return x


def pos_to_cell(grid: Grid, lon, lat, Lx: float):
    """Cell (i, j) and intra-cell (xi, yj) of positions on a regular grid:
    the origin formula refined against the corner arrays, term for term
    as ``icebergs_tpu.grid.pos_to_cell``."""
    cx = apply_modulo_around_point(
        lon, grid.lon0 + 0.5 * grid.dlon * grid.nx, Lx)
    fx = (cx - grid.lon0) / grid.dlon
    fy = (lat - grid.lat0) / grid.dlat
    i = torch.floor(fx).to(torch.int32).clamp(0, grid.nx - 1)
    j = torch.floor(fy).to(torch.int32).clamp(0, grid.ny - 1)
    lonc_i = grid.lonc[:, 0]
    latc_j = grid.latc[0, :]
    i = torch.where(cx < lonc_i[i.long()], i - 1, i)
    i = torch.where(cx >= lonc_i[(i + 1).clamp(max=grid.nx).long()],
                    i + 1, i)
    i = i.clamp(0, grid.nx - 1)
    j = torch.where(lat < latc_j[j.long()], j - 1, j)
    j = torch.where(lat >= latc_j[(j + 1).clamp(max=grid.ny).long()],
                    j + 1, j)
    j = j.clamp(0, grid.ny - 1)
    xi = (cx - lonc_i[i.long()]) / grid.dlon
    yj = (lat - latc_j[j.long()]) / grid.dlat
    return i, j, xi, yj


def cell_to_pos(grid: Grid, i, j, xi, yj):
    """Inverse of :func:`pos_to_cell`."""
    lon = grid.lon0 + (i.to(xi.dtype) + xi) * grid.dlon
    lat = grid.lat0 + (j.to(yj.dtype) + yj) * grid.dlat
    return lon, lat


def convert_from_grid_to_meters(lat_ref, grid_is_latlon: bool,
                                Rearth: float):
    """Metric factors (dx/dlon, dy/dlat) at a latitude
    (icebergs.F90:443-460): ``PI_180 Rearth cos(PI_180 lat)`` and
    ``PI_180 Rearth`` on a lat-lon grid (the product ``PI_180 Rearth``
    folded in double and rounded once, as the JAX expression rounds it),
    ones on a Cartesian grid."""
    if grid_is_latlon:
        k = C.PI_180 * Rearth
        return torch.cos(lat_ref * C.PI_180) * k, torch.full_like(lat_ref, k)
    one = torch.ones_like(lat_ref)
    return one, one


def convert_from_meters_to_grid(lat_ref, grid_is_latlon: bool,
                                Rearth: float):
    """Metric factors (dlon/dx, dlat/dy) at a latitude
    (icebergs.F90:462-478): the reciprocals, correctly rounded."""
    dx_dlon, dy_dlat = convert_from_grid_to_meters(lat_ref, grid_is_latlon,
                                                   Rearth)
    return rdiv(1.0, dx_dlon), rdiv(1.0, dy_dlat)


def pair_separation(lon1, lat1, lon2, lat2, grid_is_latlon: bool,
                    Rearth: float):
    """``(rx, ry)`` in metres between two positions: the differences
    times the metric factors at the mean latitude (the pair metric of
    ``forces``, ``dem``, ``mts`` and ``footloose``); on a Cartesian grid
    the factors are ones and the product is the difference itself."""
    if not grid_is_latlon:
        return lon1 - lon2, lat1 - lat2
    dx_dlon, dy_dlat = convert_from_grid_to_meters(0.5 * (lat1 + lat2),
                                                   True, Rearth)
    return (lon1 - lon2) * dx_dlon, (lat1 - lat2) * dy_dlat


def bilin_corner(fld_c, i, j, xi, yj, old_bug_bilin: bool):
    """Bilinear interpolation of a corner field to (xi, yj) in cell (i, j)
    (``bilin``, icebergs_framework.F90:7071-7089, with the
    ``old_bug_bilin`` mirrored weights)."""
    i, j = i.long(), j.long()
    f00 = fld_c[i, j]
    f10 = fld_c[i + 1, j]
    f01 = fld_c[i, j + 1]
    f11 = fld_c[i + 1, j + 1]
    if old_bug_bilin:
        return ((f11 * (1. - xi) + f01 * xi) * (1. - yj)
                + (f10 * (1. - xi) + f00 * xi) * yj)
    return ((f11 * xi + f01 * (1. - xi)) * yj
            + (f10 * xi + f00 * (1. - xi)) * (1. - yj))


def center_at(fld, i, j):
    """Gather a halo-padded center field at 0-based cell offsets."""
    return fld[(i + 1).long(), (j + 1).long()]


def make_curvilinear_grid(lonc, latc, *, Rearth: float = C.REARTH_DEFAULT,
                          msk=None, ocean_depth=None, dtype=torch.float32,
                          device) -> Grid:
    """A grid from explicit corner arrays (nx+1, ny+1), with haversine
    metric terms (driver/driver_data_fms2.F90:60-120): ``dx`` the
    northern edge, ``dy`` the eastern edge, ``area = dx dy``, rotation
    ``cosc = 1``, ``sinc = 0``.  Such grids step through the curvilinear
    walk of :mod:`.geometry` (``grid_is_regular=False``)."""
    lonc = np.asarray(lonc, np.float64)
    latc = np.asarray(latc, np.float64)
    nx, ny = lonc.shape[0] - 1, lonc.shape[1] - 1

    def hav(lon1, lat1, lon2, lat2):
        p = np.pi / 180.
        dlat = (lat2 - lat1) * p
        dlon = (lon2 - lon1) * p
        a = np.sin(dlat / 2) ** 2 + np.cos(lat1 * p) * np.cos(lat2 * p) \
            * np.sin(dlon / 2) ** 2
        return 2 * Rearth * np.arcsin(np.sqrt(np.clip(a, 0., 1.)))

    dx = hav(lonc[:-1, 1:], latc[:-1, 1:], lonc[1:, 1:], latc[1:, 1:])
    dy = hav(lonc[1:, :-1], latc[1:, :-1], lonc[1:, 1:], latc[1:, 1:])
    latm = 0.25 * (latc[:-1, :-1] + latc[1:, :-1] + latc[:-1, 1:]
                   + latc[1:, 1:])
    if msk is None:
        msk = np.ones((nx, ny))
    if ocean_depth is None:
        ocean_depth = np.zeros((nx, ny))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)

    def pad_center(a):
        return t(np.pad(np.asarray(a, np.float64), 1))

    return Grid(
        nx=nx, ny=ny, lonc=t(lonc), latc=t(latc),
        cosc=torch.ones(nx + 1, ny + 1, dtype=dtype, device=device),
        sinc=torch.zeros(nx + 1, ny + 1, dtype=dtype, device=device),
        msk=pad_center(msk), area=pad_center(dx * dy),
        dx=pad_center(dx), dy=pad_center(dy),
        ocean_depth=pad_center(ocean_depth), lat_center=pad_center(latm),
        lon0=t(lonc[0, 0]), lat0=t(latc[0, 0]),
        dlon=t(lonc[1, 0] - lonc[0, 0]), dlat=t(latc[0, 1] - latc[0, 0]))


def _sph(lon, lat):
    p = np.pi / 180.0
    return np.array([np.cos(lat * p) * np.cos(lon * p),
                     np.cos(lat * p) * np.sin(lon * p), np.sin(lat * p)])


def _geo(v):
    v = v / np.linalg.norm(v)
    lat = np.degrees(np.arcsin(np.clip(v[2], -1., 1.)))
    lon = np.degrees(np.arctan2(v[1], v[0])) % 360.0
    return lon, lat


def _slerp(a, b, t):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    w = np.arccos(np.clip(a @ b, -1., 1.))
    if w < 1e-12:
        return a
    return (np.sin((1 - t) * w) * a + np.sin(t * w) * b) / np.sin(w)


def make_tripolar_grid(nx: int, ny: int, *, lat0: float = 30.0,
                       lat_join: float = 65.0, lat_poles: float = 75.0,
                       lon0: float = 0.0, msk=None, ocean_depth=None,
                       Rearth: float = C.REARTH_DEFAULT,
                       dtype=torch.float32, device) -> Grid:
    """Tripolar corner coordinates: regular lat-lon from ``lat0`` to
    ``lat_join``, above it a two-pole cap whose rows follow great circles
    from the join circle to the fold line (pole 1 at (lon0 + 90,
    lat_poles) over the geographic pole to pole 2 at (lon0 + 270,
    lat_poles)), so the top corner row pairs corner(i, ny) with
    corner(nx - i, ny) (icebergs_framework.F90:649, 933).  The cells are
    general quads (``grid_is_regular=False``); the two polar cells are
    degenerate and belong on land.  The corners are computed point by
    point in float64 exactly as the JAX builder computes them."""
    frac_cap = (90.0 - lat_join) / (90.0 - lat0)
    ny_cap = max(2, int(round(ny * frac_cap)))
    ny_ll = ny - ny_cap
    if ny_ll < 1:
        raise ValueError("ny too small for the requested cap")
    lons = lon0 + 360.0 * np.arange(nx + 1) / nx
    lonc = np.zeros((nx + 1, ny + 1))
    latc = np.zeros((nx + 1, ny + 1))
    for j in range(ny_ll + 1):
        latc[:, j] = lat0 + (lat_join - lat0) * j / ny_ll
        lonc[:, j] = lons

    p1 = _sph(lon0 + 90.0, lat_poles)
    p2 = _sph(lon0 + 270.0, lat_poles)
    npole = np.array([0.0, 0.0, 1.0])
    half = nx // 2
    fold = np.zeros((nx + 1, 3))
    for i in range(half + 1):
        t = i / half
        fold[i] = (_slerp(p1, npole, 2 * t) if t <= 0.5
                   else _slerp(npole, p2, 2 * t - 1))
    for i in range(half + 1, nx + 1):
        fold[i] = fold[nx - i]
    for i in range(nx + 1):
        q = _sph(lons[i], lat_join)
        for k in range(1, ny_cap + 1):
            lonc[i, ny_ll + k], latc[i, ny_ll + k] = _geo(
                _slerp(q, fold[i], k / ny_cap))
    # longitudes continuous along each column (no 360 jumps)
    for i in range(nx + 1):
        for j in range(ny_ll + 1, ny + 1):
            d = lonc[i, j] - lonc[i, j - 1]
            if d > 180.0:
                lonc[i, j] -= 360.0
            elif d < -180.0:
                lonc[i, j] += 360.0
    return make_curvilinear_grid(lonc, latc, Rearth=Rearth, msk=msk,
                                 ocean_depth=ocean_depth, dtype=dtype,
                                 device=device)

"""Eulerian grid container and the regular-grid geometry the step uses.

PyTorch counterpart of ``icebergs_tpu/grid.py`` (``Grid``,
``make_uniform_grid``, ``pos_to_cell``, ``cell_to_pos``,
``bilin_corner``, and the Cartesian branch of
``convert_from_grid_to_meters`` / ``convert_from_meters_to_grid``), with the same layout conventions: corner arrays
``(nx+1, ny+1)``, halo-padded center arrays ``(nx+2, ny+2)`` with cell
``(i, j)`` at ``[i+1, j+1]``, and 0-dim float32 tensors for the
regular-grid metadata.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C


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
    (icebergs.F90:443-460): ones on a Cartesian grid."""
    if grid_is_latlon:
        raise NotImplementedError("lat-lon metric factors (ROADMAP.md Queue "
                                  "1 item 11)")
    one = torch.ones_like(lat_ref)
    return one, one


def convert_from_meters_to_grid(lat_ref, grid_is_latlon: bool,
                                Rearth: float):
    """Metric factors (dlon/dx, dlat/dy) at a latitude
    (icebergs.F90:462-478): ones on a Cartesian grid."""
    return convert_from_grid_to_meters(lat_ref, grid_is_latlon, Rearth)


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

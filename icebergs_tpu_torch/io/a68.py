"""A68 hindcast data loader.

Counterpart of ``icebergs_tpu/io/a68.py`` (``driver/driver_data_fms2.F90``):
reads the A68 experiment grid (``a68_experiment_ll_p125_grid.nc``:
longitude / latitude node arrays at 0.125 degrees) and the hourly forcing
stacks (NCEP 10-m winds, OSCAR surface currents, DUACS SSH), builds a
curvilinear :class:`~..grid.Grid` with the reference's haversine metric
terms, and serves per-hour :class:`~..forcing.Forcing` snapshots.  The
hourly stacks stay float64 numpy on the host; a snapshot is rounded once
to the model's dtype on the device, as the JAX package rounds it.

Any NetCDF3 files with the reference's variable names load (the tests
and ``chip_smoke.py`` write synthetic fixtures of that schema).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from scipy.io import netcdf_file

from ..config import IcebergsConfig
from ..forcing import Forcing
from ..grid import Grid, make_curvilinear_grid

GRID_FILE = "a68_experiment_ll_p125_grid.nc"
WIND_FILE = "a68_experiment_wind_vel_ncep_10m_dec2020_HOURLY_ll_p125.nc"
OCEAN_FILE = "a68_experiment_ocean_surf_vel_oscar_dec2020_HOURLY_ll_p125.nc"
SSH_FILE = "a68_experiment_ssh_duacs_dec2020_HOURLY_ll_p125.nc"
GRES = 0.125


class A68Data(NamedTuple):
    grid: Grid
    ua_hr: np.ndarray    # (nt, nx+1, ny+1) corner winds
    va_hr: np.ndarray
    uo_hr: np.ndarray
    vo_hr: np.ndarray
    ssh_hr: np.ndarray   # (nt, nx+2, ny+2) padded centres

    @property
    def n_hours(self) -> int:
        return self.ua_hr.shape[0]


def _read(path, names):
    with netcdf_file(path, "r", mmap=False) as f:
        return {n: np.asarray(f.variables[n][:]).astype(np.float64)
                for n in names}


def haversine_dist_and_area(Rearth, gres, lon, lat):
    """dx / dy / area from node coordinates (haversine_dist_and_area,
    driver_data_fms2.F90:80-118), float64 numpy."""
    p = np.pi / 180.

    def hav(lat1, lat2, dlon_deg):
        dp = (lat2 - lat1) * p
        dm = dlon_deg * p
        a = np.sin(0.5 * dp) ** 2 + np.cos(lat1 * p) * np.cos(lat2 * p) \
            * np.sin(0.5 * dm) ** 2
        return Rearth * 2. * np.arctan2(np.sqrt(a), np.sqrt(1 - a))

    dx = hav(lat, lat, -gres)
    dy = hav(lat, lat - gres, 0.)
    area = p * Rearth ** 2 * np.abs(np.sin(lat * p)
                                    - np.sin((lat - gres) * p)) * abs(gres)
    return dx, dy, area


def load_a68(data_dir: str, cfg: IcebergsConfig, dtype=torch.float32, *,
             device) -> A68Data:
    """The A68 grid on ``device`` and the hourly forcing stacks
    (a68_prep / a68_prep_3d)."""
    g = _read(os.path.join(data_dir, GRID_FILE), ("longitude", "latitude"))
    lon = g["longitude"] + 360.0           # the reference shifts to 0..360
    lat = g["latitude"]
    if lon.ndim == 1:
        lon, lat = np.meshgrid(lon, lat, indexing="ij")
    # the nodes are cell north-east corners: extend one row and column
    # south-west at the same spacing for the (nx+1, ny+1) corner grid
    lonc = np.empty((lon.shape[0] + 1, lon.shape[1] + 1))
    latc = np.empty_like(lonc)
    lonc[1:, 1:] = lon
    latc[1:, 1:] = lat
    lonc[0, 1:] = lon[0] - GRES
    latc[0, 1:] = lat[0]
    lonc[:, 0] = lonc[:, 1]
    latc[1:, 0] = lat[:, 0] - GRES
    latc[0, 0] = latc[1, 0]
    lonc[0, 0] = lonc[0, 1]

    grid = make_curvilinear_grid(lonc, latc, Rearth=cfg.Rearth, dtype=dtype,
                                 device=device)
    # the reference overrides dx / dy / area with its own haversine forms
    dx, dy, area = haversine_dist_and_area(cfg.Rearth, GRES, lon, lat)

    def pad(a):
        return torch.as_tensor(np.pad(a, 1)).to(device, dtype)

    grid = grid.replace(dx=pad(dx), dy=pad(dy), area=pad(area),
                        ocean_depth=torch.full_like(grid.ocean_depth, 1000.))

    w = _read(os.path.join(data_dir, WIND_FILE), ("ua", "va"))
    o = _read(os.path.join(data_dir, OCEAN_FILE), ("uo", "vo"))
    s = _read(os.path.join(data_dir, SSH_FILE), ("SSH",))

    def nodes(a):
        """(nt, ...) node fields in (t, x, y) order."""
        return a if a.shape[-2:] == lon.shape else np.transpose(a, (0, 2, 1))

    def corners(a):
        a = nodes(a)
        out = np.zeros((a.shape[0], lonc.shape[0], lonc.shape[1]))
        out[:, 1:, 1:] = a
        out[:, 0, :] = out[:, 1, :]
        out[:, :, 0] = out[:, :, 1]
        return np.nan_to_num(out)

    def centers(a):
        a = nodes(a)
        out = np.zeros((a.shape[0], lon.shape[0] + 2, lon.shape[1] + 2))
        out[:, 1:-1, 1:-1] = np.nan_to_num(a)
        return out

    return A68Data(grid=grid,
                   ua_hr=corners(w["ua"]), va_hr=corners(w["va"]),
                   uo_hr=corners(o["uo"]), vo_hr=corners(o["vo"]),
                   ssh_hr=centers(s["SSH"]))


def forcing_at_hour(data: A68Data, ind: int, *, sst=-2.0, sss=34.0,
                    dtype=torch.float32) -> Forcing:
    """The forcing of hour index ``ind``, clipped to the stacks (the
    driver's transient_a68_data_start_ind + step indexing,
    driver:368-383), on the grid's device."""
    ind = int(np.clip(ind, 0, data.n_hours - 1))
    dev = data.grid.device

    def t(a):
        return torch.as_tensor(a[ind]).to(dev, dtype)

    zc = torch.zeros(data.ua_hr.shape[1:], dtype=dtype, device=dev)
    shape_c = data.ssh_hr.shape[1:]
    return Forcing(
        uo=t(data.uo_hr), vo=t(data.vo_hr), ui=zc, vi=zc,
        ua=t(data.ua_hr), va=t(data.va_hr), ssh=t(data.ssh_hr),
        sst=torch.full(shape_c, sst, dtype=dtype, device=dev),
        sss=torch.full(shape_c, sss, dtype=dtype, device=dev),
        cn=torch.zeros(shape_c, dtype=dtype, device=dev),
        hi=torch.zeros(shape_c, dtype=dtype, device=dev))

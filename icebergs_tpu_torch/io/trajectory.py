"""Lagrangian trajectory recording and NetCDF output.

Counterpart of ``icebergs_tpu/io/trajectory.py``'s single-device parts
(``:35-211``; the xyt lists and writer of the reference,
``record_posn`` / ``move_trajectory``, icebergs_framework.F90:5328-5709;
``write_trajectory``, icebergs_fms2io.F90:1631-2104).  A buffer of
``nsamples`` snapshot rows lives on the state's device; each sampling
step writes one row by a masked copy (no host read: the next row is
counted on the host), and :func:`write_trajectories` drains the valid
entries to an append-style ``iceberg_trajectories.nc`` with the
reference's schema (short / footloose / full), variable for variable
the JAX package's file.  The tiled recording (``trajectory.py:213-258``)
keeps one buffer per local tile and drains each to its own file
``path.NNNN`` (the reference's io_layout suffixes,
icebergs_fms2io.F90:1663-1738).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from scipy.io import netcdf_file

from ..config import IcebergsConfig

SHORT_VARS = ("lon", "lat", "year", "day", "id_cnt", "id_ij")
FL_EXTRA = ("uvel", "vvel", "mass", "mass_scaling", "mass_of_bits",
            "mass_of_fl_bits", "mass_of_fl_bergy_bits", "fl_k",
            "thickness", "width", "length", "n_bonds")
FULL_EXTRA = ("uvel", "vvel", "uo", "vo", "ui", "vi", "ua", "va",
              "ssh_x", "ssh_y", "sst", "sss", "cn", "hi",
              "mass", "thickness", "width", "length", "mass_scaling",
              "mass_of_bits", "heat_density")
_INTS = ("id_cnt", "id_ij", "year")
BOND_NAMES = ("lon", "lat", "day", "first_id_cnt", "first_id_ij",
              "other_id_cnt", "other_id_ij", "nstress", "sstress", "broken")
_BOND_INTS = ("first_id_cnt", "first_id_ij", "other_id_cnt", "other_id_ij",
              "broken")


class TrajBuffer(NamedTuple):
    data: dict            # name -> (nsamples, width) tensor
    valid: torch.Tensor   # (nsamples, width) bool
    cursor: int           # samples recorded (the next row, mod nsamples)


def traj_fields(cfg: IcebergsConfig):
    if cfg.save_short_traj:
        extra = ()
    elif cfg.save_fl_traj:
        extra = FL_EXTRA
    else:
        extra = FULL_EXTRA
    return ("lon", "lat", "day") + tuple(extra)


def _buffer(names, ints, nsamples, width, dtype, device) -> TrajBuffer:
    return TrajBuffer(
        data={n: torch.zeros(nsamples, width, device=device,
                             dtype=torch.int32 if n in ints else dtype)
              for n in names},
        valid=torch.zeros(nsamples, width, dtype=torch.bool, device=device),
        cursor=0)


def init_traj_buffer(capacity: int, nsamples: int, cfg: IcebergsConfig,
                     dtype=torch.float32, *, device) -> TrajBuffer:
    return _buffer(traj_fields(cfg) + _INTS, _INTS, nsamples, capacity,
                   dtype, device)


def init_bond_traj_buffer(capacity: int, max_bonds: int, nsamples: int,
                          dtype=torch.float32, *, device) -> TrajBuffer:
    """Bond trajectory buffer (bond_xyt lists + save_bond_traj,
    icebergs_framework.F90:389-407; writer icebergs_fms2io.F90:2105-2332):
    one record per directed bond slot per sample."""
    return _buffer(BOND_NAMES, _BOND_INTS, nsamples, capacity * max_bonds,
                   dtype, device)


def grow_traj_buffer(buf: TrajBuffer, new_width: int) -> TrajBuffer:
    """Pad the per-slot (trailing) axis to ``new_width`` (the driver's
    increase_ibuffer analog: the buffers grow with the slot pool).
    Recorded samples keep their rows; new slots append at the end (in
    the bond buffer, the new slots' bonds)."""
    old = buf.valid.shape[-1]
    if new_width <= old:
        return buf

    def pad(a):
        return torch.nn.functional.pad(a, (0, new_width - old))
    return TrajBuffer(data={n: pad(a) for n, a in buf.data.items()},
                      valid=pad(buf.valid), cursor=buf.cursor)


def _record(buf: TrajBuffer, ok, src) -> TrajBuffer:
    """Write one row (in place) and advance the cursor."""
    row = buf.cursor % buf.valid.shape[0]
    for name, a in buf.data.items():
        a[row] = torch.where(ok, src[name], 0).to(a.dtype)
    buf.valid[row] = ok
    return buf._replace(cursor=buf.cursor + 1)


def record_posn(buf: TrajBuffer, st, cfg: IcebergsConfig, day, year,
                sample_mask=None) -> TrajBuffer:
    """Record one snapshot row of the eligible bergs (record_posn); the
    buffer's tensors are updated in place.

    Eligibility as icebergs_framework.F90:5370-5388: ``current_year >
    save_all_traj_year``, or the class filter (save_nonfl_traj_by_class
    with the hemisphere's start-mass threshold), or ``berg_area >=
    traj_area_thres``, or any bond, or a footloose child above
    traj_area_thres_fl; areas are mass / (rho_bergs thickness) in m^2,
    the thresholds km^2 (framework:5362-5364)."""
    thick_safe = st.thickness.clamp(min=1e-30)
    berg_area = st.mass / (cfg.rho_bergs * thick_safe)       # m^2
    is_child = st.fl_k < 0.
    ok = berg_area >= cfg.traj_area_thres * 1e6
    ok = ok | (is_child & (berg_area > cfg.traj_area_thres_fl * 1e6))
    if cfg.save_nonfl_traj_by_class:
        thres = torch.where(
            st.lat < 0.,
            torch.full_like(st.lat,
                            cfg.save_traj_by_class_start_mass_thres_s),
            torch.full_like(st.lat,
                            cfg.save_traj_by_class_start_mass_thres_n))
        ok = ok | (~is_child
                   & (berg_area > cfg.traj_area_thres_sntbc * 1e6)
                   & (st.start_mass >= thres))
    npdt = st.lon.new_empty(()).cpu().numpy().dtype
    if np.asarray(year, npdt) > np.asarray(cfg.save_all_traj_year, npdt):
        ok = torch.ones_like(ok)
    if cfg.iceberg_bonds_on:
        ok = ok | (st.bond_idx >= 0).any(dim=1)
    ok = ok & st.alive & (st.halo_berg < 0.5)
    if sample_mask is not None:
        ok = ok & sample_mask
    src = dict(day=torch.full_like(st.lon, day),
               year=torch.full_like(st.id_cnt, year))
    for name in buf.data:
        if name not in src:
            src[name] = getattr(st, name)
    return _record(buf, ok, src)


def record_bonds(buf: TrajBuffer, st, cfg: IcebergsConfig,
                 day) -> TrajBuffer:
    """Record one bond snapshot row (in place)."""
    N, B = st.bond_idx.shape
    other = st.bond_idx.clamp(min=0).long()
    ok = ((st.bond_idx >= 0) & st.alive[:, None]
          & (st.halo_berg < 0.5)[:, None]).reshape(-1)

    def rep(a):
        return a[:, None].expand(N, B).reshape(-1)

    src = dict(
        lon=rep(st.lon), lat=rep(st.lat),
        day=torch.full((N * B,), day, dtype=buf.data["day"].dtype,
                       device=st.device),
        first_id_cnt=rep(st.id_cnt), first_id_ij=rep(st.id_ij),
        other_id_cnt=st.id_cnt[other].reshape(-1),
        other_id_ij=st.id_ij[other].reshape(-1),
        nstress=st.bond_nstress.reshape(-1),
        sstress=st.bond_sstress.reshape(-1),
        broken=st.bond_broken.reshape(-1))
    return _record(buf, ok, src)


def write_trajectories(path: str, buf: TrajBuffer, cfg: IcebergsConfig):
    """Drain the buffer to an append-style trajectory NetCDF
    (write_trajectory, icebergs_fms2io.F90:1631-2104): the valid entries
    sample by sample, after the file's earlier records.  Returns the
    number of entries written and a cleared buffer."""
    rows, cols = np.nonzero(buf.valid.cpu().numpy())
    old = {}
    if os.path.exists(path):
        with netcdf_file(path, "r", mmap=False) as f:
            old = {k: np.asarray(v[:]) for k, v in f.variables.items()}
    with netcdf_file(path, "w") as f:
        total = len(rows) + (len(next(iter(old.values()))) if old else 0)
        f.createDimension("i", total)
        for name, arr in buf.data.items():
            kind = "i" if arr.dtype == torch.int32 else "d"
            new = arr.cpu().numpy()[rows, cols]
            if name in old:
                new = np.concatenate([old[name], new])
            f.createVariable(name, kind, ("i",))[:] = new.astype(
                np.float64 if kind == "d" else np.int32)
    cleared = TrajBuffer(
        data={k: torch.zeros_like(v) for k, v in buf.data.items()},
        valid=torch.zeros_like(buf.valid), cursor=0)
    return len(rows), cleared


# ---------------------------------------------------------------------------
# tiled recording: one buffer per tile, one file per tile
# ---------------------------------------------------------------------------

def init_traj_buffer_tiled(tiles, capacity: int, nsamples: int,
                           cfg: IcebergsConfig, dtype=torch.float32, *,
                           device):
    """One buffer per local tile: ``tiles`` is a
    :class:`..parallel.domain.Ring` (its local tiles) or a layout tuple
    (every tile)."""
    n = (len(tiles.tiles) if hasattr(tiles, "tiles")
         else int(np.prod(tiles)))
    return [init_traj_buffer(capacity, nsamples, cfg, dtype, device=device)
            for _ in range(n)]


def record_posn_tiled(bufs, tiles, cfg: IcebergsConfig, day, year):
    """:func:`record_posn` on every local tile: halo copies are not
    recorded, so each berg is recorded once, by its owner."""
    return [record_posn(b, s, cfg, day=day, year=year)
            for b, s in zip(bufs, tiles)]


def write_trajectories_tiled(path: str, bufs, cfg: IcebergsConfig, *,
                             ring=None):
    """Drain each local tile's buffer to ``path.NNNN``, NNNN the tile's
    global number (from ``ring``; without it the buffers are every tile
    from 0), the variables in name order as the JAX package's tiled
    files have them (its tiled buffers pass through pytree maps, which
    sort a dict's keys).  Returns the entries written and the cleared
    buffers."""
    ids = list(ring.tiles) if ring is not None else range(len(bufs))
    total, cleared = 0, []
    for k, b in zip(ids, bufs):
        b = b._replace(data={n: b.data[n] for n in sorted(b.data)})
        n, b = write_trajectories(f"{path}.{k:04d}", b, cfg)
        total += n
        cleared.append(b)
    return total, cleared

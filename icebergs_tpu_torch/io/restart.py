"""Restart I/O in the reference's NetCDF schemas.

Counterpart of ``icebergs_tpu/io/restart.py``'s single-device parts
(``:60-368``): the restart triplet of the reference
(``src/icebergs_fms2io.F90``):

* ``icebergs.res.nc``   — per-berg state, 1-D arrays over dim ``i``
  (icebergs_fms2io.F90:124-633; ids split into id_cnt/id_ij, cell
  indices 1-based);
* ``bonds_iceberg.res.nc`` — one record per directed bond with both
  ends' ids and the DEM bond state (321-...);
* ``calving.res.nc``    — stored_ice/stored_heat/running means
  (1484-1598);

and the bathymetry of ``topog.nc``.  Files are NETCDF3 through
``scipy.io.netcdf_file`` with the JAX package's variable order and
types, so that for the same state the two packages write the same bytes
and each reads the other's files.  The bond records are formed and
matched by id with numpy over whole arrays (the JAX package loops in
Python), in the same order.

The distributed (io_layout) restarts of ``restart.py:366-521``: one
``<name>.NNNN`` file (and ``bonds_<name>.NNNN`` with bonds) per tile or
per group of ``io_layout`` consecutive tiles, written from a list of
tile states, and read back into one untiled state.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from scipy.io import netcdf_file

from ..config import IcebergsConfig, NCLASSES
from ..grid import Grid, pos_to_cell
from ..state import ALL_FIELDS, BergState, empty_state

# (netcdf name, state field, dtype char)
BERG_VARS = [
    ("lon", "lon", "d"), ("lat", "lat", "d"),
    ("uvel", "uvel", "d"), ("vvel", "vvel", "d"),
    ("mass", "mass", "d"),
    ("axn", "axn", "d"), ("ayn", "ayn", "d"),
    ("bxn", "bxn", "d"), ("byn", "byn", "d"),
    ("ine", "ine", "i"), ("jne", "jne", "i"),
    ("thickness", "thickness", "d"), ("width", "width", "d"),
    ("length", "length", "d"),
    ("start_lon", "start_lon", "d"), ("start_lat", "start_lat", "d"),
    ("start_year", "start_year", "i"),
    ("id_cnt", "id_cnt", "i"), ("id_ij", "id_ij", "i"),
    ("start_day", "start_day", "d"), ("start_mass", "start_mass", "d"),
    ("mass_scaling", "mass_scaling", "d"),
    ("mass_of_bits", "mass_of_bits", "d"),
    ("heat_density", "heat_density", "d"),
    ("static_berg", "static_berg", "d"),
]
FL_VARS = [("fl_k", "fl_k", "d"),
           ("mass_of_fl_bits", "mass_of_fl_bits", "d"),
           ("mass_of_fl_bergy_bits", "mass_of_fl_bergy_bits", "d"),
           # beyond the reference schema: the per-parent child counter
           # keeps footloose child ids unique across restarts
           ("fl_spawn_count", "fl_spawn_count", "d")]
MTS_VARS = [("axn_fast", "axn_fast", "d"), ("ayn_fast", "ayn_fast", "d"),
            ("bxn_fast", "bxn_fast", "d"), ("byn_fast", "byn_fast", "d")]
DEM_VARS = [("ang_vel", "ang_vel", "d"), ("ang_accel", "ang_accel", "d"),
            ("rot", "rot", "d")]
# bond record name -> state field (the DEM bond state)
BOND_VARS = (("broken", "bond_broken"), ("tangd1", "bond_tangd1"),
             ("tangd2", "bond_tangd2"), ("nstress", "bond_nstress"),
             ("sstress", "bond_sstress"),
             ("rel_rotation", "bond_rel_rotation"))


def _host(x):
    return x.detach().cpu().numpy()


def _native(a):
    """A contiguous copy in native byte order (NetCDF3 is big-endian,
    which torch does not take)."""
    return np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("="))


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def write_restart_bergs(path: str, st: BergState, cfg: IcebergsConfig):
    """The live, owned slots as 1-D arrays -> icebergs.res.nc
    (write_restart_bergs, icebergs_fms2io.F90:124-633)."""
    own = _host(st.alive) & (_host(st.halo_berg) < 0.5)
    idx = np.nonzero(own)[0]
    varlist = list(BERG_VARS)
    if cfg.footloose:
        varlist += FL_VARS
    if cfg.mts:
        varlist += MTS_VARS
    if cfg.dem:
        varlist += DEM_VARS
    with netcdf_file(path, "w") as f:
        f.createDimension("i", len(idx))
        for name, field, kind in varlist:
            v = f.createVariable(name, kind, ("i",))
            data = _host(getattr(st, field))[idx]
            if field in ("ine", "jne"):
                data = data + 1          # the reference's 1-based cells
            v[:] = data.astype(np.float64 if kind == "d" else np.int32)


def read_restart_bergs(path: str, capacity: int, grid: Grid,
                       cfg: IcebergsConfig, dtype=torch.float32, *,
                       device=None) -> BergState:
    """icebergs.res.nc into a fresh state of ``capacity`` slots on
    ``device`` (the grid's by default): the file's bergs in its order in
    the first slots, the ``*_old`` copies set to the current values, and
    each berg re-localised on the grid by :func:`pos_to_cell`, as the
    reference's ignore_ij_restart path does (read_restart_bergs,
    icebergs_fms2io.F90:662-1188).  Positions outside the grid are
    clamped to the nearest cell with a warning on stderr (the reference
    stops there; usually a grid / namelist mismatch)."""
    with netcdf_file(path, "r", mmap=False) as f:
        data = {name: np.asarray(v[:]) for name, v in f.variables.items()}
    return _state_from_records(data, capacity, grid, cfg, dtype, device)


def _state_from_records(data: dict, capacity: int, grid: Grid,
                        cfg: IcebergsConfig, dtype, device) -> BergState:
    """A state of ``capacity`` slots from restart records: the records in
    order in the first slots, re-localised on ``grid``."""
    device = grid.device if device is None else device
    n = len(data["lon"])
    if n > capacity:
        raise ValueError(f"restarts hold {n} bergs > capacity {capacity}")
    st = empty_state(capacity, max_bonds=cfg.max_bonds, dtype=dtype,
                     device=device)
    known = {name: field for name, field, _ in
             BERG_VARS + FL_VARS + MTS_VARS + DEM_VARS}
    kw, host = {}, {}
    for name, arr in data.items():
        field = known.get(name)
        if field is None:
            continue
        ref = getattr(st, field)
        tgt = np.zeros(capacity, _np_dtype(ref.dtype))
        tgt[:n] = arr - 1 if field in ("ine", "jne") else arr
        host[field] = tgt
        kw[field] = torch.as_tensor(tgt).to(device)
    kw["alive"] = torch.arange(capacity, device=device) < n
    st = st.replace(**kw)
    st = st.replace(lon_old=st.lon, lat_old=st.lat,
                    uvel_old=st.uvel, vvel_old=st.vvel)
    Lx = cfg.Lx if cfg.grid_is_latlon else -1.
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, Lx)
    if n:
        lon_h = host.get("lon", np.zeros(capacity, np.float32))[:n]
        lat_h = host.get("lat", np.zeros(capacity, np.float32))[:n]
        g_lo_x = float(grid.lon0)
        g_hi_x = g_lo_x + grid.nx * float(grid.dlon)
        g_lo_y = float(grid.lat0)
        g_hi_y = g_lo_y + grid.ny * float(grid.dlat)
        out = (lat_h < g_lo_y) | (lat_h > g_hi_y)
        if not (cfg.grid_is_latlon and cfg.Lx > 0.):   # x periodic?
            out = out | (lon_h < g_lo_x) | (lon_h > g_hi_x)
        nbad = int(out.sum())
        if nbad:
            k = int(np.argmax(out))
            print(f"KID-TPU WARNING: {nbad}/{n} restart bergs lie "
                  f"outside the grid (first at lon={lon_h[k]:.6g}, "
                  f"lat={lat_h[k]:.6g}; grid x [{g_lo_x:.6g}, "
                  f"{g_hi_x:.6g}] y [{g_lo_y:.6g}, {g_hi_y:.6g}]) — "
                  "clamped to the nearest cell; check grid_is_latlon / "
                  "ni / nj / gridres in the namelist",
                  file=sys.stderr)
    return st.replace(ine=i, jne=j, xi=xi, yj=yj)


# --------------------------------------------------------------------------
# bonds restart
# --------------------------------------------------------------------------

def write_restart_bonds(path: str, st: BergState, cfg: IcebergsConfig):
    """bonds_iceberg.res.nc: one record per directed bond of a live,
    owned berg, in slot order then bond-slot order (the write path of
    icebergs_fms2io.F90:321-...).  The partner's identity comes from
    the id stamps (``bond_id_cnt`` / ``bond_id_ij``) where they are set,
    else from the partner slot; the partner's cell is 0 where its slot
    is not local."""
    alive = _host(st.alive) & (_host(st.halo_berg) < 0.5)
    bond_idx = _host(st.bond_idx)
    sid_cnt, sid_ij = _host(st.bond_id_cnt), _host(st.bond_id_ij)
    ine, jne = _host(st.ine) + 1, _host(st.jne) + 1
    id_cnt, id_ij = _host(st.id_cnt), _host(st.id_ij)
    stamped = (sid_cnt != 0) | (sid_ij != 0)
    a, b = np.nonzero(alive[:, None] & ((bond_idx >= 0) | stamped))
    o = bond_idx[a, b]
    on = np.maximum(o, 0)
    here = stamped[a, b]
    cols = [("first_berg_ine", ine[a]), ("first_berg_jne", jne[a]),
            ("first_id_cnt", id_cnt[a]), ("first_id_ij", id_ij[a]),
            ("other_berg_ine", np.where(o >= 0, ine[on], 0)),
            ("other_berg_jne", np.where(o >= 0, jne[on], 0)),
            ("other_id_cnt", np.where(here, sid_cnt[a, b], id_cnt[on])),
            ("other_id_ij", np.where(here, sid_ij[a, b], id_ij[on]))]
    with netcdf_file(path, "w") as f:
        f.createDimension("i", len(a))
        for name, vals in cols:
            f.createVariable(name, "i", ("i",))[:] = vals.astype(np.int32)
        if cfg.dem:
            for name, field in BOND_VARS:
                kind = "i" if name == "broken" else "d"
                f.createVariable(name, kind, ("i",))[:] = _host(
                    getattr(st, field))[a, b].astype(
                        np.int32 if kind == "i" else np.float64)


def read_restart_bonds(path: str, st: BergState,
                       cfg: IcebergsConfig) -> BergState:
    """Re-match the bond records to state slots by id and relabel the
    conglomerates (read_restart_bonds + connect_all_bonds,
    icebergs_fms2io.F90:1190-1482)."""
    with netcdf_file(path, "r", mmap=False) as f:
        data = {k: np.asarray(v[:]) for k, v in f.variables.items()}
    return _apply_bond_records(st, data, cfg)


def _id_key(cnt, ij):
    return (np.asarray(cnt, np.int64) << 32) | (np.asarray(ij, np.int64)
                                                & 0xFFFFFFFF)


def _apply_bond_records(st: BergState, data: dict,
                        cfg: IcebergsConfig) -> BergState:
    """Each record whose two ids are both live takes the next free bond
    slot of its first berg, in record order (a repeated id names its
    last slot); ``n_bonds`` becomes the count of matched records."""
    slots = np.nonzero(_host(st.alive))[0]
    keys = _id_key(_host(st.id_cnt)[slots], _host(st.id_ij)[slots])
    order = np.argsort(keys, kind="stable")
    ks = keys[order]

    def slot_of(cnt, ij):
        q = _id_key(cnt, ij)
        pos = np.searchsorted(ks, q, side="right") - 1
        hit = (pos >= 0) & (ks[np.maximum(pos, 0)] == q)
        return np.where(hit, slots[order[np.maximum(pos, 0)]], -1)

    a = slot_of(data["first_id_cnt"], data["first_id_ij"])
    o = slot_of(data["other_id_cnt"], data["other_id_ij"])
    rec = np.nonzero((a >= 0) & (o >= 0))[0]
    a = a[rec]
    # each record's rank among its first berg's records
    srt = np.argsort(a, kind="stable")
    first = np.ones(len(a), bool)
    first[1:] = a[srt][1:] != a[srt][:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(len(a)), 0))
    k = np.empty(len(a), np.int64)
    k[srt] = np.arange(len(a)) - start
    if len(k) and k.max() >= st.max_bonds:
        raise ValueError("too many bonds for max_bonds")

    dev, dt = st.device, st.dtype
    bond_idx = _host(st.bond_idx).copy()
    bond_idx[a, k] = o[rec]
    kw = dict(bond_idx=torch.as_tensor(bond_idx, device=dev),
              n_bonds=torch.as_tensor(np.bincount(
                  a, minlength=st.capacity)).to(dev, dt))
    for name, field in BOND_VARS:
        arr = _host(getattr(st, field)).copy()
        if name in data:
            arr[a, k] = data[name][rec]
        kw[field] = torch.as_tensor(arr).to(
            dev, torch.int32 if name == "broken" else dt)
    from ..ops.forces import compute_conglom_ids_host
    return compute_conglom_ids_host(st.replace(**kw))


# --------------------------------------------------------------------------
# calving restart
# --------------------------------------------------------------------------

def write_restart_calving(path: str, calv, grid: Grid):
    """calving.res.nc: stored_ice, stored_heat, the running means and the
    id counters of the interior cells (the write path of
    icebergs_fms2io.F90:1484-1598)."""
    si = _host(calv.stored_ice)[1:-1, 1:-1]          # (nx, ny, k)
    sh = _host(calv.stored_heat)[1:-1, 1:-1]
    rc = _host(calv.rmean_calving)[1:-1, 1:-1]
    rh = _host(calv.rmean_calving_hflx)[1:-1, 1:-1]
    idc = _host(calv.id_counter)[1:-1, 1:-1]
    nx, ny = sh.shape
    with netcdf_file(path, "w") as f:
        f.createDimension("xaxis_1", nx)
        f.createDimension("yaxis_1", ny)
        f.createDimension("zaxis_1", NCLASSES)
        v = f.createVariable("stored_ice", "d",
                             ("zaxis_1", "yaxis_1", "xaxis_1"))
        v[:] = np.transpose(si, (2, 1, 0))
        for name, arr in (("stored_heat", sh), ("rmean_calving", rc),
                          ("rmean_calving_hflx", rh)):
            v = f.createVariable(name, "d", ("yaxis_1", "xaxis_1"))
            v[:] = arr.T
        v = f.createVariable("id_cnt_grid", "i", ("yaxis_1", "xaxis_1"))
        v[:] = idc.T.astype(np.int32)


def read_restart_calving(path: str, calv, grid: Grid):
    """The calving state of ``calv`` with the fields calving.res.nc
    holds."""
    with netcdf_file(path, "r", mmap=False) as f:
        data = {k: np.asarray(v[:]) for k, v in f.variables.items()}
    dev = calv.stored_heat.device

    def t(a, dtype):
        return torch.as_tensor(_native(a)).to(dev, dtype)

    kw = {}
    if "stored_ice" in data:
        si = np.transpose(data["stored_ice"], (2, 1, 0))    # (nx, ny, k)
        kw["stored_ice"] = t(np.pad(si, ((1, 1), (1, 1), (0, 0))),
                             calv.stored_ice.dtype)
    for name in ("stored_heat", "rmean_calving", "rmean_calving_hflx"):
        if name in data:
            kw[name] = t(np.pad(data[name].T, 1), calv.stored_heat.dtype)
    if "id_cnt_grid" in data:
        kw["id_counter"] = t(np.pad(data["id_cnt_grid"].T, 1), torch.int32)
    return calv.replace(**kw)


def read_ocean_depth(path: str, grid: Grid) -> Grid:
    """Bathymetry from ``topog.nc`` into the grid (read_ocean_depth,
    icebergs_fms2io.F90:1600-1629): variable ``depth``, in (i, j) or
    (j, i) order; a missing file or variable leaves the grid's
    ocean_depth as it is, as the reference falls through."""
    if not os.path.exists(path):
        print(f"KID-TPU, read_ocean_depth: {path} not present")
        return grid
    with netcdf_file(path, "r", mmap=False) as f:
        if "depth" not in f.variables:
            print("KID-TPU, read_ocean_depth: depth WAS NOT FOUND "
                  "in the file.")
            return grid
        depth = np.asarray(f.variables["depth"][:])
    print(f"KID-TPU, read_ocean_depth: reading {path}")
    if depth.shape != (grid.nx, grid.ny) \
            and depth.shape == (grid.ny, grid.nx):   # (j, i) file order
        depth = depth.T
    if depth.shape != (grid.nx, grid.ny):
        raise ValueError(f"topog depth shape {depth.shape} does not match "
                         f"grid ({grid.nx}, {grid.ny})")
    od = grid.ocean_depth
    return grid.replace(ocean_depth=torch.as_tensor(
        _native(np.pad(depth, 1))).to(od.device, od.dtype))


# --------------------------------------------------------------------------
# distributed (io_layout) restarts: one file per tile
# --------------------------------------------------------------------------

def write_restart_bergs_tiled(basepath: str, tiles, cfg: IcebergsConfig,
                              io_layout: int = 1, *, ring=None):
    """Per-tile restart files ``<basepath>.NNNN`` from the local tiles'
    states (the reference's io_layout-decomposed restart writes,
    icebergs_fms2io.F90:124-633, mpp_define_io_domain at
    framework:921).  Each tile writes its owned bergs only, so the union
    of the files is the global state.  ``ring`` names the tiles' global
    numbers (the rank form: each rank writes its own tiles,
    :func:`..parallel.multihost.local_tile_range`); without it the list
    is every tile from 0.

    ``io_layout`` > 1 puts that many consecutive tiles in one file (the
    io-tile root's gather, icebergs_fms2io.F90:91-122): file NNNN holds
    the bergs of tiles [NNNN io_layout, (NNNN + 1) io_layout), and only
    groups held whole by this process are written.  With bonds on,
    ``bonds_<name>.NNNN`` holds each group's bond records.  Returns the
    paths written."""
    ids = list(ring.tiles) if ring is not None else list(range(len(tiles)))
    local = dict(zip(ids, tiles))
    groups = {}
    for d in ids:
        groups.setdefault(d // io_layout, []).append(d)
    paths = []
    for g in sorted(groups):
        members = groups[g]
        if len(members) != io_layout:
            continue
        parts = [local[d] for d in members]
        stl = BergState(**{f: torch.cat([getattr(p, f) for p in parts])
                           for f in ALL_FIELDS})
        if io_layout > 1 and cfg.iceberg_bonds_on:
            # each member's local bond slots shift by the capacities
            # before it
            caps = np.cumsum([0] + [p.capacity for p in parts[:-1]])
            off = torch.as_tensor(np.repeat(caps, [p.capacity
                                                   for p in parts]),
                                  dtype=torch.int32,
                                  device=stl.device)[:, None]
            stl = stl.replace(bond_idx=torch.where(
                stl.bond_idx >= 0, stl.bond_idx + off, -1).to(torch.int32))
        p = f"{basepath}.{g:04d}"
        write_restart_bergs(p, stl, cfg)
        paths.append(p)
        if cfg.iceberg_bonds_on:
            write_restart_bonds(_bond_tile_path(basepath, g), stl, cfg)
    return paths


def _bond_tile_path(basepath: str, d: int) -> str:
    head, tail = os.path.split(basepath)
    return os.path.join(head, f"bonds_{tail}.{d:04d}")


def _read_merged(pattern: str, what: str) -> dict:
    """Every variable of the files ``pattern`` matches, in file-name
    order, concatenated."""
    import glob
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(what)
    datas = []
    for p in files:
        with netcdf_file(p, "r", mmap=False) as f:
            datas.append({k: np.asarray(v[:]) for k, v in
                          f.variables.items()})
    return {k: np.concatenate([d[k] for d in datas]) for k in datas[0]}


def read_restart_bonds_tiled(basepath: str, st: BergState,
                             cfg: IcebergsConfig) -> BergState:
    """The bond records of every ``bonds_<name>.NNNN`` file re-matched by
    id onto a merged state (the counterpart of
    :func:`read_restart_bergs_tiled` for bonded and DEM runs)."""
    head, tail = os.path.split(basepath)
    data = _read_merged(
        os.path.join(head, f"bonds_{tail}") + ".[0-9][0-9][0-9][0-9]",
        f"no tiled bond restarts bonds_{tail}.NNNN next to {basepath}")
    return _apply_bond_records(st, data, cfg)


def read_restart_bergs_tiled(basepath: str, capacity: int, grid: Grid,
                             cfg: IcebergsConfig, dtype=torch.float32, *,
                             device=None) -> BergState:
    """One untiled state of ``capacity`` slots from the ``<basepath>.NNNN``
    tile files (fms2_io's domain reads reassemble them), each berg
    re-localised on ``grid``."""
    data = _read_merged(basepath + ".[0-9][0-9][0-9][0-9]",
                        f"no tiled restarts at {basepath}.NNNN")
    return _state_from_records(data, capacity, grid, cfg, dtype, device)

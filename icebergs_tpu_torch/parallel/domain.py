"""Spatial domain decomposition: tiles, halos and particle migration.

Counterpart of ``icebergs_tpu/parallel/domain.py``, the reference's
FMS/MPI layer (``mpp_define_domains``, the halo updates and the particle
sends, ``src/icebergs_framework.F90:913-934, 1800-2135, 2997-3249``), in
full: the tile grids and the host-side decomposition (``:68-285``), the
particle exchange (``:292-539``) with its tripolar fold (``:340-414``)
and the conglomerate replication of bonded runs (``:542-676``), the tiled
coupling step and run in 1-D (tiles along x) and 2-D (``:683-1104,
1328-1503``), and the tiled MTS step with its per-substep ghost refresh
(``:1121-1325``).

The JAX package runs one program per device under ``shard_map`` and
moves its slabs by ``ppermute``.  Here a process holds a list of tiles —
all of them, or one block per rank of a ``torch.distributed`` group —
and a :class:`Ring` moves fixed-shape buffers between them: in one
process a rotation of the list, across ranks ``dist.batch_isend_irecv``
(``gloo`` on the CPU, ``nccl`` on cards).  Its reductions add the tiles'
values in tile order in both forms, so one process and N ranks give the
same bits.  Each tile's physics is the port's single-device step
(:func:`..model.make_step`, :func:`..api.run_coupling_sequence`), built
once per tile, so on CUDA tensors every tile launches the kernels of the
untiled path.

The exchange keeps the JAX ring exactly: an axis pass wraps around even
on a non-periodic world (``domain.py:426-427``) and runs hi then lo,
migration before the halo copies (``:451``, ``:467``); two tiles are each
other's left and right neighbour and one tile is its own.  A packed
buffer is one (C, width) int32 matrix of the state's bit columns, row 0
the ``alive`` flag (which is the buffer slot's validity): K1's column
gather (:func:`..ops.pack.permute_cols_u32`) packs it, and a second K1
gather through the inverted grant of :func:`..state.allocate_slots`
writes the received rows into the tile's dead slots.  The tiles' states
are lists of :class:`..state.BergState` (forcing: of :class:`..forcing.
Forcing`); the exchange counters come back per tile as one (tiles,
passes, 2) int32 tensor, each pass's buffer overflow and slot overflow
(``ov1``, ``ov2``): 4 passes an axis (migration hi and lo, then the halo
copies), then on a folded world the fold's 2 (migration, halo strip),
then with bonds the replication's ``(ov1, ov2)`` and its id list's
``(ov_ids, 0)``; the tiled MTS step appends ``(ov_ship, ov_rep)`` and
``(replicas not found, 0)``.  Their sum over the last two axes is the
JAX package's per-device ``overflow``.

The JAX package matches ids densely (``ship`` an (N, tiles x cap)
comparison, ``keep`` a (tiles x width, cap) one, the ghost match an
(slots, S) one and its ``argmax``); here the same rows come from sorted
membership (binary searches of sorted ids: ``searchsorted``), in the
same order.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..api import ModelState, coupling_sequence
from ..calving import class_grids, init_calving_state
from ..config import IcebergsConfig
from ..convert import state_from_numpy, to_numpy
from ..diag import Budgets
from ..forcing import Forcing
from ..grid import Grid, make_uniform_grid, pos_to_cell
from ..model import make_step
from ..mts import MtsEvent, converged
from ..ops.forces import (connect_bonds_by_id, count_bonds, neighbor_radius,
                          stamp_bond_ids)
from ..ops.pack import from_bits, permute_cols_u32, to_bits
from ..ops.segment_spread import cell_tables
from ..state import (ALL_FIELDS, BOND_FLOAT_FIELDS, BOND_INT_FIELDS,
                     FLOAT_FIELDS, INT_FIELDS, BergState, allocate_slots,
                     empty_state)

AXIS, AXIS_Y = "x", "y"
_AXIS_DIM = {AXIS: 0, AXIS_Y: 1}
# a buffer's rows: every (N,) field, alive first, then each bond table's
# max_bonds columns
_ONE_D = ("alive",) + FLOAT_FIELDS + INT_FIELDS
_BOND = BOND_FLOAT_FIELDS + BOND_INT_FIELDS
_ROW = {f: r for r, f in enumerate(_ONE_D)}
_CORNER = ("uo", "vo", "ui", "vi", "ua", "va")
_CENTER = ("ssh", "sst", "sss", "cn", "hi")


class Ring:
    """The tiles of a ``(ndx,)`` or ``(ndx, ndy)`` layout that this
    process holds, and the moves between them along each axis's ring.

    Without a ``torch.distributed`` group of more than one rank the
    process holds every tile; in a group of W ranks, rank r holds the
    block of ``ntiles / W`` tiles from ``r ntiles / W``.  Tile t of a 2-D
    layout is (t // ndy, t % ndy), x-major as the JAX mesh's devices.

    ``bytes`` counts the traffic of the local tiles: each buffer a tile
    sends by :meth:`shift` or :meth:`permute`, and each tile's whole
    output of :meth:`gather` (the measures of tests/test_ring_scaling.py:
    ppermute operand bytes, all_gather output bytes)."""

    def __init__(self, layout):
        layout = ((int(layout),) if isinstance(layout, int)
                  else tuple(int(n) for n in layout))
        if len(layout) not in (1, 2) or min(layout) < 1:
            raise ValueError(f"layout {layout}: need (ndx,) or (ndx, ndy)")
        self.layout = layout
        self.ntiles = math.prod(layout)
        self.world, self.rank = 1, 0
        if dist.is_available() and dist.is_initialized():
            self.world, self.rank = dist.get_world_size(), dist.get_rank()
        if self.ntiles % self.world:
            raise ValueError(f"{self.ntiles} tiles over {self.world} ranks")
        self.per_rank = self.ntiles // self.world
        self.tiles = list(range(self.rank * self.per_rank,
                                (self.rank + 1) * self.per_rank))
        self._local = {t: k for k, t in enumerate(self.tiles)}
        self.bytes = 0

    def coords(self, t: int):
        return (t,) if len(self.layout) == 1 else divmod(t, self.layout[1])

    def neighbour(self, t: int, axis, step: int) -> int:
        """The tile ``step`` along ``axis`` ("x" / "y") from tile t, round
        the ring."""
        c = list(self.coords(t))
        a = _AXIS_DIM[axis]
        c[a] = (c[a] + step) % self.layout[a]
        return c[0] if len(c) == 1 else c[0] * self.layout[1] + c[1]

    def shift(self, bufs: Sequence[torch.Tensor], axis, step: int):
        """Each local tile's ``bufs`` entry goes to its neighbour ``step``
        along ``axis``; returns, for each local tile, the buffer its
        neighbour ``-step`` sent (``ppermute`` with the ring's shift).
        Buffers have one shape and dtype on every tile."""
        return self.permute(bufs, lambda t: self.neighbour(t, axis, step))

    def permute(self, bufs: Sequence[torch.Tensor], dest):
        """Each local tile t's ``bufs`` entry goes to tile ``dest(t)`` (a
        permutation of the tiles); returns, for each local tile, the
        buffer sent to it (``ppermute``)."""
        src_of = {dest(t): t for t in range(self.ntiles)}
        out, ops = [], []
        for k, t in enumerate(self.tiles):
            self.bytes += bufs[k].numel() * bufs[k].element_size()
            src = src_of[t]
            if src in self._local:
                out.append(bufs[self._local[src]])
            else:
                out.append(torch.empty_like(bufs[k]))
                ops.append(dist.P2POp(dist.irecv, out[k],
                                      src // self.per_rank, tag=t))
        for k, t in enumerate(self.tiles):
            dst = dest(t)
            if dst not in self._local:
                ops.append(dist.P2POp(dist.isend, bufs[k].contiguous(),
                                      dst // self.per_rank, tag=dst))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def gather(self, vals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every tile's value, in tile order, from each local tile's
        ``vals`` entry (one shape on every tile)."""
        self.bytes += len(self.tiles) * self.ntiles * sum(
            v.numel() * v.element_size() for v in vals[:1])
        if self.world == 1:
            return list(vals)
        local = torch.stack(list(vals))
        parts = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(parts, local)
        return [p[i] for p in parts for i in range(p.shape[0])]

    def sum(self, vals):
        """The sum over all tiles, added in tile order (``psum``)."""
        allv = self.gather(vals)
        total = allv[0]
        for v in allv[1:]:
            total = total + v
        return total

    def max(self, vals):
        """The maximum over all tiles (``pmax``)."""
        allv = self.gather(vals)
        total = allv[0]
        for v in allv[1:]:
            total = torch.maximum(total, v)
        return total


@dataclasses.dataclass(frozen=True)
class ShardedWorld:
    """A 1-D decomposition: the local tiles' grids (each ``nxl`` interior
    columns plus ``halo`` on either side) on the world's device, the same
    grids on the CPU for the init boundary, and tile 0's corner origin
    (the owner formula of :func:`shard_state`)."""
    ring: Ring
    grids: list
    cfg: IcebergsConfig
    nxl: int
    halo: int
    grids_host: list
    origin: tuple

    @property
    def device(self):
        return self.grids[0].device


@dataclasses.dataclass(frozen=True)
class ShardedWorld2D:
    """A 2-D decomposition: tiles of ``nxl`` x ``nyl`` interior cells with
    a ``halo`` ring.  ``folded_north``: the top edge is a tripolar fold
    (FOLD_NORTH_EDGE, icebergs_framework.F90:649, 933), across which
    positions map through lon -> ``fold_lon_sum`` - lon, lat ->
    ``fold_lat_sum`` - lat."""
    ring: Ring
    grids: list
    cfg: IcebergsConfig
    nxl: int
    nyl: int
    halo: int
    grids_host: list
    origin: tuple
    folded_north: bool = False
    fold_lon_sum: float = 0.0
    fold_lat_sum: float = 0.0

    @property
    def device(self):
        return self.grids[0].device


def _f32(x) -> float:
    return float(np.float32(x))


def _slice_tile_grid(gg: Grid, sx: int, sy: int, nxt: int, nyt: int, *,
                     periodic: bool, folded_north: bool = False,
                     own_hx: int = 0, own_hy: int = 0,
                     dtype=torch.float32) -> Grid:
    """The tile grid covering global cells [sx, sx+nxt) x [sy, sy+nyt) of
    the CPU grid ``gg``, on the CPU.  Interior values are slices of the
    global arrays bit for bit; halo cells beyond the domain are land (or
    the periodic image in x, or above a folded north edge the fold image
    of the cell fields but ``lat_center``); corner coordinates extend
    linearly.  The
    grid keeps the global origin (``lon0g``, ``lat0g``): the walk measures
    a berg's place in its cell from it, so the tile rounds it as the
    untiled grid does (the JAX package's tiles measure from their own
    corner and differ in its last bit)."""
    nx, ny = gg.nx, gg.ny
    gx = gg.lonc[:, 0].double().numpy()
    gy = gg.latc[0, :].double().numpy()
    dlon, dlat = float(gg.dlon), float(gg.dlat)
    ix = np.arange(sx, sx + nxt + 1)
    iy = np.arange(sy, sy + nyt + 1)
    cx = np.clip(ix, 0, nx)
    cy = np.clip(iy, 0, ny)
    xc = gx[cx] + (ix - cx) * dlon
    yc = gy[cy] + (iy - cy) * dlat
    lonc, latc = np.meshgrid(xc, yc, indexing="ij")
    pcx = np.arange(sx, sx + nxt + 2)         # global padded-center indices
    pcy = np.arange(sy, sy + nyt + 2)
    if periodic:
        gcx = np.where((pcx >= 1) & (pcx <= nx), pcx, (pcx - 1) % nx + 1)
    else:
        gcx = np.clip(pcx, 0, nx + 1)
    gcy = np.clip(pcy, 0, ny + 1)

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(dtype)

    def centers(a, fold=True):
        a = a.numpy()
        out = a[np.ix_(gcx, gcy)].copy()
        if folded_north and fold:
            # padded center p images (nx + 1 - p, 2 ny + 1 - p')
            for k in np.nonzero(pcy >= ny + 1)[0]:
                pyf = 2 * ny + 1 - pcy[k]
                if 1 <= pyf <= ny:
                    out[:, k] = a[np.clip(nx + 1 - gcx, 0, nx + 1), pyf]
        return t(out)

    return Grid(
        nx=nxt, ny=nyt, lonc=t(lonc), latc=t(latc),
        cosc=torch.ones(nxt + 1, nyt + 1, dtype=dtype),
        sinc=torch.zeros(nxt + 1, nyt + 1, dtype=dtype),
        msk=centers(gg.msk), area=centers(gg.area), dx=centers(gg.dx),
        dy=centers(gg.dy), ocean_depth=centers(gg.ocean_depth),
        lat_center=centers(gg.lat_center, False), lon0=t(xc[0]),
        lat0=t(yc[0]),
        dlon=gg.dlon.clone(), dlat=gg.dlat.clone(), i_off=int(sx),
        j_off=int(sy), nxg=nx, nyg=ny, own_halo_x=own_hx, own_halo_y=own_hy,
        lon0g=gg.lon0.clone(), lat0g=gg.lat0.clone())


def _device(device):
    return torch.device("cuda" if device is None else device)


def make_sharded_world(cfg: IcebergsConfig, ring: Ring, *, nx, ny, lon0,
                       lat0, dlon, dlat, msk=None, ocean_depth=None,
                       maskmap=None, dtype=torch.float32,
                       device=None) -> ShardedWorld:
    """Split a uniform global grid into tiles of ``nx / ntiles`` columns
    plus ``max(cfg.halo, 2)`` halo columns each side.

    ``maskmap`` (mpp_define_domains' argument, icebergs_framework.F90:
    915-917): a boolean per layout column; False columns are all-land
    tiles that get no tile of the ring, which then has ``sum(maskmap)``
    tiles that keep their global offsets.  Runs on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    if len(ring.layout) != 1:
        raise ValueError("make_sharded_world needs a 1-D ring")
    ndev = ring.ntiles
    if msk is None:
        msk = np.ones((nx, ny))
    if maskmap is not None:
        maskmap = np.asarray(maskmap, bool).reshape(-1)
        assert nx % maskmap.size == 0, "nx must divide the maskmap columns"
        nxl = nx // maskmap.size
        cols = np.nonzero(maskmap)[0]
        assert len(cols) == ndev, (f"maskmap keeps {len(cols)} columns but "
                                   f"the ring has {ndev} tiles")
        m = np.asarray(msk)
        for c in np.nonzero(~maskmap)[0]:
            assert not m[c * nxl:(c + 1) * nxl, :].any(), \
                f"maskmap drops column {c} which contains ocean"
    else:
        assert nx % ndev == 0, "nx must divide the tile count"
        nxl = nx // ndev
        cols = np.arange(ndev)
    H = max(cfg.halo, 2)
    if ocean_depth is None:
        ocean_depth = np.zeros((nx, ny))
    periodic = cfg.grid_is_latlon and cfg.Lx > 0.
    gg = make_uniform_grid(nx, ny, lon0, lat0, dlon, dlat,
                           grid_is_latlon=cfg.grid_is_latlon,
                           Rearth=cfg.Rearth, msk=msk,
                           ocean_depth=ocean_depth, dtype=dtype,
                           device="cpu")
    host = [_slice_tile_grid(gg, int(cols[t]) * nxl - H, 0, nxl + 2 * H, ny,
                             periodic=periodic, own_hx=H, dtype=dtype)
            for t in ring.tiles]
    origin = _tile_origin(gg, int(cols[0]) * nxl - H, 0)
    dev = _device(device)
    return ShardedWorld(ring=ring, grids=[g.to(dev) for g in host],
                        cfg=cfg, nxl=nxl, halo=H, grids_host=host,
                        origin=origin)


def _tile_origin(gg: Grid, sx: int, sy: int):
    """(lon0, lat0) of the tile grid whose corner (0, 0) is global corner
    (sx, sy), as the tile grid rounds them."""
    gx = gg.lonc[:, 0].double().numpy()
    gy = gg.latc[0, :].double().numpy()
    cx, cy = min(max(sx, 0), gg.nx), min(max(sy, 0), gg.ny)
    return (_f32(gx[cx] + (sx - cx) * float(gg.dlon)),
            _f32(gy[cy] + (sy - cy) * float(gg.dlat)))


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _forcing_tile(frc_global: Forcing, corner_slice, center_slice,
                  device) -> Forcing:
    kw = {f: corner_slice(_np(getattr(frc_global, f))) for f in _CORNER}
    kw.update({f: center_slice(_np(getattr(frc_global, f)))
               for f in _CENTER})
    return Forcing(**{f: torch.as_tensor(np.ascontiguousarray(v)).to(device)
                      for f, v in kw.items()})


def shard_forcing(world: ShardedWorld, frc_global: Forcing):
    """The local tiles' slices (+halo) of a global Forcing."""
    ndev = world.ring.ntiles
    nxl, H = world.nxl, world.halo
    nx = nxl * ndev
    periodic = world.cfg.grid_is_latlon and world.cfg.Lx > 0.
    out = []
    for d in world.ring.tiles:
        def corner_slice(a):
            idx = np.arange(d * nxl - H, (d + 1) * nxl + H + 1)
            return a[idx % nx if periodic else np.clip(idx, 0, nx)]

        def center_slice(a):          # halo-padded global (nx+2, ny+2)
            return a[np.clip(np.arange(d * nxl - H, (d + 1) * nxl + 2 + H),
                             0, nx + 1)]
        out.append(_forcing_tile(frc_global, corner_slice, center_slice,
                                 world.device))
    return out


def _tile_state(world, fields: dict, idx, local_capacity: int, max_bonds,
                dtype, grid, bond_idx):
    """One tile's state: rows ``idx`` of the global ``fields`` in the
    first slots, the rest dead, re-localised on ``grid``."""
    n = len(idx)
    if n > local_capacity:
        raise ValueError(f"{n} bergs > local capacity {local_capacity}")
    sl = to_numpy(empty_state(local_capacity, max_bonds=max_bonds,
                              dtype=dtype, device="cpu"))
    for name, src in fields.items():
        sl[name][:n] = src[idx]
    sl["bond_idx"][:n] = bond_idx
    sl["alive"] = np.arange(local_capacity) < n
    st = state_from_numpy(sl, device=world.device)
    return relocalize(st, grid, world.cfg)


def shard_state(world: ShardedWorld, st_global: BergState,
                local_capacity: int):
    """The live bergs of ``st_global`` distributed to their owning tiles
    as slabs of ``local_capacity`` slots (host side, the init boundary:
    the restart-read distribution of icebergs_fms2io.F90:662-1188), cell
    indices re-localised on each tile.  With bonds on, the partners' ids
    are stamped first (:func:`..ops.forces.stamp_bond_ids`): partners on
    another tile are connected again by id at the first exchange.
    Returns the local tiles'."""
    if world.cfg.iceberg_bonds_on:
        st_global = stamp_bond_ids(st_global)
    ndev = world.ring.ntiles
    nxl, H = world.nxl, world.halo
    g0 = world.grids_host[0]
    dlon = float(g0.dlon)
    lon0 = world.origin[0] + H * dlon
    fields = to_numpy(st_global)
    lon, alive = fields["lon"], fields["alive"]
    owner = np.clip(np.floor((lon - lon0) / (dlon * nxl)).astype(int), 0,
                    ndev - 1)
    out = []
    for d, grid in zip(world.ring.tiles, world.grids):
        idx = np.nonzero(alive & (owner == d))[0]
        # bond partners from global slots to local ones
        gl2loc = np.full((st_global.capacity,), -1, np.int32)
        gl2loc[idx] = np.arange(len(idx))
        bidx = fields["bond_idx"][idx]
        bidx = np.where(bidx >= 0, gl2loc[np.clip(bidx, 0, None)], -1)
        out.append(_tile_state(world, fields, idx, local_capacity,
                               st_global.max_bonds, st_global.dtype, grid,
                               bidx))
    return out


def relocalize(st: BergState, grid: Grid, cfg: IcebergsConfig) -> BergState:
    """Recompute local (ine, jne, xi, yj) from global positions."""
    Lx = cfg.Lx if cfg.grid_is_latlon else -1.
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, Lx)
    return st.replace(ine=i, jne=j, xi=xi, yj=yj)


# --------------------------------------------------------------------------
# the particle exchange
# --------------------------------------------------------------------------

def _lanes(st: BergState):
    """The state's bit columns in buffer-row order (int32; int64 for all
    when a field is float64, which only the CPU runs)."""
    lanes = [to_bits(getattr(st, f)) for f in _ONE_D]
    for f in _BOND:
        leaf = getattr(st, f)
        lanes += [to_bits(leaf[:, b]) for b in range(leaf.shape[1])]
    if any(c.dtype == torch.int64 for c in lanes):
        lanes = [c.to(torch.int64) for c in lanes]
    return lanes


def _from_matrix(M, like: BergState) -> BergState:
    """The state whose bit columns are the rows of ``M`` (the inverse of
    :func:`_lanes`; dtypes from ``like``)."""
    kw = {f: from_bits(M[r], getattr(like, f).dtype)
          for r, f in enumerate(_ONE_D)}
    B, N = like.max_bonds, M.shape[1]
    tabs = M[len(_ONE_D):].view(len(_BOND), B, N).transpose(1, 2) \
        .contiguous()
    for k, f in enumerate(_BOND):
        kw[f] = from_bits(tabs[k], getattr(like, f).dtype)
    return BergState(**kw)


def _pack_to(st: BergState, send_mask, width: int):
    """The marked bergs packed into a fixed-width buffer: a (C, width)
    matrix of bit columns, row 0 the slot's validity, empty slots 0.
    Returns ``(buffer, overflow)``, the marked bergs past ``width``."""
    cap, dev = st.capacity, st.device
    rank = torch.cumsum(send_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(send_mask & (rank < width), rank, width)
    # each buffer slot's berg (cap = none); slot `width` is the sink
    src_of = torch.full((width + 1,), cap, dtype=torch.int32, device=dev)
    src_of.index_copy_(0, slot.long(), torch.arange(cap, dtype=torch.int32,
                                                    device=dev))
    buf = permute_cols_u32(_lanes(st), src_of[:width])
    overflow = (send_mask & (rank >= width)).sum(dtype=torch.int32)
    return buf, overflow


def _unpack_from(st: BergState, buf, *, idx_field: Optional[str] = None,
                 shift: int = 0, halo_flag: Optional[float] = None,
                 valid=None):
    """The buffer's valid rows (row 0, or ``valid``) written into free
    slots (``idx_field`` moved by ``shift`` into this tile's frame,
    ``halo_berg`` set to ``halo_flag``, bond slots cleared).  Returns
    ``(state, overflow)``, the valid rows that found no free slot."""
    cap, dev = st.capacity, st.device
    width = buf.shape[1]
    if valid is None:
        valid = buf[0] > 0
    granted, slots = allocate_slots(st.alive, valid)
    # invert the grant: each slot's buffer row (width = none)
    tgt = torch.where(granted, slots, cap).long()
    inv = torch.full((cap + 1,), width, dtype=torch.int32, device=dev)
    inv.index_copy_(0, tgt, torch.arange(width, dtype=torch.int32,
                                         device=dev))
    inv = inv[:cap]
    newly = inv < width
    moved = permute_cols_u32(buf, inv)
    if shift:
        moved[_ROW[idx_field]] += shift
    out = _from_matrix(torch.where(newly, moved, torch.stack(_lanes(st))),
                       st)
    kw = dict(alive=st.alive | newly,
              bond_idx=torch.where(newly[:, None], -1, out.bond_idx))
    if halo_flag is not None:
        kw["halo_berg"] = torch.where(newly, halo_flag, out.halo_berg)
    overflow = (valid & ~granted).sum(dtype=torch.int32)
    return out.replace(**kw), overflow


# (x, y) vector components that turn by 180 degrees across the tripolar
# fold (the reference keeps geographic coordinates, icebergs_framework.F90:
# 2010-2076; the tiles are logical index space, so the fold is the
# isometry lon -> S_lon - lon, lat -> S_lat - lat, (u, v) -> (-u, -v),
# the "180 degree rotation" of icebergs.F90:6112-6124)
_FOLD_VECTOR_PAIRS = (
    ("uvel", "vvel"), ("uvel_old", "vvel_old"), ("uvel_prev", "vvel_prev"),
    ("axn", "ayn"), ("bxn", "byn"),
    ("axn_fast", "ayn_fast"), ("bxn_fast", "byn_fast"),
    ("uo", "vo"), ("ui", "vi"), ("ua", "va"), ("ssh_x", "ssh_y"),
)
_PI32 = float(np.float32(np.pi))


def fold_state(buf: BergState, *, nxl: int, nyl: int, H: int,
               lon_sum: float, lat_sum: float) -> BergState:
    """The tripolar-fold isometry of a berg slab: the 180-degree turn in
    logical space (x mirrored about the grid's midline, y reflected about
    the fold edge).  Positions map through (lon, lat) -> (lon_sum - lon,
    lat_sum - lat), every (x, y) vector pair negates, the tile-local
    cells mirror (``ine`` within the mirrored tile, ``jne`` about the fold
    line), the places in the cell flip and ``rot`` turns by pi (a
    multiple of the hexagon's 60 degrees); the ``start_*`` provenance
    stays, as in the reference (geographic, fold-invariant)."""
    kw = {}
    for ux, vy in _FOLD_VECTOR_PAIRS:
        kw[ux] = -getattr(buf, ux)
        kw[vy] = -getattr(buf, vy)
    kw["lon"] = lon_sum - buf.lon
    kw["lat"] = lat_sum - buf.lat
    kw["lon_old"] = lon_sum - buf.lon_old
    kw["lat_old"] = lat_sum - buf.lat_old
    kw["xi"] = 1.0 - buf.xi
    kw["yj"] = 1.0 - buf.yj
    kw["ine"] = (2 * H + nxl - 1) - buf.ine
    kw["jne"] = 2 * (H + nyl) - 1 - buf.jne
    kw["rot"] = buf.rot + _PI32
    return buf.replace(**kw)


def _exchange_axis(ring: Ring, tiles, axis, idx_field: str, nl: int, H: int,
                   width: int, *, migrate: bool = True,
                   fold_top: bool = False):
    """Migration then halo replication along one axis of the ring: one
    direction pass of ``send_bergs_to_other_pes`` +
    ``update_halo_icebergs`` (running x then y moves diagonal travellers
    and corner halos in two hops, icebergs_framework.F90:1840-2135);
    ``migrate=False`` replicates only.  ``fold_top`` (the y pass of a
    folded world): nothing crosses the top edge, which the fold pass
    serves, nor the closed bottom edge.  Returns ``(tiles, counters)``,
    each tile's [ov1, ov2] of every pass."""
    def idx(s):
        return getattr(s, idx_field)

    counters = [[] for _ in tiles]
    n = ring.layout[_AXIS_DIM[axis]]
    pos = [ring.coords(t)[_AXIS_DIM[axis]] for t in ring.tiles]
    not_top = [not fold_top or p != n - 1 for p in pos]
    not_bot = [not fold_top or p != 0 for p in pos]

    def passes(tiles, masks, halo_flag, migrate):
        for mask, step, shift in zip(masks, (1, -1), (-nl, nl)):
            packed = [_pack_to(s, m, width) for s, m in zip(tiles, mask)]
            if migrate:
                tiles = [s.replace(alive=s.alive & ~m)
                         for s, m in zip(tiles, mask)]
            recv = ring.shift([b for b, _ in packed], axis, step)
            new = []
            for k, (s, b) in enumerate(zip(tiles, recv)):
                s, ov2 = _unpack_from(s, b, idx_field=idx_field, shift=shift,
                                      halo_flag=halo_flag)
                counters[k] += [packed[k][1], ov2]
                new.append(s)
            tiles = new
        return tiles

    if migrate:
        # interior cells are [H, H+nl); only owned bergs migrate
        owned = [s.alive & (s.halo_berg < 0.5) for s in tiles]
        go_hi = [o & (idx(s) >= H + nl) & t
                 for o, s, t in zip(owned, tiles, not_top)]
        go_lo = [o & (idx(s) < H) & b
                 for o, s, b in zip(owned, tiles, not_bot)]
        tiles = passes(tiles, (go_hi, go_lo), None, True)
    # edge strips, owned and already received copies alike, so that
    # corners propagate on the second axis's pass
    edge_hi = [s.alive & (idx(s) >= nl) & t for s, t in zip(tiles, not_top)]
    edge_lo = [s.alive & (idx(s) < 2 * H) & b
               for s, b in zip(tiles, not_bot)]
    tiles = passes(tiles, (edge_hi, edge_lo), 1.0, False)
    return tiles, counters


def _fold_matrix(M, like: BergState, **kw):
    """:func:`fold_state` of a packed buffer."""
    return torch.stack(_lanes(fold_state(_from_matrix(M, like), **kw)))


def _exchange_fold_north(ring: Ring, tiles, nxl: int, nyl: int, H: int,
                         width: int, *, lon_sum: float, lat_sum: float,
                         migrate: bool = True):
    """Migration and halo replication across the folded north edge (the
    reference's ``folded_north_on_pe`` branches, icebergs_framework.F90:
    933, 2010-2076, 2908-2961, 3138-3191): the north neighbour of top-row
    tile dx is the x-mirrored top-row tile ndx - 1 - dx, so one
    :meth:`Ring.permute` by the mirror carries each pass, folded by
    :func:`fold_state` on arrival; one column of tiles folds onto itself.
    Returns ``(tiles, counters)``."""
    ndx, ndy = ring.layout
    fkw = dict(nxl=nxl, nyl=nyl, H=H, lon_sum=lon_sum, lat_sum=lat_sum)
    top = [ring.coords(t)[1] == ndy - 1 for t in ring.tiles]
    counters = [[] for _ in tiles]

    def mirror(t):
        dx, dy = ring.coords(t)
        return (ndx - 1 - dx) * ndy + dy

    def send(tiles, masks, halo_flag, migrate):
        packed = [_pack_to(s, m & tp, width)
                  for s, m, tp in zip(tiles, masks, top)]
        if migrate:
            tiles = [s.replace(alive=s.alive & ~(m & tp))
                     for s, m, tp in zip(tiles, masks, top)]
        recv = ring.permute([b for b, _ in packed], mirror)
        out = []
        for k, (s, b, tp) in enumerate(zip(tiles, recv, top)):
            if not tp:
                b = torch.zeros_like(b)
            s, ov2 = _unpack_from(s, _fold_matrix(b, s, **fkw),
                                  halo_flag=halo_flag)
            counters[k] += [packed[k][1], ov2]
            out.append(s)
        return out

    if migrate:
        # owned bergs beyond the fold line re-enter mirrored, heading
        # south (send_bergs_to_other_pes' fold branch)
        tiles = send(tiles, [s.alive & (s.halo_berg < 0.5)
                             & (s.jne >= H + nyl) for s in tiles], None,
                     True)
    # the strip within H of the fold, x-halo copies included, so that
    # the fold's corners arrive in this one pass
    tiles = send(tiles, [s.alive & (s.jne >= nyl) & (s.jne < H + nyl)
                         for s in tiles], 1.0, False)
    return tiles, counters


def exchange_particles(ring: Ring, tiles, cfg: IcebergsConfig, nxl: int,
                       H: int, width: int, *, nyl: Optional[int] = None,
                       y_axis: Optional[str] = None, fold_north=None,
                       migrate: bool = True, grids=None,
                       conglom_id_cap: int = 64):
    """Ownership migration and halo replication of the local ``tiles``:
    the stale halo copies dropped, then the x pass and, with ``y_axis``
    (2-D, ``nyl`` interior rows), the y pass; ``fold_north=(lon_sum,
    lat_sum)`` (2-D) adds the pass across the tripolar fold
    (:func:`_exchange_fold_north`); ``migrate=False`` refreshes the halo
    copies only (the tiled run's mid-step refresh).  With bonds on, the
    partners' ids are stamped first, whole conglomerates are then
    replicated to every tile they overlap (:func:`replicate_bonded_bergs`,
    transfer_mts_bergs' invariant, icebergs_framework.F90:2298-2313), the
    partner slots connected again by id, the bonds counted, and the halo
    copies re-localised on their tile's grid (``grids``, the local
    tiles'; a far member clamps to the nearest halo cell with its
    coordinates kept, as evolve_icebergs_mts does, icebergs.F90:
    6608-6611).  Returns ``(tiles, overflow)``, ``overflow`` (tiles,
    passes, 2) int32."""
    if cfg.iceberg_bonds_on:
        if grids is None:
            raise ValueError("a bonded exchange needs the tiles' grids")
        tiles = [stamp_bond_ids(s) for s in tiles]
    tiles = [s.replace(alive=s.alive & (s.halo_berg < 0.5)) for s in tiles]
    tiles, counters = _exchange_axis(ring, tiles, AXIS, "ine", nxl, H, width,
                                     migrate=migrate)
    if y_axis is not None:
        tiles, cy = _exchange_axis(ring, tiles, y_axis, "jne", nyl, H, width,
                                   migrate=migrate,
                                   fold_top=fold_north is not None)
        counters = [a + b for a, b in zip(counters, cy)]
    if fold_north is not None:
        if y_axis is None:
            raise ValueError("fold_north needs the 2-D world (an (ndx, 1) "
                             "layout for one row of tiles with a fold)")
        tiles, cf = _exchange_fold_north(
            ring, tiles, nxl, nyl, H, width, lon_sum=fold_north[0],
            lat_sum=fold_north[1], migrate=migrate)
        counters = [a + b for a, b in zip(counters, cf)]
    if cfg.iceberg_bonds_on:
        tiles, cb = replicate_bonded_bergs(
            ring, tiles, width, nxl, H, nyl=nyl, y_axis=y_axis, grids=grids,
            conglom_id_cap=conglom_id_cap, fold_north=fold_north)
        counters = [a + b for a, b in zip(counters, cb)]
        Lx = cfg.Lx if cfg.grid_is_latlon else -1.
        out = []
        for s, g in zip(tiles, grids):
            s = count_bonds(connect_bonds_by_id(s))
            i2, j2, xi2, yj2 = pos_to_cell(g, s.lon, s.lat, Lx)
            halo = s.alive & (s.halo_berg >= 0.5)
            out.append(s.replace(ine=torch.where(halo, i2, s.ine),
                                 jne=torch.where(halo, j2, s.jne),
                                 xi=torch.where(halo, xi2, s.xi),
                                 yj=torch.where(halo, yj2, s.yj)))
        tiles = out
    overflow = torch.stack([torch.stack(c).view(-1, 2) for c in counters])
    return tiles, overflow


def _is_member(x, ids):
    """``x`` in ``ids``, element by element, by a binary search of the
    sorted ids (``torch.isin`` reads sizes back from the card)."""
    srt = torch.sort(ids).values
    pos = torch.searchsorted(srt, x).clamp(max=srt.shape[0] - 1)
    return srt[pos] == x


def _has_stamp(st):
    return ((st.bond_id_cnt != 0) | (st.bond_id_ij != 0)).any(dim=1)


def _wanted_conglom_ids(st, cap: int):
    """The distinct conglomerate ids with a member on this tile (owned
    or strip-halo copy), ascending, 0-padded to ``cap``; returns ``(ids,
    n_dropped)``."""
    present = st.alive & (st.conglom_id > 0) & _has_stamp(st)
    s = torch.sort(torch.where(present, st.conglom_id, 0)).values
    first = (s > 0) & (s != torch.cat([s.new_zeros(1), s[:-1]]))
    rank = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    out = torch.zeros(cap + 1, dtype=s.dtype, device=s.device)
    out.index_copy_(0, torch.where(first & (rank < cap), rank, cap).long(),
                    s)
    return out[:cap], (first & (rank >= cap)).sum(dtype=torch.int32)


# the fields the fold image of a replicated member takes: positions
# reflected, these vectors turned
_FOLD_REPLICA_VECTORS = ("uvel", "vvel", "uvel_old", "vvel_old", "uvel_prev",
                         "vvel_prev", "axn", "ayn", "bxn", "byn")


def _gather_order(ring: Ring):
    """The tiles in the order of the JAX package's all-gathers: x then
    y, so (y, x)-major."""
    if len(ring.layout) == 1:
        return list(range(ring.ntiles))
    ndx, ndy = ring.layout
    return [x * ndy + y for y in range(ndy) for x in range(ndx)]


def replicate_bonded_bergs(ring: Ring, tiles, width: int, nxl: int, H: int,
                           *, nyl: Optional[int] = None,
                           y_axis: Optional[str] = None, grids=None,
                           conglom_id_cap: int = 64, fold_north=None):
    """Replicate conglomerate members to the tiles that overlap them:
    transfer_mts_bergs' invariant, "each PE holds a complete copy of any
    conglomerate it overlaps" (icebergs_framework.F90:2136-2313).  Each
    tile publishes the ids of the conglomerates with a member on its
    extended tile (:func:`_wanted_conglom_ids`, gathered by
    :meth:`Ring.gather`); it ships its owned bonded members that another
    tile wants (and unlabeled ones), and keeps of every other tile's
    rows those of the conglomerates it wants; the strip-halo copies of
    bonded bergs go first, and the copies land with ``halo_berg`` 1.
    The packs and unpacks are K1's (:func:`_pack_to`,
    :func:`_unpack_from`); the id sets are matched by sorted membership
    (:func:`_is_member`).
    ``fold_north=(lon_sum, lat_sum)`` with the tiles' ``grids``: a
    received member whose fold image lies nearer this tile's centre (in
    both coordinates) arrives as that image (icebergs_framework.F90:
    2908-2961), so that bonds across the fold measure their length in
    the tile's frame.  Returns ``(tiles, counters)``, each tile's
    ``[ov1, ov2, ov_ids, 0]``."""
    wanted, ov_ids, bonded, kept = [], [], [], []
    for s in tiles:
        has = _has_stamp(s)
        bonded.append(s.alive & (s.halo_berg < 0.5) & has)
        # the wanted sets before the strip copies go: they witness the
        # overlap
        w, ov = _wanted_conglom_ids(s, conglom_id_cap)
        wanted.append(w)
        ov_ids.append(ov)
        kept.append(s.replace(alive=s.alive & ~(s.alive
                                                & (s.halo_berg >= 0.5)
                                                & has)))
    order = _gather_order(ring)
    all_w = ring.gather(wanted)
    packed = []
    for s, t, b in zip(kept, ring.tiles, bonded):
        others = torch.cat([all_w[u] for u in order if u != t]
                           or [all_w[t][:1] * 0])
        ship = b & ((s.conglom_id <= 0) | _is_member(s.conglom_id, others))
        packed.append(_pack_to(s, ship, width))
    all_b = ring.gather([p for p, _ in packed])
    big = torch.cat([all_b[u] for u in order], dim=1)
    cid = from_bits(big[_ROW["conglom_id"]], torch.int32)
    src = torch.arange(big.shape[1], device=big.device) // width
    out, counters = [], []
    for k, (s, t) in enumerate(zip(kept, ring.tiles)):
        valid = (big[0] > 0) & (src != order.index(t)) & (
            (cid <= 0) | _is_member(cid, wanted[k]))
        buf = big
        if fold_north is not None and grids is not None:
            buf = _fold_replicas(big, s, grids[k], *fold_north)
        s, ov2 = _unpack_from(s, buf, valid=valid, halo_flag=1.0)
        out.append(s)
        counters.append([packed[k][1], ov2, ov_ids[k],
                         torch.zeros_like(ov2)])
    return out, counters


def _fold_replicas(M, like: BergState, grid: Grid, lon_sum: float,
                   lat_sum: float):
    """The gathered rows with each member that lies nearer this tile's
    centre as its fold image turned into that image."""
    dt = like.lon.dtype

    def col(f):
        return from_bits(M[_ROW[f]], dt)
    lon, lat = col("lon"), col("lat")
    cx = grid.lon0 + 0.5 * grid.dlon * grid.nx
    cy = grid.lat0 + 0.5 * grid.dlat * grid.ny
    lat_f = lat_sum - lat
    d2_n = (lon - cx) ** 2 + (lat - cy) ** 2
    d2_f = (lon_sum - lon - cx) ** 2 + (lat_f - cy) ** 2
    use_f = d2_f < d2_n
    M = M.clone()
    new = dict(lon=lon_sum - lon, lat=lat_f,
               lon_old=lon_sum - col("lon_old"),
               lat_old=lat_sum - col("lat_old"))
    new.update({f: -col(f) for f in _FOLD_REPLICA_VECTORS})
    for f, v in new.items():
        M[_ROW[f]] = to_bits(torch.where(use_f, v, col(f))).to(M.dtype)
    return M


def concat_tiles(tiles) -> BergState:
    """The tiles' slabs end to end as one state (bond slots stay
    tile-local): the merged state a checksum or a listing reads."""
    return BergState(**{f: torch.cat([getattr(t, f) for t in tiles])
                        for f in ALL_FIELDS})


# --------------------------------------------------------------------------
# 2-D decomposition (x, y)
# --------------------------------------------------------------------------

def make_sharded_world_2d(cfg: IcebergsConfig, ring: Ring, *, nx, ny, lon0,
                          lat0, dlon, dlat, msk=None, ocean_depth=None,
                          folded_north=False, dtype=torch.float32,
                          device=None) -> ShardedWorld2D:
    """The (ndx, ndy) tile decomposition of mpp_define_domains' layout
    (icebergs_framework.F90:915-925).  ``folded_north=True`` makes the top
    edge a tripolar fold: global cell (i, ny + k) is the image of
    (nx - 1 - i, ny - 1 - k), so the top row of tiles carries the folded
    cells in its north halo and the exchange runs the fold pass
    (icebergs_framework.F90:933, FOLD_NORTH_EDGE)."""
    if len(ring.layout) != 2:
        raise ValueError("make_sharded_world_2d needs a 2-D ring")
    ndx, ndy = ring.layout
    assert nx % ndx == 0 and ny % ndy == 0
    nxl, nyl = nx // ndx, ny // ndy
    H = max(cfg.halo, 2)
    if msk is None:
        msk = np.ones((nx, ny))
    if ocean_depth is None:
        ocean_depth = np.zeros((nx, ny))
    periodic = cfg.grid_is_latlon and cfg.Lx > 0.
    gg = make_uniform_grid(nx, ny, lon0, lat0, dlon, dlat,
                           grid_is_latlon=cfg.grid_is_latlon,
                           Rearth=cfg.Rearth, msk=msk,
                           ocean_depth=ocean_depth, dtype=dtype,
                           device="cpu")
    host = []
    for t in ring.tiles:
        dx, dy = ring.coords(t)
        host.append(_slice_tile_grid(
            gg, dx * nxl - H, dy * nyl - H, nxl + 2 * H, nyl + 2 * H,
            periodic=periodic, folded_north=folded_north, own_hx=H,
            own_hy=H, dtype=dtype))
    dev = _device(device)
    return ShardedWorld2D(ring=ring, grids=[g.to(dev) for g in host],
                          cfg=cfg, nxl=nxl, nyl=nyl, halo=H,
                          grids_host=host, origin=_tile_origin(gg, -H, -H),
                          folded_north=bool(folded_north),
                          fold_lon_sum=2. * lon0 + nx * dlon,
                          fold_lat_sum=2. * (lat0 + ny * dlat))


def shard_state_2d(world: ShardedWorld2D, st_global: BergState,
                   local_capacity: int):
    """The live bergs distributed to their owning 2-D tiles (host side);
    bond slots are cleared, as the JAX package clears them, after the
    partners' ids are stamped with bonds on (the first exchange connects
    them again)."""
    if world.cfg.iceberg_bonds_on:
        st_global = stamp_bond_ids(st_global)
    ndx, ndy = world.ring.layout
    nxl, nyl, H = world.nxl, world.nyl, world.halo
    g0 = world.grids_host[0]
    dlon, dlat = float(g0.dlon), float(g0.dlat)
    lon0 = world.origin[0] + H * dlon
    lat0 = world.origin[1] + H * dlat
    fields = to_numpy(st_global)
    ox = np.clip(np.floor((fields["lon"] - lon0) / (dlon * nxl)).astype(int),
                 0, ndx - 1)
    oy = np.clip(np.floor((fields["lat"] - lat0) / (dlat * nyl)).astype(int),
                 0, ndy - 1)
    out = []
    for t, grid in zip(world.ring.tiles, world.grids):
        dx, dy = world.ring.coords(t)
        idx = np.nonzero(fields["alive"] & (ox == dx) & (oy == dy))[0]
        out.append(_tile_state(
            world, fields, idx, local_capacity, st_global.max_bonds,
            st_global.dtype, grid,
            np.full((len(idx), st_global.max_bonds), -1, np.int32)))
    return out


def shard_forcing_2d(world: ShardedWorld2D, frc_global: Forcing):
    """The local (dx, dy) tiles' slices (+halo) of a global Forcing.  On
    a folded world the top halo rows carry the fold image of the
    forcing, the velocity fields (every corner field) negated: the
    180-degree turn of sum_up_spread_fields' parity handling
    (icebergs.F90:6112-6124), applied to vectors."""
    ndx, ndy = world.ring.layout
    nxl, nyl, H = world.nxl, world.nyl, world.halo
    nx, ny = nxl * ndx, nyl * ndy
    folded = world.folded_north
    out = []
    for t in world.ring.tiles:
        dx, dy = world.ring.coords(t)

        def corner_slice(a):
            ix = np.arange(dx * nxl - H, (dx + 1) * nxl + H + 1)
            iy = np.arange(dy * nyl - H, (dy + 1) * nyl + H + 1)
            ixc = np.clip(ix, 0, nx)
            out = a[np.ix_(ixc, np.clip(iy, 0, ny))].copy()
            if folded:
                # corner (i, ny + k) is the image of (nx - i, ny - k)
                for k in np.nonzero(iy > ny)[0]:
                    iyf = 2 * ny - iy[k]
                    if 0 <= iyf <= ny:
                        out[:, k] = -a[nx - ixc, iyf]
            return out

        def center_slice(a):          # halo-padded global (nx+2, ny+2)
            px = np.clip(np.arange(dx * nxl - H, (dx + 1) * nxl + 2 + H), 0,
                         nx + 1)
            py = np.arange(dy * nyl - H, (dy + 1) * nyl + 2 + H)
            out = a[np.ix_(px, np.clip(py, 0, ny + 1))].copy()
            if folded:
                # padded center p = c + 1: cell (i, ny + k) images
                # (nx - 1 - i, ny - 1 - k)
                for k in np.nonzero(py >= ny + 1)[0]:
                    pyf = 2 * ny + 1 - py[k]
                    if 1 <= pyf <= ny:
                        out[:, k] = a[np.clip(nx + 1 - px, 0, nx + 1), pyf]
            return out
        out.append(_forcing_tile(frc_global, corner_slice, center_slice,
                                 world.device))
    return out


# --------------------------------------------------------------------------
# the tiled step, halo fills and run
# --------------------------------------------------------------------------

def _exchange_kw(world) -> dict:
    if isinstance(world, ShardedWorld2D):
        fold = ((world.fold_lon_sum, world.fold_lat_sum)
                if world.folded_north else None)
        return dict(nyl=world.nyl, y_axis=AXIS_Y, fold_north=fold)
    return {}


def _owned_sums(ring: Ring, tiles):
    owned = [s.alive & (s.halo_berg < 0.5) for s in tiles]
    nbergs = ring.sum([o.sum(dtype=torch.int32) for o in owned])
    mass = ring.sum([torch.where(o, s.mass * s.mass_scaling, 0.).sum()
                     for o, s in zip(owned, tiles)])
    return nbergs, mass


def _exchanger(world, width: int, conglom_id_cap: int = 64):
    """``exchange(tiles, migrate=True) -> (tiles, overflow)`` on the
    world's ring and layout."""
    def exchange(tiles, migrate=True):
        return exchange_particles(world.ring, tiles, world.cfg, world.nxl,
                                  world.halo, width, migrate=migrate,
                                  grids=world.grids,
                                  conglom_id_cap=conglom_id_cap,
                                  **_exchange_kw(world))
    return exchange


def _lockstep(seqs, refresh, on_event=None):
    """Drive the tiles' step generators together; where they yield a
    state (newborns whose neighbours are read next) ``refresh`` the halo
    copies; an :class:`..mts.MtsEvent` goes to ``on_event`` with every
    tile's.  Returns ``(the tiles' results, the refreshes' counters)``."""
    counters, sent = [], [None] * len(seqs)
    while True:
        got = []
        for q, s in zip(seqs, sent):
            try:
                got.append(q.send(s))
            except StopIteration as done:
                got.append(done.value)
        if isinstance(got[0], tuple):
            return got, counters
        if isinstance(got[0], MtsEvent):
            sent = on_event(got)
            continue
        sent, ov = refresh(got)
        counters.append(ov)


def make_sharded_step(world, *, with_thermo=True, exchange_width: int = 64,
                      **step_kw):
    """The tiled coupling step: each local tile's single-device step
    (:func:`..model.make_step` with ``step_kw``, built once per tile),
    then the particle exchange; with footloose and contacts on, the halo
    copies are also refreshed after the children are born (the step's
    ``sequence`` yields there).  Returns ``step(tiles, forcings) ->
    (tiles, nbergs, total_mass, overflow)``: the owned bergs' count and
    mass summed over all tiles, ``overflow`` the counters per local tile
    (a refresh's passes, then the exchange's); ``step.diags`` holds the
    tiles' last ``StepDiags``.  Accepts a 1-D or a 2-D world
    (``make_sharded_step_2d``)."""
    cfg, ring = world.cfg, world.ring
    steps = [make_step(g, cfg, with_thermo=with_thermo, **step_kw)
             for g in world.grids]
    exchange = _exchanger(world, exchange_width)

    def step(tiles, forcings):
        out, counters = _lockstep(
            [f.sequence(s, fr) for f, s, fr in zip(steps, tiles, forcings)],
            lambda ts: exchange(ts, migrate=False))
        step.diags = [d for _, d in out]
        tiles, overflow = exchange([s for s, _ in out])
        nbergs, total_mass = _owned_sums(ring, tiles)
        return tiles, nbergs, total_mass, torch.cat(counters + [overflow],
                                                    dim=1)

    step.diags = []
    return step


def make_sharded_step_2d(world: ShardedWorld2D, *, with_thermo=True,
                         exchange_width: int = 64, **step_kw):
    """The 2-D tiled coupling step (x pass then y pass exchanges)."""
    return make_sharded_step(world, with_thermo=with_thermo,
                             exchange_width=exchange_width, **step_kw)


def make_halo_fill(world, exchange_width: int = 64,
                   conglom_id_cap: int = 64):
    """One particle exchange with no physics: ``fill(tiles) -> (tiles,
    overflow)``.  :func:`shard_state` places only owned bergs and the
    step runs its physics before its exchange, so without this the first
    step's contacts miss the partners across a tile edge (the reference
    fills halos at init, icebergs_framework.F90:1847-1905).  With bonds
    on it also replicates the conglomerates and connects their bonds
    (``conglom_id_cap``: :func:`replicate_bonded_bergs`)."""
    return _exchanger(world, exchange_width, conglom_id_cap)


def make_halo_fill_2d(world: ShardedWorld2D, exchange_width: int = 64,
                      conglom_id_cap: int = 64):
    """The 2-D twin of :func:`make_halo_fill` (x pass then y pass)."""
    return make_halo_fill(world, exchange_width, conglom_id_cap)


def make_forcing_halo_update(world: ShardedWorld):
    """The halo refresh of time-varying forcing tiles (the reference's
    ``mpp_update_domains`` on each forcing field, icebergs.F90:5240-5351):
    ``update(forcings) -> forcings`` fills each tile's halo columns from
    its neighbours' interiors (one shift each way carries every field's
    strips); the outer halos of the edge tiles keep their values unless
    the world is periodic."""
    ring = world.ring
    nxl, H = world.nxl, world.halo
    ndev = ring.layout[0]
    periodic = world.cfg.grid_is_latlon and world.cfg.Lx > 0.
    names = _CORNER + _CENTER

    def geom(name):
        # the strip width, the west strip's start and the east halo's start
        if name in _CORNER:
            return H, H + 1, H + nxl + 1
        return H + 1, H + 1, H + nxl + 1

    def strips(f, east: bool):
        parts = []
        for name in names:
            w, i0, _ = geom(name)
            a = getattr(f, name)
            parts.append((a[nxl:nxl + w] if east else a[i0:i0 + w])
                         .reshape(-1))
        return torch.cat(parts)

    def update(forcings):
        from_west = ring.shift([strips(f, True) for f in forcings], AXIS, 1)
        from_east = ring.shift([strips(f, False) for f in forcings], AXIS,
                               -1)
        out = []
        for t, f, fw, fe in zip(ring.tiles, forcings, from_west, from_east):
            kw, off = {}, 0
            for name in names:
                w, _, e0 = geom(name)
                a = getattr(f, name).clone()
                n = w * a.shape[1]
                if t > 0 or periodic:
                    a[:w] = fw[off:off + n].view(w, -1)
                if t < ndev - 1 or periodic:
                    a[e0:e0 + w] = fe[off:off + n].view(w, -1)
                kw[name] = a
                off += n
            out.append(Forcing(**kw))
        return out
    return update


def shard_calving_field(world, field):
    """A global (nx+2, ny+2[, ...]) calving or heat-flux field as the
    local tiles' slices with the ring they do not own zeroed, so that
    each global cell's bucket fills on exactly one tile (the reference
    accumulates on the compute domain only, icebergs.F90:5389-5402).
    Accepts 1-D and 2-D worlds."""
    a = _np(field)
    nxl, H = world.nxl, world.halo
    out = []
    for t in world.ring.tiles:
        if isinstance(world, ShardedWorld2D):
            ndx, ndy = world.ring.layout
            nyl = world.nyl
            dx, dy = world.ring.coords(t)
            ix = np.clip(np.arange(dx * nxl - H, (dx + 1) * nxl + 2 + H), 0,
                         nxl * ndx + 1)
            iy = np.clip(np.arange(dy * nyl - H, (dy + 1) * nyl + 2 + H), 0,
                         nyl * ndy + 1)
            s = a[np.ix_(ix, iy)].copy()
            s[:, :1 + H] = 0.0
            s[:, 1 + H + nyl:] = 0.0
        else:
            ix = np.clip(np.arange(t * nxl - H, (t + 1) * nxl + 2 + H), 0,
                         nxl * world.ring.ntiles + 1)
            s = a[ix].copy()
        s[:1 + H] = 0.0
        s[1 + H + nxl:] = 0.0
        out.append(torch.as_tensor(s).to(world.device))
    return out


def init_sharded_model_state(world, tiles, *, seed: int = 0, year: int = 0,
                             yearday: float = 0.):
    """The local tiles' ModelStates: empty calving buckets on each tile
    grid and the same seed on every tile (the footloose draws are
    id-derived, so spawning is the same on any layout)."""
    out = []
    for st, g in zip(tiles, world.grids):
        dev = st.device
        out.append(ModelState(
            bergs=st, calving=init_calving_state(g, st.dtype),
            seed=int(seed), step=0,
            current_year=torch.full((), year, dtype=torch.int32, device=dev),
            current_yearday=torch.full((), yearday, dtype=st.dtype,
                                       device=dev),
            spread_mass_old=torch.zeros(g.nx + 2, g.ny + 2, dtype=st.dtype,
                                        device=dev)))
    return out


# interval-budget scalars: the tiles' values summed
_SUM_SCALARS = (
    "spawn_overflow", "fl_spawn_overflow", "tickets", "nbergs_calved",
    "nbergs_calved_fl", "nbergs_melted", "nbergs_deleted_fl",
    "net_calving_used", "heat_used", "calving_to_bergs", "heat_to_bergs",
    "net_melt_heat", "net_melt_kg", "berg_melt_kg", "bergy_src_kg",
    "bergy_melt_kg", "fl_bits_melt_kg", "flb_bergy_melt_kg",
    "flb_internal_eros_kg", "fl_to_berg_kg", "flb_to_bergy_kg")
_GRIDDED = ("calving", "calving_hflx", "floating_melt", "berg_melt",
            "spread_mass", "spread_area", "spread_uvel", "spread_vvel",
            "ustar_iceberg", "mass_on_ocean", "fl_bits_src")


def make_sharded_run(world, *, neighbor_mode: str = "buckets",
                     max_per_cell: int = 16, exchange_width: int = 64,
                     fused_kw: Optional[dict] = None):
    """The tiled full coupling step: the whole icebergs_run sequence
    (calving spawn, footloose, thermodynamics, spreading,
    icebergs.F90:5389-5679) on each local tile through
    :func:`..api.run_coupling_sequence`, then the particle exchange.
    Spawning relies on the tile grids' global offsets (ids) and owned
    ring (no spawn in the halo).  With contacts on, the halo copies are
    also refreshed where the sequence yields (after the bucket spawn,
    after the footloose children: :func:`..api.coupling_sequence`), so
    that newborns near a tile edge meet their neighbours as they do
    untiled; the JAX package exchanges once, after the sequence.
    Returns ``run(states, forcings, calvings, calving_hflxs) -> (states,
    outputs, nbergs, overflow)``: ``outputs`` a RunOutputs whose gridded
    fields are stacked per local tile, whose budgets and interval scalars
    are summed over all tiles (the melt scalars count the halo copies'
    melt too, as the JAX package's do) and whose contact counters take
    their maximum; ``overflow`` the refreshes' passes, then the
    exchange's.  Accepts 1-D and 2-D worlds.  A call is the span
    ``kid.run`` (:mod:`..trace`), each exchange the span ``kid.exchange``;
    the tiles' phase spans alternate inside it, none open across a
    yield."""
    cfg, ring = world.cfg, world.ring
    per_tile = [dict(nbr_radius=neighbor_radius(g, cfg),
                     tables=class_grids(g, cfg), cell_table=cell_tables(g))
                for g in world.grids]

    exchange = _exchanger(world, exchange_width)

    def exchange_span(tiles, **kw):
        with trace.span("kid.exchange"):
            return exchange(tiles, **kw)

    def run(states, forcings, calvings, calving_hflxs):
        with trace.span("kid.run", step=True):
            seqs = [coupling_sequence(
                cfg, g, s, f, c, h, max_per_cell=max_per_cell,
                neighbor_mode=neighbor_mode, fused_kw=fused_kw, **kw)
                for g, s, f, c, h, kw in zip(world.grids, states,
                                             forcings, calvings,
                                             calving_hflxs, per_tile)]
            res, counters = _lockstep(
                seqs, lambda ts: exchange_span(ts, migrate=False))
            tiles, overflow = exchange_span([s.bergs for s, _ in res])
            overflow = torch.cat(counters + [overflow], dim=1)
            states = [s.replace(bergs=t) for (s, _), t in zip(res, tiles)]
            outs = [o for _, o in res]
            nbergs, _ = _owned_sums(ring, tiles)
            budgets = Budgets(*[
                None if v is None else ring.sum([o.budgets[i] for o in outs])
                for i, v in enumerate(outs[0].budgets)])
            kw = {f: ring.sum([getattr(o, f) for o in outs])
                  for f in _SUM_SCALARS if getattr(outs[0], f) is not None}
            kw.update({f: torch.stack([getattr(o, f) for o in outs])
                       for f in _GRIDDED if getattr(outs[0], f) is not None})
            outputs = outs[0]._replace(
                budgets=budgets, nbergs=nbergs,
                contact_overflow=ring.max([o.contact_overflow for o in outs]),
                contact_fallback=ring.max([o.contact_fallback for o in outs]),
                **kw)
            return states, outputs, nbergs, overflow

    return run


# --------------------------------------------------------------------------
# the tiled MTS step: per-substep ghost refresh
# --------------------------------------------------------------------------

# the dynamic state a replica takes from its owner at every substep
_GHOST_DYN_FIELDS = ("lon", "lat", "lon_old", "lat_old", "uvel", "vvel",
                     "uvel_old", "vvel_old", "axn_fast", "ayn_fast",
                     "bxn_fast", "byn_fast", "ang_vel", "ang_accel", "rot")


def ring_transport(ring: Ring, rows, axis, hops: int):
    """The k-hop bidirectional ring stack: each local tile's (W, C)
    ``rows`` -> the (2 min(hops, n - 1) + 1) W rows of the tile and of
    its neighbours up to ``hops`` away along ``axis``, in a fixed source
    order (its own, then 1 .. k hops behind, then 1 .. k ahead).  A
    tile's traffic is O(hops W C) whatever the ring's length n (the
    property of tests/test_ring_scaling.py)."""
    n = ring.layout[_AXIS_DIM[axis]]
    k = min(hops, n - 1)
    outs = [[r] for r in rows]
    for step in (1, -1):
        a = rows
        for _ in range(k):
            a = ring.shift(a, axis, step)
            for o, r in zip(outs, a):
                o.append(r)
    return [torch.cat(o, 0) for o in outs]


def _first_match(rcnt, rij, all_cnt, all_ij, all_valid):
    """For each replica id, the first stacked source row of that id
    among the valid ones: ``(src, found)``, ``src`` 0 where none (the
    JAX package's ``argmax`` of the dense (replicas, S) equality, from a
    stable sort of the stacked keys)."""
    from ..ops.forces import _lex_key
    big = torch.iinfo(torch.int64).max
    keys = torch.where(all_valid, _lex_key(all_cnt, all_ij), big)
    ks, order = torch.sort(keys, stable=True)
    q = _lex_key(rcnt, rij)
    pos = torch.searchsorted(ks, q).clamp(max=ks.shape[0] - 1)
    found = ks[pos] == q
    return torch.where(found, order[pos], 0).to(torch.int32), found


def _rank_select(mask, width: int):
    """The first ``width`` marked slots in slot order, 0-padded: ``(sel,
    valid, overflow)``."""
    N = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    granted = mask & (rank < width)
    sel = torch.zeros(width + 1, dtype=torch.int32, device=mask.device)
    sel.index_copy_(0, torch.where(granted, rank, width).long(),
                    torch.arange(N, dtype=torch.int32, device=mask.device))
    valid = torch.arange(width, device=mask.device) < granted.sum(
        dtype=torch.int32)
    return sel[:width], valid, (mask & ~granted).sum(dtype=torch.int32)


def make_sharded_mts_step(world, *, exchange_width: int = 64,
                          ghost_width: int = 128, ghost_slots: int = 256,
                          pair_cap: Optional[int] = None,
                          contact_cap: Optional[int] = None,
                          ghost_sync: str = "ring", ghost_hops: int = 2,
                          conglom_id_cap: int = 64,
                          mts_neighbor_mode: str = "tables",
                          with_thermo: bool = False,
                          with_spread: bool = False, **step_kw):
    """The tiled MTS/DEM step with a per-substep ghost refresh
    (``domain.py:1147-1325``): the particle exchange first (replicas
    before the physics), then on every tile the interpolation and the
    MTS cycle of :func:`..model.make_step` (``mts_neighbor_mode``, the
    JAX step's candidate tables by default; ``pair_cap``,
    ``contact_cap``, ``with_thermo``, ``with_spread`` and ``step_kw`` go
    to it), with the substeps as the scan and the tiles in lockstep.

    Membership is frozen for the outer step: each tile ships its first
    ``ghost_width`` owned bonded elements, and its first ``ghost_slots``
    bonded replicas each take the first shipped row of their id.  At the
    top of every substep the shipped rows' dynamic state
    (``_GHOST_DYN_FIELDS``) moves by ``ghost_hops``-hop ring shifts
    (:func:`ring_transport`; on a 2-D layout the x stack rides the y
    ring, so diagonal neighbours come through the corner) or, with
    ``ghost_sync="allgather"``, from every tile (:meth:`Ring.gather`), and
    each replica takes its owner's: the owned elements integrate against
    their partners' state at the substep's start, as untiled.  A replica
    whose owner is beyond the hops, a shipped element past
    ``ghost_width`` and a replica past ``ghost_slots`` are counted, never
    silently stale.  The convergence tests decide once for all tiles on
    the norms of the owned elements summed over the tiles (one host read
    each, as untiled).

    Returns ``step(tiles, forcings) -> (tiles, nbergs, total_mass,
    overflow)``; ``overflow`` the exchange's passes, then ``(ov_ship,
    ov_rep)`` and ``(replicas not found, 0)``; ``step.diags`` the tiles'
    ``StepDiags``; ``step.ghost_bytes`` the bytes the local tiles' ghost
    refreshes moved in the last step (:attr:`Ring.bytes`).  Accepts 1-D
    and 2-D worlds."""
    if ghost_sync not in ("ring", "allgather"):
        raise ValueError(f"ghost_sync={ghost_sync!r}")
    cfg, ring = world.cfg, world.ring
    steps = [make_step(g, cfg, with_thermo=with_thermo,
                       with_spread=with_spread, mts_pair_cap=pair_cap,
                       contact_cap=contact_cap,
                       mts_neighbor_mode=mts_neighbor_mode,
                       mts_lockstep=True, **step_kw) for g in world.grids]
    exchange = _exchanger(world, exchange_width, conglom_id_cap)
    is2d = isinstance(world, ShardedWorld2D)

    def transport(rows):
        """Each local tile's (W, C) rows -> its (S, C) source stack."""
        if ghost_sync == "allgather":
            allr = ring.gather(rows)
            return [torch.cat(allr, 0)] * len(rows)
        out = ring_transport(ring, rows, AXIS, ghost_hops)
        if is2d:
            out = ring_transport(ring, out, AXIS_Y, ghost_hops)
        return out

    def step(tiles, forcings):
        step.ghost_bytes = 0
        tiles, overflow = exchange(tiles)
        # each tile's frozen plan: the slots it ships, and for each of its
        # replica slots the stacked source row (src) and the slot written
        # (tgt; the capacity, a sink, where the owner's row is missing)
        plans, extra = [], []
        for s in tiles:
            has = _has_stamp(s)
            ship, ship_valid, ov_ship = _rank_select(
                s.alive & (s.halo_berg < 0.5) & has, ghost_width)
            rep, rep_valid, ov_rep = _rank_select(
                s.alive & (s.halo_berg >= 0.5) & has, ghost_slots)
            plans.append(SimpleNamespace(ship=ship.long(), rep=rep.long(),
                                         ship_valid=ship_valid,
                                         rep_valid=rep_valid))
            extra.append([ov_ship, ov_rep])
        ids = transport([torch.stack([
            torch.where(p.ship_valid, s.id_cnt[p.ship], 0),
            torch.where(p.ship_valid, s.id_ij[p.ship], 0),
            p.ship_valid.to(torch.int32)], dim=-1)
            for s, p in zip(tiles, plans)])
        for s, p, allp, e in zip(tiles, plans, ids, extra):
            src, found = _first_match(s.id_cnt[p.rep], s.id_ij[p.rep],
                                      allp[:, 0], allp[:, 1], allp[:, 2] > 0)
            found = found & p.rep_valid
            p.src = src.long()
            p.tgt = torch.where(found, p.rep, s.capacity)
            e += [(p.rep_valid & ~found).sum(dtype=torch.int32),
                  torch.zeros_like(e[0])]

        def sync(states):
            b0 = ring.bytes
            rows = transport([torch.stack([getattr(s, f)[p.ship]
                                           for f in _GHOST_DYN_FIELDS], -1)
                              for s, p in zip(states, plans)])
            out = []
            for s, p, r in zip(states, plans, rows):
                upd = r[p.src]
                kw = {}
                for fi, f in enumerate(_GHOST_DYN_FIELDS):
                    v = getattr(s, f)
                    v = torch.cat([v, v[:1]]).index_copy_(0, p.tgt,
                                                          upd[:, fi])
                    kw[f] = v[:s.capacity]
                out.append(s.replace(**kw))
            step.ghost_bytes += ring.bytes - b0
            return out

        def on_event(evs):
            if evs[0].kind == "sync":
                return sync([e.value for e in evs])
            parts = [e.value for e in evs]
            sums = [ring.sum([p[i] for p in parts]) for i in range(3)]
            had = (None if parts[0][3] is None else ring.sum(
                [p[3].to(torch.int32) for p in parts]) > 0)
            return [converged(*sums, had, parts[0][4])] * len(evs)

        out, counters = _lockstep(
            [f.sequence(s, fr) for f, s, fr in zip(steps, tiles, forcings)],
            lambda ts: exchange(ts, migrate=False), on_event)
        step.diags = [d for _, d in out]
        tiles = [s for s, _ in out]
        nbergs, total_mass = _owned_sums(ring, tiles)
        ghost = torch.stack([torch.stack(e).view(-1, 2) for e in extra])
        return tiles, nbergs, total_mass, torch.cat(
            counters + [overflow, ghost], dim=1)

    step.diags, step.ghost_bytes = [], 0
    return step


__all__ = [
    "AXIS", "AXIS_Y", "Ring", "ShardedWorld", "ShardedWorld2D",
    "make_sharded_world", "make_sharded_world_2d", "shard_forcing",
    "shard_forcing_2d", "shard_state", "shard_state_2d", "relocalize",
    "exchange_particles", "concat_tiles", "make_sharded_step",
    "make_sharded_step_2d", "make_halo_fill", "make_halo_fill_2d",
    "make_forcing_halo_update", "shard_calving_field",
    "init_sharded_model_state", "make_sharded_run", "fold_state",
    "replicate_bonded_bergs", "ring_transport", "make_sharded_mts_step",
]

"""Spatial domain decomposition: tiles, halos and particle migration.

Counterpart of ``icebergs_tpu/parallel/domain.py``, the reference's
FMS/MPI layer (``mpp_define_domains``, the halo updates and the particle
sends, ``src/icebergs_framework.F90:913-934, 1800-2135, 2997-3249``), in
ROADMAP.md item 13's first three slices: the tile grids and the
host-side decomposition (``:68-285``), the particle exchange
(``:292-539``), and the tiled coupling step and run in 1-D (tiles along
x) and 2-D (``:683-1104, 1328-1503``).

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
(``ov1``, ``ov2``), 4 passes in 1-D and 8 in 2-D; their sum over the
last two axes is the JAX package's per-device ``overflow``.

Bonds across tiles (slice 4), MTS across tiles (slice 5) and the
tripolar fold (slice 6) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..api import ModelState, coupling_sequence
from ..calving import class_grids, init_calving_state
from ..config import IcebergsConfig
from ..convert import state_from_numpy, to_numpy
from ..diag import Budgets
from ..forcing import Forcing
from ..grid import Grid, make_uniform_grid, pos_to_cell
from ..model import make_step
from ..ops.forces import neighbor_radius
from ..ops.pack import from_bits, permute_cols_u32, to_bits
from ..ops.segment_spread import cell_tables
from ..state import (ALL_FIELDS, BOND_FLOAT_FIELDS, BOND_INT_FIELDS,
                     FLOAT_FIELDS, INT_FIELDS, BergState, allocate_slots,
                     empty_state)

AXIS, AXIS_Y = "x", "y"
_AXIS_DIM = {AXIS: 0, AXIS_Y: 1}
BONDS_SLICE = ("bonds across tiles are ROADMAP.md item 13 slice 4 "
               "(stamp_bond_ids, replicate_bonded_bergs)")
MTS_SLICE = ("MTS across tiles is ROADMAP.md item 13 slice 5 "
             "(make_sharded_mts_step, ring_transport, substep_sync)")
FOLD_SLICE = ("the tripolar fold is ROADMAP.md item 13 slice 6 "
              "(fold_state, _exchange_fold_north)")

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
    layout is (t // ndy, t % ndy), x-major as the JAX mesh's devices."""

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
        out, ops = [], []
        for k, t in enumerate(self.tiles):
            src = self.neighbour(t, axis, -step)
            if src in self._local:
                out.append(bufs[self._local[src]])
            else:
                out.append(torch.empty_like(bufs[k]))
                ops.append(dist.P2POp(dist.irecv, out[k],
                                      src // self.per_rank, tag=t))
        for k, t in enumerate(self.tiles):
            dst = self.neighbour(t, axis, step)
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
    a ``halo`` ring (``folded_north`` is slice 6 and not built)."""
    ring: Ring
    grids: list
    cfg: IcebergsConfig
    nxl: int
    nyl: int
    halo: int
    grids_host: list
    origin: tuple
    folded_north: bool = False

    @property
    def device(self):
        return self.grids[0].device


def _f32(x) -> float:
    return float(np.float32(x))


def _slice_tile_grid(gg: Grid, sx: int, sy: int, nxt: int, nyt: int, *,
                     periodic: bool, own_hx: int = 0, own_hy: int = 0,
                     dtype=torch.float32) -> Grid:
    """The tile grid covering global cells [sx, sx+nxt) x [sy, sy+nyt) of
    the CPU grid ``gg``, on the CPU.  Interior values are slices of the
    global arrays bit for bit; halo cells beyond the domain are land (or
    the periodic image in x); corner coordinates extend linearly.  The
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

    def centers(a):
        return t(a.numpy()[np.ix_(gcx, gcy)])

    return Grid(
        nx=nxt, ny=nyt, lonc=t(lonc), latc=t(latc),
        cosc=torch.ones(nxt + 1, nyt + 1, dtype=dtype),
        sinc=torch.zeros(nxt + 1, nyt + 1, dtype=dtype),
        msk=centers(gg.msk), area=centers(gg.area), dx=centers(gg.dx),
        dy=centers(gg.dy), ocean_depth=centers(gg.ocean_depth),
        lat_center=centers(gg.lat_center), lon0=t(xc[0]), lat0=t(yc[0]),
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
    indices re-localised on each tile.  Returns the local tiles'."""
    if world.cfg.iceberg_bonds_on:
        raise NotImplementedError(BONDS_SLICE)
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
                 shift: int = 0, halo_flag: Optional[float] = None):
    """The buffer's valid rows written into free slots (``idx_field``
    moved by ``shift`` into this tile's frame, ``halo_berg`` set to
    ``halo_flag``, bond slots cleared).  Returns ``(state, overflow)``,
    the valid rows that found no free slot."""
    cap, dev = st.capacity, st.device
    width = buf.shape[1]
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
    kw = dict(bond_idx=torch.where(newly[:, None], -1, out.bond_idx))
    if halo_flag is not None:
        kw["halo_berg"] = torch.where(newly, halo_flag, out.halo_berg)
    overflow = (valid & ~granted).sum(dtype=torch.int32)
    return out.replace(**kw), overflow


def _exchange_axis(ring: Ring, tiles, axis, idx_field: str, nl: int, H: int,
                   width: int, *, migrate: bool = True):
    """Migration then halo replication along one axis of the ring: one
    direction pass of ``send_bergs_to_other_pes`` +
    ``update_halo_icebergs`` (running x then y moves diagonal travellers
    and corner halos in two hops, icebergs_framework.F90:1840-2135);
    ``migrate=False`` replicates only.  Returns ``(tiles, counters)``,
    each tile's [ov1, ov2] of every pass."""
    def idx(s):
        return getattr(s, idx_field)

    counters = [[] for _ in tiles]

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
        go_hi = [o & (idx(s) >= H + nl) for o, s in zip(owned, tiles)]
        go_lo = [o & (idx(s) < H) for o, s in zip(owned, tiles)]
        tiles = passes(tiles, (go_hi, go_lo), None, True)
    # edge strips, owned and already received copies alike, so that
    # corners propagate on the second axis's pass
    edge_hi = [s.alive & (idx(s) >= nl) for s in tiles]
    edge_lo = [s.alive & (idx(s) < 2 * H) for s in tiles]
    tiles = passes(tiles, (edge_hi, edge_lo), 1.0, False)
    return tiles, counters


def exchange_particles(ring: Ring, tiles, cfg: IcebergsConfig, nxl: int,
                       H: int, width: int, *, nyl: Optional[int] = None,
                       y_axis: Optional[str] = None, fold_north=None,
                       migrate: bool = True):
    """Ownership migration and halo replication of the local ``tiles``:
    the stale halo copies dropped, then the x pass and, with ``y_axis``
    (2-D, ``nyl`` interior rows), the y pass; ``migrate=False`` refreshes
    the halo copies only (the tiled run's mid-step refresh).  Returns
    ``(tiles, overflow)``, ``overflow`` (tiles, passes, 2) int32."""
    if cfg.iceberg_bonds_on:
        raise NotImplementedError(BONDS_SLICE)
    if fold_north is not None:
        raise NotImplementedError(FOLD_SLICE)
    tiles = [s.replace(alive=s.alive & (s.halo_berg < 0.5)) for s in tiles]
    tiles, counters = _exchange_axis(ring, tiles, AXIS, "ine", nxl, H, width,
                                     migrate=migrate)
    if y_axis is not None:
        tiles, cy = _exchange_axis(ring, tiles, y_axis, "jne", nyl, H, width,
                                   migrate=migrate)
        counters = [a + b for a, b in zip(counters, cy)]
    overflow = torch.stack([torch.stack(c).view(-1, 2) for c in counters])
    return tiles, overflow


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
    (icebergs_framework.F90:915-925).  ``folded_north`` is slice 6."""
    if folded_north:
        raise NotImplementedError(FOLD_SLICE)
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
            periodic=periodic, own_hx=H, own_hy=H, dtype=dtype))
    dev = _device(device)
    return ShardedWorld2D(ring=ring, grids=[g.to(dev) for g in host],
                          cfg=cfg, nxl=nxl, nyl=nyl, halo=H,
                          grids_host=host, origin=_tile_origin(gg, -H, -H))


def shard_state_2d(world: ShardedWorld2D, st_global: BergState,
                   local_capacity: int):
    """The live bergs distributed to their owning 2-D tiles (host side);
    bond slots are cleared, as the JAX package clears them."""
    if world.cfg.iceberg_bonds_on:
        raise NotImplementedError(BONDS_SLICE)
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
    """The local (dx, dy) tiles' slices (+halo) of a global Forcing."""
    ndx, ndy = world.ring.layout
    nxl, nyl, H = world.nxl, world.nyl, world.halo
    nx, ny = nxl * ndx, nyl * ndy
    out = []
    for t in world.ring.tiles:
        dx, dy = world.ring.coords(t)

        def corner_slice(a):
            ix = np.arange(dx * nxl - H, (dx + 1) * nxl + H + 1)
            iy = np.arange(dy * nyl - H, (dy + 1) * nyl + H + 1)
            return a[np.ix_(np.clip(ix, 0, nx), np.clip(iy, 0, ny))]

        def center_slice(a):          # halo-padded global (nx+2, ny+2)
            px = np.arange(dx * nxl - H, (dx + 1) * nxl + 2 + H)
            py = np.arange(dy * nyl - H, (dy + 1) * nyl + 2 + H)
            return a[np.ix_(np.clip(px, 0, nx + 1), np.clip(py, 0, ny + 1))]
        out.append(_forcing_tile(frc_global, corner_slice, center_slice,
                                 world.device))
    return out


# --------------------------------------------------------------------------
# the tiled step, halo fills and run
# --------------------------------------------------------------------------

def _exchange_kw(world) -> dict:
    if isinstance(world, ShardedWorld2D):
        return dict(nyl=world.nyl, y_axis=AXIS_Y)
    return {}


def _supported(cfg: IcebergsConfig):
    if cfg.mts:
        raise NotImplementedError(MTS_SLICE)
    if cfg.iceberg_bonds_on:
        raise NotImplementedError(BONDS_SLICE)


def _owned_sums(ring: Ring, tiles):
    owned = [s.alive & (s.halo_berg < 0.5) for s in tiles]
    nbergs = ring.sum([o.sum(dtype=torch.int32) for o in owned])
    mass = ring.sum([torch.where(o, s.mass * s.mass_scaling, 0.).sum()
                     for o, s in zip(owned, tiles)])
    return nbergs, mass


def _exchanger(world, width: int):
    """``exchange(tiles, migrate=True) -> (tiles, overflow)`` on the
    world's ring and layout."""
    def exchange(tiles, migrate=True):
        return exchange_particles(world.ring, tiles, world.cfg, world.nxl,
                                  world.halo, width, migrate=migrate,
                                  **_exchange_kw(world))
    return exchange


def _lockstep(seqs, refresh):
    """Drive the tiles' step generators together; where they yield
    (newborns whose neighbours are read next) ``refresh`` the halo
    copies.  Returns ``(the tiles' results, the refreshes' counters)``."""
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
    _supported(cfg)
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


def make_halo_fill(world, exchange_width: int = 64):
    """One particle exchange with no physics: ``fill(tiles) -> (tiles,
    overflow)``.  :func:`shard_state` places only owned bergs and the
    step runs its physics before its exchange, so without this the first
    step's contacts miss the partners across a tile edge (the reference
    fills halos at init, icebergs_framework.F90:1847-1905)."""
    _supported(world.cfg)
    return _exchanger(world, exchange_width)


def make_halo_fill_2d(world: ShardedWorld2D, exchange_width: int = 64):
    """The 2-D twin of :func:`make_halo_fill` (x pass then y pass)."""
    return make_halo_fill(world, exchange_width)


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
    exchange's.  Accepts 1-D and 2-D worlds."""
    cfg, ring = world.cfg, world.ring
    _supported(cfg)
    per_tile = [dict(nbr_radius=neighbor_radius(g, cfg),
                     tables=class_grids(g, cfg), cell_table=cell_tables(g))
                for g in world.grids]

    exchange = _exchanger(world, exchange_width)

    def run(states, forcings, calvings, calving_hflxs):
        seqs = [coupling_sequence(
            cfg, g, s, f, c, h, max_per_cell=max_per_cell,
            neighbor_mode=neighbor_mode, fused_kw=fused_kw, **kw)
            for g, s, f, c, h, kw in zip(world.grids, states, forcings,
                                         calvings, calving_hflxs, per_tile)]
        res, counters = _lockstep(
            seqs, lambda ts: exchange(ts, migrate=False))
        tiles, overflow = exchange([s.bergs for s, _ in res])
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


__all__ = [
    "AXIS", "AXIS_Y", "Ring", "ShardedWorld", "ShardedWorld2D",
    "make_sharded_world", "make_sharded_world_2d", "shard_forcing",
    "shard_forcing_2d", "shard_state", "shard_state_2d", "relocalize",
    "exchange_particles", "concat_tiles", "make_sharded_step",
    "make_sharded_step_2d", "make_halo_fill", "make_halo_fill_2d",
    "make_forcing_halo_update", "shard_calving_field",
    "init_sharded_model_state", "make_sharded_run",
]

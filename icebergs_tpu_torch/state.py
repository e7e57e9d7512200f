"""Particle state as fixed-capacity structure-of-arrays tensors.

PyTorch counterpart of ``icebergs_tpu/state.py``: one flat capacity-``N``
tensor per field with an ``alive`` mask, plus the ``(N, B)`` bond tables,
under the same field names, dtypes and defaults.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import trace

FLOAT_FIELDS = (
    "lon", "lat", "uvel", "vvel",
    "mass", "thickness", "width", "length",
    "axn", "ayn", "bxn", "byn",
    "lon_old", "lat_old", "uvel_old", "vvel_old",
    "uvel_prev", "vvel_prev",
    "start_lon", "start_lat", "start_day", "start_mass",
    "mass_scaling", "mass_of_bits", "heat_density",
    "halo_berg", "static_berg",
    "xi", "yj",
    "uo", "vo", "ui", "vi", "ua", "va",
    "ssh_x", "ssh_y", "sst", "sss", "cn", "hi", "od",
    "fl_k", "mass_of_fl_bits", "mass_of_fl_bergy_bits", "fl_spawn_count",
    "axn_fast", "ayn_fast", "bxn_fast", "byn_fast",
    "ang_vel", "ang_accel", "rot",
    "n_bonds",
)
INT_FIELDS = ("ine", "jne", "start_year", "id_cnt", "id_ij", "conglom_id")
BOND_FLOAT_FIELDS = ("bond_length", "bond_tangd1", "bond_tangd2",
                     "bond_nstress", "bond_sstress", "bond_rel_rotation")
BOND_INT_FIELDS = ("bond_idx", "bond_id_cnt", "bond_id_ij", "bond_broken")
ALL_FIELDS = (("alive",) + FLOAT_FIELDS + INT_FIELDS + BOND_FLOAT_FIELDS
              + BOND_INT_FIELDS)


@dataclasses.dataclass(frozen=True)
class BergState:
    """Fixed-capacity SoA particle state (+ bond table); every field a
    tensor of length ``capacity`` (bond tables ``(capacity, B)``)."""
    alive: torch.Tensor
    lon: torch.Tensor
    lat: torch.Tensor
    uvel: torch.Tensor
    vvel: torch.Tensor
    mass: torch.Tensor
    thickness: torch.Tensor
    width: torch.Tensor
    length: torch.Tensor
    axn: torch.Tensor
    ayn: torch.Tensor
    bxn: torch.Tensor
    byn: torch.Tensor
    lon_old: torch.Tensor
    lat_old: torch.Tensor
    uvel_old: torch.Tensor
    vvel_old: torch.Tensor
    uvel_prev: torch.Tensor
    vvel_prev: torch.Tensor
    start_lon: torch.Tensor
    start_lat: torch.Tensor
    start_day: torch.Tensor
    start_mass: torch.Tensor
    mass_scaling: torch.Tensor
    mass_of_bits: torch.Tensor
    heat_density: torch.Tensor
    halo_berg: torch.Tensor
    static_berg: torch.Tensor
    xi: torch.Tensor
    yj: torch.Tensor
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
    fl_k: torch.Tensor
    mass_of_fl_bits: torch.Tensor
    mass_of_fl_bergy_bits: torch.Tensor
    fl_spawn_count: torch.Tensor
    axn_fast: torch.Tensor
    ayn_fast: torch.Tensor
    bxn_fast: torch.Tensor
    byn_fast: torch.Tensor
    ang_vel: torch.Tensor
    ang_accel: torch.Tensor
    rot: torch.Tensor
    n_bonds: torch.Tensor
    ine: torch.Tensor
    jne: torch.Tensor
    start_year: torch.Tensor
    id_cnt: torch.Tensor
    id_ij: torch.Tensor
    conglom_id: torch.Tensor
    bond_idx: torch.Tensor
    bond_id_cnt: torch.Tensor
    bond_id_ij: torch.Tensor
    bond_broken: torch.Tensor
    bond_length: torch.Tensor
    bond_tangd1: torch.Tensor
    bond_tangd2: torch.Tensor
    bond_nstress: torch.Tensor
    bond_sstress: torch.Tensor
    bond_rel_rotation: torch.Tensor

    def replace(self, **kw) -> "BergState":
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    @property
    def max_bonds(self) -> int:
        return self.bond_idx.shape[1]

    @property
    def dtype(self):
        return self.lon.dtype

    @property
    def device(self):
        return self.lon.device

    def count(self):
        """Number of live bergs (0-dim int32 tensor, no host sync)."""
        return self.alive.sum(dtype=torch.int32)

    def to(self, device) -> "BergState":
        return BergState(**{f: getattr(self, f).to(device)
                            for f in ALL_FIELDS})


def empty_state(capacity: int, max_bonds: int = 6, dtype=torch.float32,
                *, device) -> BergState:
    """An all-dead state of the given capacity on ``device``."""
    kw = {f: torch.zeros(capacity, dtype=dtype, device=device)
          for f in FLOAT_FIELDS}
    kw.update({f: torch.zeros(capacity, dtype=torch.int32, device=device)
               for f in INT_FIELDS})
    kw.update({f: torch.zeros(capacity, max_bonds, dtype=dtype,
                              device=device) for f in BOND_FLOAT_FIELDS})
    kw.update({f: torch.zeros(capacity, max_bonds, dtype=torch.int32,
                              device=device) for f in BOND_INT_FIELDS})
    kw["bond_idx"] = kw["bond_idx"] - 1          # -1 = no bond
    return BergState(alive=torch.zeros(capacity, dtype=torch.bool,
                                       device=device), **kw)


def create_bergs(capacity: int, *, lon, lat, uvel=None, vvel=None,
                 mass=None, thickness=None, width=None, length=None,
                 mass_scaling=None, start_year=None, start_day=None,
                 id_cnt=None, id_ij=None, static_berg=None,
                 max_bonds: int = 6, dtype=torch.float32, device,
                 **extra) -> BergState:
    """A BergState from per-berg arrays (n <= capacity live slots).

    Values go through float64 numpy and are rounded once to ``dtype``,
    as ``icebergs_tpu.state.create_bergs`` rounds them."""
    with trace.span("kid.create_bergs"):
        lon = np.asarray(lon, dtype=np.float64)
        n = lon.shape[0]
        if n > capacity:
            raise ValueError(f"{n} bergs > capacity {capacity}")
        st = empty_state(capacity, max_bonds=max_bonds, dtype=dtype,
                         device=device)

        def fill(val, default=0.0, integer=False):
            if val is None:
                val = np.full((n,), default)
            val = np.asarray(val)
            if val.ndim == 0:
                val = np.full((n,), float(val))
            tgt = np.zeros((capacity,), np.int32 if integer else np.float64)
            tgt[:n] = val
            return torch.as_tensor(tgt).to(
                device=device, dtype=torch.int32 if integer else dtype)

        kw = dict(
            alive=torch.arange(capacity, device=device) < n,
            lon=fill(lon), lat=fill(lat), uvel=fill(uvel), vvel=fill(vvel),
            mass=fill(mass, 1e9), thickness=fill(thickness, 100.),
            width=fill(width, 100.), length=fill(length, 100.),
            mass_scaling=fill(mass_scaling, 1.0),
            start_year=fill(start_year, 0, integer=True),
            start_day=fill(start_day, 0.),
            start_lon=fill(lon), start_lat=fill(lat),
            static_berg=fill(static_berg, 0.),
            id_cnt=fill(id_cnt if id_cnt is not None else np.arange(n),
                        integer=True),
            id_ij=fill(id_ij, 0, integer=True),
            start_mass=fill(extra.pop("start_mass", None)),
            heat_density=fill(extra.pop("heat_density", None)),
        )
        kw["lon_old"], kw["lat_old"] = kw["lon"], kw["lat"]
        kw["uvel_old"], kw["vvel_old"] = kw["uvel"], kw["vvel"]
        for name, val in extra.items():
            kw[name] = fill(val, integer=name in INT_FIELDS)
        return st.replace(**kw)


def allocate_slots(alive, want):
    """Pack spawn requests into dead slots (the prefix-sum allocator of
    ``icebergs_tpu.state.allocate_slots``, which replaces the reference's
    ``add_new_berg_to_list``).

    ``want`` is a boolean request vector of any length.  Returns
    ``(granted, slots)``: request r got a slot iff ``granted[r]``, the
    ``slots[r]``-th (int32; -1 otherwise), the requests taking the dead
    slots in ascending order by rank.  On the device, no host sync."""
    capacity = alive.shape[0]
    dev = alive.device
    dead = ~alive
    order = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1
    dead_rank = torch.cumsum(dead.to(torch.int32), 0, dtype=torch.int32) - 1
    # row `capacity` takes the live slots' writes and is dropped
    slot_of_rank = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    slot_of_rank.index_copy_(0, torch.where(dead, dead_rank,
                                            capacity).long(),
                             torch.arange(capacity, dtype=torch.int32,
                                          device=dev))
    nfree = dead.sum(dtype=torch.int32)
    granted = want & (order < nfree)
    slots = torch.where(granted,
                        slot_of_rank[order.clamp(0, capacity - 1).long()],
                        -1)
    return granted, slots


def grow_capacity(st: BergState, new_capacity: int) -> BergState:
    """A copy of ``st`` with a larger slot pool (host side, between
    steps: ``icebergs_tpu.state.grow_capacity``).  Slot indices, and so
    the bond partner slots, are kept; the new slots are dead with empty
    bonds."""
    if new_capacity < st.capacity:
        raise ValueError(f"cannot shrink: {new_capacity} < {st.capacity}")
    if new_capacity == st.capacity:
        return st
    pad = empty_state(new_capacity - st.capacity, max_bonds=st.max_bonds,
                      dtype=st.dtype, device=st.device)
    return BergState(**{f: torch.cat([getattr(st, f), getattr(pad, f)])
                        for f in ALL_FIELDS})


def pack_id(id_cnt, id_ij):
    """The 64-bit id ``cnt * 2^32 + ij`` as a float32 (the JAX package's
    value without x64)."""
    return id_cnt.to(torch.float32) * 4294967296.0 + id_ij

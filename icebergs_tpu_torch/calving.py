"""Calving: the coastal accumulation buckets and the spawning of bergs.

Counterpart of ``icebergs_tpu/calving.py`` (``CalvingState``,
``init_calving_state``, ``_class_tables``, ``get_running_mean_calving``,
``accumulate_calving``, ``calve_icebergs``; port of
``src/icebergs.F90:5996-6045, 6153-6402``).  Each (cell, class) bucket
spawns up to ``max_spawn_per_bucket`` bergs a step.  The requests are
flattened in the JAX package's (class, m, i, j) order (K x M x nx x ny,
5.2M at 512 x 512) and ranked by one prefix sum into the dead slots
(:func:`.state.allocate_slots`).  Where the JAX function computes every
request's fields and scatters them, this one inverts the grant once (slot
-> request) and computes the reborn slots' fields at slab length from the
same tables and expressions, so the values are the same bits.  Everything
stays on the device: the counters (``nbergs_calved``, ``spawn_overflow``)
and the sums (``calving_to_bergs``, ``heat_to_bergs``) are 0-dim tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import NCLASSES, IcebergsConfig
from .grid import Grid
from .ops.accel import divc
from .ops.interp import interp_to_bergs
from .state import allocate_slots


@dataclasses.dataclass(frozen=True)
class CalvingState:
    """Gridded calving bookkeeping (halo-padded center fields)."""
    stored_ice: torch.Tensor      # (nx+2, ny+2, nclasses) kg
    stored_heat: torch.Tensor     # (nx+2, ny+2) J
    id_counter: torch.Tensor      # (nx+2, ny+2) int32 per-cell id counter
    rmean_calving: torch.Tensor   # (nx+2, ny+2) running-mean calving kg/s
    rmean_calving_hflx: torch.Tensor
    rmean_init: torch.Tensor      # 0-dim bool: running means initialised

    def replace(self, **kw) -> "CalvingState":
        return dataclasses.replace(self, **kw)


def init_calving_state(grid: Grid, dtype=torch.float32) -> CalvingState:
    shape = (grid.nx + 2, grid.ny + 2)
    dev = grid.device
    z = torch.zeros(shape, dtype=dtype, device=dev)
    return CalvingState(
        stored_ice=torch.zeros(shape + (NCLASSES,), dtype=dtype, device=dev),
        stored_heat=z, id_counter=torch.zeros(shape, dtype=torch.int32,
                                              device=dev),
        rmean_calving=z, rmean_calving_hflx=z,
        rmean_init=torch.zeros((), dtype=torch.bool, device=dev))


def _class_tables(cfg: IcebergsConfig):
    """(south, north) class tables as float64 numpy, with the derived
    length and width (L = sqrt(A*LoW), W = sqrt(A/LoW), A = M/(rho*T))."""
    def derive(mass, thick):
        A = mass / (cfg.rho_bergs * thick)
        return np.sqrt(A * cfg.LoW_ratio), np.sqrt(A / cfg.LoW_ratio)

    s = dict(mass=np.asarray(cfg.initial_mass),
             dist=np.asarray(cfg.distribution),
             scal=np.asarray(cfg.mass_scaling),
             thick=np.asarray(cfg.initial_thickness))
    if cfg.separate_distrib_for_n_hemisphere:
        n = dict(mass=np.asarray(cfg.initial_mass_n),
                 dist=np.asarray(cfg.distribution_n),
                 scal=np.asarray(cfg.mass_scaling_n),
                 thick=np.asarray(cfg.initial_thickness_n))
    else:
        n = s
    s["L"], s["W"] = derive(s["mass"], s["thick"])
    n["L"], n["W"] = derive(n["mass"], n["thick"])
    return s, n


def class_grids(grid: Grid, cfg: IcebergsConfig, dtype=torch.float32):
    """The hemisphere class tables on the grid: ``{key: (nx+2, ny+2, K)}``
    for mass, dist, scal, thick, L and W, each value rounded once to
    ``dtype`` as the JAX tables are.  Built from Python floats (fills), so
    no host data is copied to the device; a model builds them once."""
    s, n = _class_tables(cfg)
    south = grid.lat_center < 0.
    shape = south.shape

    def tab(key):
        return torch.stack([torch.where(
            south, torch.full(shape, float(a), dtype=dtype,
                              device=south.device),
            torch.full(shape, float(b), dtype=dtype, device=south.device))
            for a, b in zip(s[key], n[key])], dim=-1)
    return {k: tab(k) for k in ("mass", "dist", "scal", "thick", "L", "W")}


def get_running_mean_calving(calv: CalvingState, calving, calving_hflx,
                             cfg: IcebergsConfig):
    """Exponential smoothing of the calving field over ``tau_calving``
    years (get_running_mean_calving, icebergs.F90:5996-6045).  The
    smoothing weight is the JAX package's float32 value."""
    if cfg.tau_calving <= 0.:
        return calv, calving, calving_hflx
    tau = cfg.tau_calving * 86400. * 365.
    f32 = np.float32
    alpha = np.minimum(f32(1.0), f32(cfg.dt) / np.maximum(f32(tau),
                                                          f32(cfg.dt)))
    one_m = float(f32(1.0) - alpha)
    alpha = float(alpha)
    rm_c = torch.where(calv.rmean_init,
                       one_m * calv.rmean_calving + alpha * calving, calving)
    rm_h = torch.where(calv.rmean_init,
                       one_m * calv.rmean_calving_hflx
                       + alpha * calving_hflx, calving_hflx)
    calv = calv.replace(rmean_calving=rm_c, rmean_calving_hflx=rm_h,
                        rmean_init=torch.ones_like(calv.rmean_init))
    return calv, rm_c, rm_h


def accumulate_calving(calv: CalvingState, grid: Grid, calving,
                       calving_hflx, cfg: IcebergsConfig, tables=None):
    """Split the calving flux (kg/s per cell, halo-padded; heat in W/m2)
    into the per-class buckets (accumulate_calving,
    icebergs.F90:6193-6222).  Returns ``(calv, residual_calving,
    residual_hflx, used_kg, used_heat_J)``."""
    s, n = _class_tables(cfg)
    tables = tables if tables is not None else class_grids(
        grid, cfg, calving.dtype)
    south = grid.lat_center < 0.
    stored = calv.stored_ice + cfg.dt * calving[:, :, None] * tables["dist"]
    rem_s = 1. - float(np.sum(s["dist"]))
    rem_n = 1. - float(np.sum(n["dist"]))
    remaining = torch.where(south, torch.full_like(calving, rem_s),
                            torch.full_like(calving, rem_n))
    used_kg = (calving * (1. - remaining)).sum() * cfg.dt
    heat_in = cfg.dt * calving_hflx * grid.area * (1. - remaining)
    calv = calv.replace(stored_ice=stored,
                        stored_heat=calv.stored_heat + heat_in)
    return (calv, calving * remaining, calving_hflx * remaining, used_kg,
            heat_in.sum())


def calve_icebergs(st, calv: CalvingState, grid: Grid, frc,
                   cfg: IcebergsConfig, current_year=0, current_yearday=0.,
                   max_spawn_per_bucket: int = 2, tables=None):
    """Spawn bergs from the buckets holding more than
    initial_mass * mass_scaling (calve_icebergs, icebergs.F90:6225-6402),
    then interpolate the environment onto every berg (the default
    ``old_interp_flds_order=False``).  Returns ``(state, calv, diag)``,
    ``diag`` with ``nbergs_calved``, ``spawn_overflow`` (requests that
    found no dead slot), ``calving_to_bergs``, ``heat_to_bergs`` (0-dim)
    and ``real_calving`` (kg/s per cell and class).  ``current_year`` /
    ``current_yearday`` may be Python numbers or 0-dim tensors."""
    nx, ny = grid.nx, grid.ny
    K, M = NCLASSES, max_spawn_per_bucket
    dtype = st.dtype
    dev = st.device
    tb = tables if tables is not None else class_grids(grid, cfg, dtype)
    im, ms, th, Lt, Wt = (tb[k] for k in ("mass", "scal", "thick", "L",
                                          "W"))
    stored = calv.stored_ice
    cap = im * ms
    n_want = torch.floor(stored / cap.clamp(min=1e-30)).clamp(0, M).to(
        torch.int32)
    # only interior ocean cells spawn; on a tile the ring it does not own
    # is left out, so each global cell spawns on exactly one tile
    hx, hy = grid.own_halo_x, grid.own_halo_y
    interior = torch.zeros((nx + 2, ny + 2), dtype=torch.bool, device=dev)
    interior[1 + hx:nx + 1 - hx, 1 + hy:ny + 1 - hy] = True
    n_want = torch.where((interior & (grid.msk > 0.))[:, :, None], n_want,
                         0)

    # heat density per class, classes in turn (H shrinks as they spawn)
    hd = []
    H = calv.stored_heat
    for k in range(K):
        Ik = stored[:, :, k].clamp(min=1e-30)
        hk = torch.where(stored[:, :, k] > 0., H / Ik, 0.)
        H = H - n_want[:, :, k].to(dtype) * cap[:, :, k] * hk
        hd.append(hk)
    hdens = torch.stack(hd, dim=-1)

    # requests in (class, m, i, j) order, ranked into the dead slots
    nc = nx * ny
    want = (n_want[1:-1, 1:-1, :].permute(2, 0, 1)[:, None]
            > torch.arange(M, device=dev)[None, :, None, None])
    flat_want = want.reshape(-1)
    granted, slots = allocate_slots(st.alive, flat_want)

    # invert the grant: each reborn slot's request index
    N = st.capacity
    R = flat_want.shape[0]
    tgt = torch.where(granted, slots, N).long()
    req = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    req.index_copy_(0, tgt, torch.arange(R, dtype=torch.int32, device=dev))
    reborn = req[:N] >= 0
    r = req[:N].clamp(min=0)
    k_of = torch.div(r, M * nc, rounding_mode="floor")
    m_of = torch.div(r, nc, rounding_mode="floor") % M
    cell = r % nc
    ci = torch.div(cell, ny, rounding_mode="floor")
    cj = cell % ny
    Ic, Jc, kk = (ci + 1).long(), (cj + 1).long(), k_of.long()
    imr, msr, thr = im[Ic, Jc, kk], ms[Ic, Jc, kk], th[Ic, Jc, kk]
    Lr, Wr, hdr = Lt[Ic, Jc, kk], Wt[Ic, Jc, kk], hdens[Ic, Jc, kk]
    ci_l, cj_l = ci.long(), cj.long()
    lon_b = 0.25 * (grid.lonc[ci_l, cj_l] + grid.lonc[ci_l + 1, cj_l]
                    + grid.lonc[ci_l, cj_l + 1]
                    + grid.lonc[ci_l + 1, cj_l + 1])
    lat_b = 0.25 * (grid.latc[ci_l, cj_l] + grid.latc[ci_l + 1, cj_l]
                    + grid.latc[ci_l, cj_l + 1]
                    + grid.latc[ci_l + 1, cj_l + 1])
    ddt = (-cfg.dt * (2. / 17.)) * m_of.to(dtype)     # start-day stagger
    start_day = (torch.zeros_like(lon_b) + current_yearday) \
        + divc(ddt, 86400.)
    # ids: (per-cell counter, i + 1 + nx*j) of the GLOBAL cell (generate_id,
    # icebergs_framework.F90:4165-4243): unique and the same on any layout
    id_cnt = calv.id_counter[Ic, Jc] + 1 + m_of * K + k_of
    gi = ci + grid.i_off if grid.i_off else ci
    gj = cj + grid.j_off if grid.j_off else cj
    id_ij = (gi + 1) + (grid.nxg or nx) * gj

    def put(field, value):
        return torch.where(reborn, value, field)

    zero = torch.zeros_like(lon_b)
    vals = dict(
        lon=lon_b, lat=lat_b, lon_old=lon_b, lat_old=lat_b,
        start_lon=lon_b, start_lat=lat_b, mass=imr, start_mass=imr,
        thickness=thr, width=Wr, length=Lr, mass_scaling=msr,
        heat_density=hdr, start_day=start_day,
        xi=torch.full_like(lon_b, 0.5), yj=torch.full_like(lon_b, 0.5))
    kw = {f: put(getattr(st, f), v) for f, v in vals.items()}
    for f in ("uvel", "vvel", "uvel_old", "vvel_old", "uvel_prev",
              "vvel_prev", "axn", "ayn", "bxn", "byn", "axn_fast",
              "ayn_fast", "bxn_fast", "byn_fast", "ang_vel", "ang_accel",
              "rot", "n_bonds", "mass_of_bits", "mass_of_fl_bits",
              "mass_of_fl_bergy_bits", "fl_k", "halo_berg", "static_berg",
              "sst", "sss", "cn", "hi", "od", "uo", "vo", "ui", "vi", "ua",
              "va", "ssh_x", "ssh_y"):
        kw[f] = put(getattr(st, f), zero)
    year = torch.zeros_like(ci) + current_year
    for f, v in (("ine", ci), ("jne", cj), ("start_year", year),
                 ("id_cnt", id_cnt), ("id_ij", id_ij),
                 ("conglom_id", torch.zeros_like(ci))):
        kw[f] = put(getattr(st, f), v.to(torch.int32))
    kw["bond_idx"] = torch.where(reborn[:, None], -1, st.bond_idx)
    kw["bond_broken"] = torch.where(reborn[:, None], 0, st.bond_broken)
    st = st.replace(alive=st.alive | reborn, **kw)

    # bucket bookkeeping: granted spawns per (cell, class)
    total_want = flat_want.sum(dtype=torch.int32)
    total_granted = granted.sum(dtype=torch.int32)
    g = granted.reshape(K, M, nx, ny).sum(1, dtype=torch.int32)
    grant_grid = torch.zeros((nx + 2, ny + 2, K), dtype=dtype, device=dev)
    grant_grid[1:-1, 1:-1, :] = g.permute(1, 2, 0).to(dtype)
    calved_mass = grant_grid * cap
    # the classes' heat summed in class order (XLA's sequential reduction
    # of the minor axis): the stored heat left is a small difference of
    # large numbers, so the order shows in it
    ch = calved_mass * hdens
    calved_heat = ch[:, :, 0]
    for k in range(1, K):
        calved_heat = calved_heat + ch[:, :, k]
    counter = calv.id_counter.clone()
    counter[1:-1, 1:-1] += g.sum(0, dtype=torch.int32)
    calv = calv.replace(stored_ice=calv.stored_ice - calved_mass,
                        stored_heat=calv.stored_heat - calved_heat,
                        id_counter=counter)
    if not cfg.old_interp_flds_order:
        st = interp_to_bergs(st, grid, frc, cfg)
    diag = dict(nbergs_calved=total_granted,
                spawn_overflow=total_want - total_granted,
                calving_to_bergs=calved_mass.sum(),
                heat_to_bergs=calved_heat.sum(),
                real_calving=divc(calved_mass, cfg.dt))
    return st, calv, diag

"""Footloose calving (Huth et al. 2022a): parents shed child bergs when
their underwater foot breaks off.

Counterpart of ``icebergs_tpu/footloose.py`` (``FootlooseDiags``,
``footloose_calving``, ``_spawn_children``, ``granted_to_parent``,
``delete_fully_fl_calved``, ``adjust_fl_berg_interactivity``; port of
``src/icebergs.F90:2501-2843, 6404-6574``).  Each eligible parent spawns
at most one child a step, standing for ``k`` bergs through its mass
scaling; the requests (one per slot) take dead slots through the
prefix-sum allocator (:func:`.state.allocate_slots`), and each reborn slot
reads its parent's values through the inverted grant.  fl_k is the state
machine: >= 0 the foot's accumulated area, -1 a newborn child (no
interactions), -2 an interactive child, -3 marked for deletion.

Randomness.  A child sits on one side of its parent, chosen by a uniform
on [0, 1) per parent.  The JAX package folds the berg id into a
``jax.random`` key; this package hashes it: :func:`id_hash_uniforms`
mixes (seed, step, stream, id_cnt, id_ij) with a 32-bit integer hash in
int64 torch arithmetic on the device (no host sync), so a child's place
depends on its parent's id and not on the slab's layout.  ``stream`` 0
draws for the new-berg children, 1 for the promotion of footloose bits.
Any other source plugs in as ``uniforms(stream, state) -> (N,) tensor``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from . import constants as C
from .config import IcebergsConfig
from .grid import (Grid, convert_from_grid_to_meters,
                   convert_from_meters_to_grid, pos_to_cell)
from .ops.accel import divc
from .ops.thermo import fl_bits_dimensions, rolling
from .state import allocate_slots


class FootlooseDiags(NamedTuple):
    nbergs_calved_fl: torch.Tensor
    fl_bits_src: torch.Tensor      # (nx+2, ny+2) kg/m2/s
    spawn_overflow: torch.Tensor
    # kg this step: fl bits promoted into a berg, and the fl bergy bits
    # moved with them into the new berg's bergy bits (the budget tables
    # need both to close per category)
    fl_to_berg_kg: Optional[torch.Tensor] = None
    flb_to_bergy_kg: Optional[torch.Tensor] = None


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer finaliser (xorshift-multiply); ``x`` an int64
    tensor or a Python int in [0, 2^32).  The multipliers are below 2^31,
    so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def id_hash_uniforms(seed: int, step: int) -> Callable:
    """The default footloose uniforms: ``uniforms(stream, st)`` gives each
    slot ``h(seed, step, stream, id_cnt, id_ij) / 2^24`` in [0, 1), h the
    top 24 bits of :func:`_mix32` chained over the five integers."""
    def uniforms(stream: int, st):
        h = _mix32(_mix32(_mix32(seed & _M32) ^ (step & _M32))
                   ^ (stream & _M32))
        x = _mix32(torch.bitwise_xor(st.id_cnt.to(torch.int64) & _M32, h))
        x = _mix32(torch.bitwise_xor(x, st.id_ij.to(torch.int64) & _M32))
        return (x >> 8).to(st.dtype) * (1.0 / 16777216.0)
    return uniforms


def _constants(cfg: IcebergsConfig):
    e1 = math.exp(0.25 * math.pi)
    drho = C.RHO_SEAWATER - cfg.rho_bergs
    sigmay = cfg.fl_strength * 1000.
    lfootparam = e1 * C.RHO_SEAWATER * sigmay / (
        6. * cfg.rho_bergs * C.GRAVITY * drho)
    l_c = math.pi / (2. * math.sqrt(2.))
    lw_c = 1. / (C.GRAVITY * C.RHO_SEAWATER)
    B_c = cfg.fl_youngs / (12. * (1. - 0.3 ** 2))
    return lfootparam, l_c, lw_c, B_c


def footloose_calving(st, grid: Grid, cfg: IcebergsConfig, *,
                      uniforms: Optional[Callable] = None,
                      current_year=0, current_yearday=0.):
    """Part 1 of the footloose mechanism: each eligible parent's k, its
    shrink, and its child (``fl_style="new_bergs"``) or its mass binned
    into footloose bits; then the bits above the threshold become a
    berg.  Returns ``(state, FootlooseDiags)``.  ``uniforms`` defaults to
    :func:`id_hash_uniforms` of (0, 0), as the JAX package's key defaults
    to ``PRNGKey(0)``."""
    dtype = st.dtype
    shape = (grid.nx + 2, grid.ny + 2)
    if not cfg.footloose:
        zi = torch.zeros((), dtype=torch.int32, device=st.device)
        return st, FootlooseDiags(zi, torch.zeros(shape, dtype=dtype,
                                                  device=st.device), zi)
    if uniforms is None:
        uniforms = id_hash_uniforms(0, 0)
    lfootparam, l_c, lw_c, B_c = _constants(cfg)
    T, W, L = st.thickness, st.width, st.length
    eligible = st.alive & (st.static_berg != 1.) & (st.fl_k >= 0.)
    if cfg.iceberg_bonds_on:
        # bonded footloose is not in the reference either
        # (icebergs.F90:2566 FATAL): unbonded bergs only
        eligible = eligible & (st.n_bonds == 0.)

    l_w = (lw_c * B_c * (T * T * T)) ** 0.25     # buoyancy length
    l_b = l_c * l_w                               # child berg width
    l_b3 = 3. * l_b
    # the largest k that leaves the parent its (Lmin, Wmin) residue
    lb3s = l_b3.clamp(min=1e-30)
    cL = torch.ceil((L - l_b3) / lb3s)
    Lmin = L - cL * l_b3
    cW = torch.ceil((W - l_b3) / lb3s)
    Wmin = W - cW * l_b3
    max_k = torch.floor((L * W - Lmin * Wmin)
                        / (l_b3 * l_b).clamp(min=1e-30)).clamp(min=0.)
    foot_l = lfootparam * T / l_w.clamp(min=1e-30)
    foot_area = (foot_l * l_b3).clamp(min=1e-30)
    k = torch.minimum(torch.floor(st.fl_k / foot_area), max_k)
    k = torch.where(eligible & (max_k > 0.), k, 0.)
    fl_k = torch.where(k > 0., st.fl_k - k * foot_area, st.fl_k)

    # the parent shrinks along its perimeter (cW > 0), else in length
    LpW = L + W
    disc = (LpW * LpW - 4. * (l_b3 * l_b * k)).clamp(min=0.)
    ds_perim = 0.5 * (LpW - torch.sqrt(disc))
    Ln_p = L - ds_perim
    Wn_p = W - ds_perim
    fix = Wn_p < Wmin
    Ln_p = torch.where(fix, Ln_p * (1. - (Wmin - Wn_p)
                                    / Wmin.clamp(min=1e-30)), Ln_p)
    Wn_p = torch.where(fix, Wmin, Wn_p)
    ds_len = k * 3. * (l_b * l_b) / W.clamp(min=1e-30)
    Ln = torch.where(cW > 0., Ln_p, L - ds_len)
    Wn = torch.where(cW > 0., Wn_p, W)
    dA = L * W - Ln * Wn
    calved = k > 0.
    dead = calved & ((Ln <= 0.) | (Wn <= 0.))
    fl_k = torch.where(dead, -3., fl_k)
    if cfg.allow_bergs_to_roll:
        Tr, Wr, Lr = rolling(cfg, T, Wn, Ln)
    else:
        Tr, Wr, Lr = T, Wn, Ln
    upd = calved & ~dead
    st = st.replace(
        thickness=torch.where(upd, Tr, st.thickness),
        width=torch.where(upd, Wr, st.width),
        length=torch.where(upd, Lr, st.length),
        mass=torch.where(upd, Lr * Wr * Tr * cfg.rho_bergs, st.mass),
        fl_k=torch.where(st.alive, fl_k, st.fl_k))

    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    area = grid.area[I, J].clamp(min=1e-30)
    src = torch.zeros(shape, dtype=dtype, device=st.device)
    zi = torch.zeros((), dtype=torch.int32, device=st.device)
    nspawned, overflow = zi, zi
    if cfg.fl_style == "new_bergs":
        st, ns, ov, _, _, _ = _spawn_children(
            st, grid, cfg, uniforms(0, st), calved, k, l_b, current_year,
            current_yearday, berg_from_bits=False)
        nspawned, overflow = nspawned + ns, overflow + ov
    else:
        dM = cfg.rho_bergs * T * dA
        st = st.replace(mass_of_fl_bits=torch.where(
            upd, st.mass_of_fl_bits + dM, st.mass_of_fl_bits))
        src = _add_at_cells(src, I, J, upd,
                            dM / (cfg.dt * area) * st.mass_scaling)

    # footloose bits above the threshold become a tracked berg
    thres = cfg.new_berg_from_fl_bits_mass_thres
    fls = st.mass_of_fl_bits * st.mass_scaling
    promote = st.alive & (fls > thres)
    kp = torch.floor(divc(fls, thres))
    st, ns, ov, to_berg_kg, to_bergy_kg, gp = _spawn_children(
        st, grid, cfg, uniforms(1, st), promote, kp, l_b, current_year,
        current_yearday, berg_from_bits=True)
    nspawned, overflow = nspawned + ns, overflow + ov
    # only granted promotions leave the footloose pool
    src = _add_at_cells(src, I, J, gp, -kp * thres / (cfg.dt * area))
    return st, FootlooseDiags(nbergs_calved_fl=nspawned, fl_bits_src=src,
                              spawn_overflow=overflow,
                              fl_to_berg_kg=to_berg_kg,
                              flb_to_bergy_kg=to_bergy_kg)


def _add_at_cells(src, I, J, mask, vals):
    """``src[I, J] += vals`` over the rows of ``mask``, in row order (the
    sort-based accumulation of ``index_put``).  The other rows go to
    sinks of their own past the grid, which are cut off: routed to their
    cells as zeros, the dead slots (all at cell (0, 0)) made one run of
    ~N additions that the card sums serially (22.9 ms a call on an H100
    for a 2^19-slot tile with ~270k dead slots); a +0 added to a nonzero
    partial sum leaves its bits, so the cells' sums are the same."""
    n_cells, n = src.numel(), I.shape[0]
    key = torch.where(mask, I * src.shape[1] + J,
                      n_cells + torch.arange(n, device=I.device))
    flat = torch.cat([src.reshape(-1), src.new_zeros(n)]).index_put_(
        (key,), torch.where(mask, vals, 0.), accumulate=True)
    return flat[:n_cells].view(src.shape)


def granted_to_parent(granted, want):
    """Parents whose spawn request was granted (requests are per slot)."""
    return granted & want


def _spawn_children(st, grid: Grid, cfg: IcebergsConfig, rn, want, k, l_b,
                    current_year, current_yearday, *, berg_from_bits):
    """Child bergs in free slots (calve_fl_icebergs), one request per
    parent slot; ``rn`` the parents' uniforms.  Returns ``(state,
    nspawned, overflow, to_berg_kg, to_bergy_kg, granted_parents)``."""
    dtype = st.dtype
    N = st.capacity
    dev = st.device
    # halo replicas never spawn (the owner does)
    want = want & (st.halo_berg < 0.5)
    granted, slots = allocate_slots(st.alive, want)
    gp = granted_to_parent(granted, want)

    # a random place along one of the parent's sides
    if not cfg.displace_fl_bergs:
        disp_x = disp_y = torch.zeros_like(rn)
    else:
        Lp, Wp = st.length, st.width
        side = torch.floor(rn * 4.).to(torch.int32)
        t = rn * 4. - side.to(dtype)
        disp_x = torch.where(side == 0, Lp * (t - 0.5), torch.where(
            side == 1, 0.5 * Lp, torch.where(side == 2, Lp * (t - 0.5),
                                             -0.5 * Lp)))
        disp_y = torch.where(side == 0, 0.5 * Wp, torch.where(
            side == 1, Wp * (t - 0.5), torch.where(side == 2, -0.5 * Wp,
                                                   0.5 * Wp * (t - 0.5))))
        dxdl, dydl = convert_from_meters_to_grid(st.lat, cfg.grid_is_latlon,
                                                 cfg.Rearth)
        disp_x = disp_x * dxdl
        disp_y = disp_y * dydl
    lon_c = st.lon + disp_x
    lat_c = st.lat + disp_y
    ci, cj, cxi, cyj = pos_to_cell(grid, lon_c, lat_c,
                                   cfg.Lx if cfg.grid_is_latlon else -1.)
    # a child displaced into a dead (area 0) cell stays on its parent
    bad = grid.area[(ci + 1).long(), (cj + 1).long()] <= 0.
    lon_c = torch.where(bad, st.lon, lon_c)
    lat_c = torch.where(bad, st.lat, lat_c)
    ci = torch.where(bad, st.ine, ci)
    cj = torch.where(bad, st.jne, cj)
    cxi = torch.where(bad, st.xi, cxi)
    cyj = torch.where(bad, st.yj, cyj)
    disp_x = torch.where(bad, 0., disp_x)
    disp_y = torch.where(bad, 0., disp_y)

    if berg_from_bits:
        thres = cfg.new_berg_from_fl_bits_mass_thres
        Lfl, Wfl, Tfl = fl_bits_dimensions(cfg, st.thickness)
        c_len, c_wid, c_thk = Lfl, Wfl, Tfl
        c_mass = Tfl * Lfl * Wfl * cfg.rho_bergs
        c_scal = k * thres / c_mass.clamp(min=1e-30)
        pct = (c_mass * c_scal) / (st.mass_of_fl_bits
                                   * st.mass_scaling).clamp(min=1e-30)
        c_bits = (pct * st.mass_of_fl_bergy_bits * st.mass_scaling) \
            / c_scal.clamp(min=1e-30)
        to_berg_kg = torch.where(gp, k * thres, 0.).sum()
        to_bergy_kg = torch.where(
            gp, pct * st.mass_of_fl_bergy_bits * st.mass_scaling, 0.).sum()
        st = st.replace(
            mass_of_fl_bergy_bits=torch.where(
                gp, (1. - pct) * st.mass_of_fl_bergy_bits,
                st.mass_of_fl_bergy_bits),
            mass_of_fl_bits=torch.where(
                gp, st.mass_of_fl_bits
                - k * thres / st.mass_scaling.clamp(min=1e-30),
                st.mass_of_fl_bits))
    else:
        c_len = l_b * 3.
        c_wid = l_b
        c_thk = st.thickness
        c_mass = c_wid * c_len * c_thk * cfg.rho_bergs
        c_scal = st.mass_scaling * k
        c_bits = torch.zeros_like(c_mass)
        to_berg_kg = to_bergy_kg = torch.zeros((), dtype=dtype, device=dev)

    # invert the grant: each reborn slot's parent
    tgt = torch.where(granted, slots, N).long()
    par = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    par.index_copy_(0, tgt, torch.arange(N, device=dev))
    reborn = par[:N] >= 0
    p = par[:N].clamp(min=0)

    def put(field, value):
        return torch.where(reborn, value[p], field)

    zero = torch.zeros_like(lon_c)
    # child id: the parent's id offset by its running child count (the
    # parent stays traceable from the child's id)
    child_no = 1. + st.fl_spawn_count
    vals = dict(
        lon=lon_c, lat=lat_c, start_lon=lon_c, start_lat=lat_c,
        lon_old=st.lon_old + disp_x, lat_old=st.lat_old + disp_y,
        xi=cxi, yj=cyj, length=c_len, width=c_wid, thickness=c_thk,
        mass=c_mass, mass_scaling=c_scal, mass_of_bits=c_bits,
        mass_of_fl_bits=zero, mass_of_fl_bergy_bits=zero, fl_k=zero - 1.0,
        halo_berg=zero, start_day=torch.zeros_like(lon_c) + current_yearday,
        ang_vel=zero, ang_accel=zero, rot=zero, n_bonds=zero,
        fl_spawn_count=zero,
        ine=ci, jne=cj,
        start_year=torch.zeros_like(ci) + current_year,
        id_cnt=st.id_cnt + (100000. * child_no).to(torch.int32))
    for f in ("start_mass", "uvel", "vvel", "axn", "ayn", "bxn", "byn",
              "uvel_prev", "vvel_prev", "uvel_old", "vvel_old",
              "heat_density", "static_berg", "uo", "vo", "ui", "vi", "ua",
              "va", "ssh_x", "ssh_y", "sst", "sss", "cn", "hi", "od",
              "axn_fast", "ayn_fast", "bxn_fast", "byn_fast", "id_ij",
              "conglom_id"):
        vals[f] = getattr(st, f)
    kw = {}
    for f, v in vals.items():
        old = getattr(st, f)
        kw[f] = put(old, v.to(old.dtype))
    kw["bond_idx"] = torch.where(reborn[:, None], -1, st.bond_idx)
    kw["bond_broken"] = torch.where(reborn[:, None], 0, st.bond_broken)
    # the parents count their children (after the children were placed)
    kw["fl_spawn_count"] = kw["fl_spawn_count"] + torch.where(
        gp & ~reborn, 1., 0.)
    st = st.replace(alive=st.alive | reborn, **kw)
    return (st, granted.sum(dtype=torch.int32),
            (want & ~granted).sum(dtype=torch.int32), to_berg_kg,
            to_bergy_kg, gp)


def delete_fully_fl_calved(st):
    """Remove the bergs marked fl_k == -3 (edge elements fully calved);
    returns ``(state, count)``."""
    kill = st.alive & (st.fl_k == -3.)
    return st.replace(alive=st.alive & ~kill), kill.sum(dtype=torch.int32)


def adjust_fl_berg_interactivity(st, nbr, cfg: IcebergsConfig):
    """Promote fl_k == -1 children to -2 once no candidate of ``nbr`` is
    within contact range (adjust_fl_berg_interactivity,
    icebergs.F90:2765)."""
    other = nbr.cand_idx.long()
    if cfg.hexagonal_icebergs:
        rdenom = 1. / (2. * math.sqrt(3.))
    elif cfg.iceberg_bonds_on:
        rdenom = 0.25
    else:
        rdenom = 1. / C.PI
    R1 = torch.sqrt(st.length * st.width * rdenom)[:, None]
    R2 = torch.sqrt(st.length[other] * st.width[other] * rdenom)
    crit = (R1 + R2).clamp(min=cfg.contact_distance)
    crit = crit * crit
    lat_ref = 0.5 * (st.lat[:, None] + st.lat[other])
    dx_dlon, dy_dlat = convert_from_grid_to_meters(
        lat_ref, cfg.grid_is_latlon, cfg.Rearth)
    rx = (st.lon[other] - st.lon[:, None]) * dx_dlon
    ry = (st.lat[other] - st.lat[:, None]) * dy_dlat
    contact = (nbr.cand_valid & (rx * rx + ry * ry < crit)).any(dim=1)
    promote = st.alive & (st.fl_k == -1.) & ~contact
    return st.replace(fl_k=torch.where(promote, -2., st.fl_k))

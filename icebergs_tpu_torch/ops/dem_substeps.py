"""K4: the MTS Part-3 substep loop of bonded DEM conglomerates.

Counterpart of ``icebergs_tpu/ops/dem_vmem.py`` (``analyze_bond_deltas``,
``pack_conglomerates_blocked``, ``supports_vmem_substeps``,
``part3_substeps_vmem``).  For the iKID flag set (``dem``, explicit inner
substeps, ``use_broken_bonds_for_substep_contact``) every fast substep is
closed under conglomerates: bond forces (icebergs.F90:957-1242, with the
stress fracture of 1140-1199) and broken-bond contact (806-956 via
1789-1792) reach partners through ``bond_idx`` only.  With the
:func:`pack_conglomerates_blocked` layout no conglomerate straddles a
block of ``block_n`` slots, so all ``n_sub_steps`` substeps run per block
in one launch of ``csrc/dem_substeps.cu``: one CTA per block, one thread
per element, partners read from shared memory.  The kernel has four
instantiations (:func:`instantiation`): three compiled for 6 bond slots
and one flag set each (``tools/bench_dem_1m.py``'s, :data:`DEM_FLAGS`;
the same on a lat-lon grid; the same with hexagonal elements), and a
generic one that reads the flags and the slot count at run time, all
built for two 512-thread CTAs per SM.  On a lat-lon grid (the flag
``F_LATLON``) the substep drift moves positions in degrees and each bond
and contact is measured through the metric factors at the pair's mean
latitude (``dem_vmem.py:240-246, 422-428, 474-476``).

:func:`part3_substeps_plain` is the same function in plain PyTorch
(partners gathered by index, a Python loop over substeps); CPU tensors
take it, CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import re

import numpy as np
import torch

from .. import constants as C
from .. import cuda_build
from ..config import IcebergsConfig
from ..grid import pair_separation
from .accel import rdiv
from .dem import _HEXDENOM, dem_K_damp, grounding_drag_coeff, tdiv

MAX_DELTAS = 8
_SENT = -(10 ** 8)
MAX_BLOCK = 512            # threads per CTA of the kernel
MAX_SLOTS = 8              # most bond slots (max_bonds) the kernel takes

_CAR_FIELDS = ("lon", "lat", "lon_old", "lat_old", "uvel", "vvel",
               "uvel_old", "vvel_old", "axn_fast", "ayn_fast",
               "bxn_fast", "byn_fast", "ang_vel", "ang_accel", "rot")
_BOND_FIELDS = ("bond_length", "bond_tangd1", "bond_tangd2",
                "bond_rel_rotation", "bond_nstress", "bond_sstress")


# --------------------------------------------------------------------------
# host-side layout analysis / preparation
# --------------------------------------------------------------------------

def analyze_bond_deltas(bond_idx, block_n: int,
                        max_deltas: int = MAX_DELTAS):
    """Distinct ``bond_idx - i`` values if the topology is block-closed:
    a sorted tuple, or ``None`` when some bond crosses a ``block_n``
    boundary or there are more than ``max_deltas`` deltas."""
    bi = (bond_idx.cpu().numpy() if torch.is_tensor(bond_idx)
          else np.asarray(bond_idx))
    n = bi.shape[0]
    if n % block_n or block_n % 128:
        return None
    i = np.broadcast_to(np.arange(n)[:, None], bi.shape)
    valid = bi >= 0
    if not valid.any():
        return ()
    if ((bi[valid] // block_n) != (i[valid] // block_n)).any():
        return None
    deltas = np.unique((bi - i)[valid])
    if deltas.size > max_deltas or (np.abs(deltas) >= block_n).any():
        return None
    return tuple(int(d) for d in deltas)


def _groups(cong, alive, bonded):
    """Contiguous runs of one conglomerate id starting at a bonded slot
    (never split), and single live unbonded slots (splittable), in slot
    order: ``[(start, length, splittable)]``."""
    n = cong.shape[0]
    new_run = np.r_[True, cong[1:] != cong[:-1]]
    run_end = np.r_[np.flatnonzero(new_run)[1:], n][np.cumsum(new_run) - 1]
    busy = np.flatnonzero(alive | bonded)
    groups = []
    i = 0
    while True:
        k = np.searchsorted(busy, i)
        if k == busy.size:
            return groups
        i = int(busy[k])
        if bonded[i] and cong[i] != 0:
            groups.append((i, int(run_end[i]) - i, False))
            i = int(run_end[i])
        else:
            groups.append((i, 1, True))
            i += 1


def pack_conglomerates_blocked(st, block_n: int = 512):
    """Relayout a state so no conglomerate straddles a block boundary:
    first-fit packing of conglomerate runs (and of single unbonded
    bergs, which split freely) into ``block_n``-slot blocks, the rest of
    each block dead.  Host side, once at init; returns the permuted state
    (capacity = blocks x ``block_n``) on the state's device, slot for slot
    the layout of the JAX function."""
    n = st.capacity
    cong = st.conglom_id.cpu().numpy()
    alive = st.alive.cpu().numpy()
    bi = st.bond_idx.cpu().numpy()

    blocks = [[]]                       # per block: [(start, length)]
    room = block_n
    for start, length, splittable in _groups(cong, alive,
                                             (bi >= 0).any(axis=1)):
        if length > block_n and not splittable:
            raise ValueError(f"conglomerate of {length} elements exceeds "
                             f"block_n={block_n}")
        if length > room and not splittable:
            blocks.append([])
            room = block_n
        while length:
            take = min(length, room) if splittable else length
            blocks[-1].append((start, take))
            start += take
            length -= take
            room -= take
            if room == 0:
                blocks.append([])
                room = block_n
    if not blocks[-1]:
        blocks.pop()

    cap = len(blocks) * block_n
    perm = np.full(cap, -1, np.int64)          # new slot -> old slot
    for b, members in enumerate(blocks):
        pos = b * block_n
        for start, length in members:
            perm[pos:pos + length] = np.arange(start, start + length)
            pos += length
    filled = perm >= 0
    old2new = np.full(n, -1, np.int64)
    old2new[perm[filled]] = np.nonzero(filled)[0]

    def take(a):
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[filled] = a[perm[filled]]
        return out

    kw = {f.name: torch.as_tensor(take(getattr(st, f.name).cpu().numpy()))
          for f in dataclasses.fields(st)}
    new_bi = take(bi)
    new_bi[~filled] = -1                 # a zero pad would alias slot 0
    kw["bond_idx"] = torch.as_tensor(np.where(
        new_bi >= 0, old2new[np.maximum(new_bi, 0)], -1).astype(np.int32))
    return type(st)(**{k: v.to(st.device) for k, v in kw.items()})


def supports_vmem_substeps(cfg: IcebergsConfig) -> bool:
    """Static flag-set check (the topology check is separate)."""
    return bool(cfg.dem and cfg.use_broken_bonds_for_substep_contact
                and (not cfg.break_bonds_on_sub_steps
                     or cfg.fracture_criterion == 'stress'))


# --------------------------------------------------------------------------
# scalars and flags shared by the kernel and its plain version
# --------------------------------------------------------------------------

_F_CONST_LW, _F_HEX, _F_BONDS, _F_BREAK_SUB = 1, 2, 4, 8
_F_SHORT_GROUND, _F_GROUND_TORQUE, _F_ORIG_MOI = 16, 32, 64
_F_IGNORE_TANG, _F_PMAG, _F_LATLON = 128, 256, 512
# the flag set of tools/bench_dem_1m.py; it, the same on a lat-lon grid
# and the same with hexagonal elements have instantiations of their own
DEM_FLAGS = _F_CONST_LW | _F_BONDS | _F_BREAK_SUB | _F_PMAG
COMPILED_FLAGS = {"dem": DEM_FLAGS, "dem_ll": DEM_FLAGS | _F_LATLON,
                  "dem_hex": DEM_FLAGS | _F_HEX}
COMPILED_SLOTS = 6
_VARIANTS = {"generic": 0, "dem": 1, "dem_ll": 2, "dem_hex": 3}


def _params(cfg: IcebergsConfig):
    """The kernel's scalars as the JAX kernel's weak-typed Python values
    (each rounded once to float32 where it meets an array)."""
    cs = cfg.spring_coef
    if cfg.critical_interaction_damping_on:
        rad = 2. * math.sqrt(cs)
        tan = ((2. * math.sqrt(cs)) / 4. if cfg.tang_crit_int_damp_on
               else cfg.tangental_damping_coef)
    else:
        rad, tan = cfg.radial_damping_coef, cfg.tangental_damping_coef
    A0c = cfg.constant_length * cfg.constant_width
    hexa = cfg.hexagonal_icebergs
    R0c = math.sqrt(A0c * _HEXDENOM) if hexa else 0.5 * math.sqrt(A0c)
    if hexa:
        R0contact = math.sqrt(A0c * _HEXDENOM)
    elif cfg.iceberg_bonds_on:
        R0contact = 0.5 * math.sqrt(A0c)
    else:
        R0contact = math.sqrt(A0c / C.PI)
    f32 = np.float32
    dtf = cfg.dt / max(cfg.n_sub_steps, 1)
    return dict(
        dtf=dtf, dtf2=0.5 * dtf, kspring=cfg.dem_spring_coef,
        poisson1=1.0 + cfg.poisson,
        tn=cfg.frac_thres_n * cfg.frac_thres_scaling,
        tt=cfg.frac_thres_t * cfg.frac_thres_scaling, cs=cs,
        rad_damp=rad, tan_damp=tan, dem_damp=cfg.dem_damping_coef,
        K=dem_K_damp(cfg), A0c=A0c, R0c=R0c, l0c=2. * R0c,
        R0contact=R0contact, rho=cfg.rho_bergs, hexdenom=_HEXDENOM,
        pi=C.PI, two_sqrt3=float(f32(2.) * np.sqrt(f32(3.))),
        rho_ratio=cfg.rho_bergs / C.RHO_SEAWATER,
        h_ground=cfg.h_to_init_grounding, neg_cdrag=-cfg.cdrag_grounding,
        two_thirds=2. / 3.,
        # the lat-lon metric: PI_180 Rearth and its reciprocal folded in
        # double (dem_vmem.py:241-243, 422-424), PI_180
        kpr=C.PI_180 * cfg.Rearth, inv_kpr=1. / (C.PI_180 * cfg.Rearth),
        pi180=C.PI_180)


def _flags(cfg: IcebergsConfig) -> int:
    return sum(bit for bit, on in (
        (_F_CONST_LW, cfg.constant_interaction_LW),
        (_F_HEX, cfg.hexagonal_icebergs), (_F_BONDS, cfg.iceberg_bonds_on),
        (_F_BREAK_SUB, cfg.break_bonds_on_sub_steps),
        (_F_SHORT_GROUND, cfg.short_step_mts_grounding),
        (_F_GROUND_TORQUE, cfg.use_grounding_torque),
        (_F_ORIG_MOI, cfg.orig_dem_moment_of_inertia),
        (_F_IGNORE_TANG, cfg.ignore_tangential_force),
        (_F_PMAG, cfg.scale_damping_by_pmag),
        (_F_LATLON, cfg.grid_is_latlon)) if on)


def _check(st, cfg: IcebergsConfig, deltas, block_n: int):
    if not supports_vmem_substeps(cfg):
        raise ValueError("substep kernel: unsupported flag set")
    if not deltas:
        raise ValueError("empty delta set: no bonds (run the scan "
                         "substeps)")
    if len(deltas) > MAX_DELTAS:
        raise ValueError(f"{len(deltas)} deltas > {MAX_DELTAS}")
    if st.capacity % block_n or block_n % 128:
        raise ValueError(f"capacity {st.capacity} / block_n {block_n}: "
                         "need capacity % block_n == 0 == block_n % 128")
    if st.dtype != torch.float32:
        raise TypeError(f"state dtype {st.dtype}: need float32")


def _finish(st, car, broken, bonds):
    """State update, newly broken bonds and ``n_bonds``
    (``dem_vmem.py:754-770``): broken lanes never unbreak and
    non-moving rows never update, so the before/after difference is the
    per-substep total."""
    nbroken = ((broken == 1) & (st.bond_broken != 1)).sum(dtype=torch.int32)
    kw = dict(zip(_CAR_FIELDS, car))
    kw.update(zip(_BOND_FIELDS, bonds))
    kw["bond_broken"] = broken.to(st.bond_broken.dtype)
    st = st.replace(**kw)
    n_bonds = ((st.bond_idx >= 0) & (st.bond_broken != 1)).sum(dim=1)
    return st.replace(n_bonds=n_bonds.to(st.dtype)), nbroken


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def part3_substeps_plain(st, cfg: IcebergsConfig, deltas,
                         block_n: int = 512):
    """All ``cfg.n_sub_steps`` fast substeps in plain PyTorch, expression
    for expression the kernel's (``dem_vmem._make_kernel``), vectorized
    over elements and bond slots, summed over slots in slot order.
    Returns ``(state, nbroken)``."""
    _check(st, cfg, deltas, block_n)
    p_ = _params(cfg)
    dtf, dtf2, kspring = p_["dtf"], p_["dtf2"], p_["kspring"]
    N, B = st.capacity, st.max_bonds
    dev = st.device

    # static topology: slot b of element i reads element p[i, b] of its
    # block when its delta is in the host-verified set (the TPU kernel's
    # roll partner); other slots read zeros
    i = torch.arange(N, device=dev)
    bidx = st.bond_idx.long()
    d = torch.where(bidx >= 0, bidx - i[:, None], _SENT)
    has = torch.zeros_like(bidx, dtype=torch.bool)
    for q in deltas:
        has = has | (d == q)
    t = i % block_n
    p = (i - t)[:, None] + torch.remainder(t[:, None] + d, block_n)
    p = torch.where(has, p, i[:, None])

    def partner(x):
        return torch.where(has, x[p], torch.zeros((), dtype=x.dtype,
                                                  device=dev))

    alive = st.alive
    mv = alive & (st.static_berg < 0.5)
    thick, mass, flk = st.thickness, st.mass, st.fl_k
    length, width = st.length, st.width
    thick2, flk2, mass2 = partner(thick), partner(flk), partner(mass)
    vstat = (has & alive[:, None] & partner(alive)
             & (flk != -1.)[:, None] & (flk2 != -1.))

    def radius_bond(A):
        if cfg.hexagonal_icebergs:
            return torch.sqrt(A * _HEXDENOM)
        return 0.5 * torch.sqrt(A)

    def radius_contact(A):
        if cfg.hexagonal_icebergs or cfg.iceberg_bonds_on:
            return radius_bond(A)
        return torch.sqrt(tdiv(A, C.PI))

    def full(like, v):
        return torch.full_like(like, v)

    if cfg.constant_interaction_LW:
        A0c = p_["A0c"]
        R1b, R2b = full(thick, p_["R0c"]), full(thick2, p_["R0c"])
        M1b = A0c * thick * p_["rho"]
        M2b = A0c * thick2 * p_["rho"]
        Rminb, TRminb, l0b = R2b, thick2, full(thick2, p_["l0c"])
        R1c, R2c = full(thick, p_["R0contact"]), full(thick2,
                                                     p_["R0contact"])
        M1c, M2c = M1b, M2b
        A0self = full(thick, A0c)
    else:
        A1 = length * width
        R1b, M1b = radius_bond(A1), mass
        A2 = partner(length) * partner(width)
        R2b, M2b = radius_bond(A2), mass2
        fs = R1b[:, None] < R2b
        Rminb = torch.where(fs, R1b[:, None], R2b)
        TRminb = torch.where(fs, thick[:, None], thick2)
        l0b = R1b[:, None] + R2b
        R1c, R2c = radius_contact(A1), radius_contact(A2)
        M1c, M2c = mass, mass2
        A0self = A1
    if cfg.hexagonal_icebergs:
        R1moi = torch.sqrt(tdiv(A0self, p_["two_sqrt3"]))
    else:
        R1moi = 0.5 * torch.sqrt(A0self)
    Mself = M1b
    dampb = p_["dem_damp"] * torch.sqrt(
        p_["K"] * M1b[:, None] * M2b / (M1b[:, None] + M2b))
    absdR = (R1b[:, None] - R2b).abs()
    dT = (thick[:, None] - thick2).abs()
    crit = R1c[:, None] + R2c
    M_min = torch.minimum(M1c[:, None], M2c)
    mratio = M_min / M1c[:, None]
    gdrag_rect = gdrag_disk = None
    if cfg.short_step_mts_grounding:
        gdrag_rect = grounding_drag_coeff(cfg, thick, st.od, mass, length,
                                          width, "rect")
    if cfg.use_grounding_torque:
        gdrag_disk = grounding_drag_coeff(cfg, thick, st.od, mass, length,
                                          width, "disk")

    (lon, lat, lon_o, lat_o, u, v, u_o, v_o, axf, ayf, bxf, byf, angv,
     anga, rot) = (getattr(st, f) for f in _CAR_FIELDS)
    bbrok = st.bond_broken
    blen, bt1, bt2, brr, bns, bss = (getattr(st, f) for f in _BOND_FIELDS)
    mvb = mv[:, None]
    latlon = cfg.grid_is_latlon

    for _ in range(cfg.n_sub_steps):
        # drift (icebergs.F90:6790-6831), in degrees on a lat-lon grid
        uvel2 = u + dtf2 * (axf + bxf)
        vvel2 = v + dtf2 * (ayf + byf)
        if latlon:
            dxdl = rdiv(1., torch.cos(lat * p_["pi180"]) * p_["kpr"])
            lonn = lon + dtf * uvel2 * dxdl
            latn = lat + dtf * vvel2 * p_["inv_kpr"]
        else:
            lonn = lon + dtf * uvel2
            latn = lat + dtf * vvel2
        lon = torch.where(mv, lonn, lon)
        lat = torch.where(mv, latn, lat)
        lon_o = torch.where(mv, lonn, lon_o)
        lat_o = torch.where(mv, latn, lat_o)
        # u_old <- u*; the v component uses bxf (bug-compat, 6826-6827)
        u_o = torch.where(mv, u + dtf2 * (axf + bxf), u_o)
        v_o = torch.where(mv, v + dtf2 * (ayf + bxf), v_o)
        uvel3 = u + dtf2 * (axf + bxf)
        vvel3 = v + dtf2 * (ayf + byf)

        lon2, lat2 = partner(lon_o), partner(lat_o)
        uo2, vo2 = partner(u_o), partner(v_o)
        av2, rt2 = partner(angv), partner(rot)
        valid = vstat & (bbrok != 1)

        # ---- bond (calculate_force_dem) ----
        rx, ry = pair_separation(lon_o[:, None], lat_o[:, None], lon2, lat2,
                                 latlon, cfg.Rearth)
        blength = torch.sqrt(rx * rx + ry * ry)
        lsafe = torch.where(blength > 0., blength, 1.)
        n1 = rx / lsafe
        n2 = ry / lsafe
        half_delta = 0.5 * (l0b - blength)
        RR1 = R1b[:, None] - half_delta
        RR2 = R2b - half_delta
        RR1x, RR1y = RR1 * n1, RR1 * n2
        RR2x, RR2y = RR2 * n1, RR2 * n2
        L = 2.0 * (Rminb + (Rminb - half_delta) * absdR / lsafe)
        Thick = TRminb + (Rminb - half_delta) * dT / lsafe
        Fn_mag = kspring * Thick * 2. * half_delta * L / l0b
        Fn_x, Fn_y = Fn_mag * n1, Fn_mag * n2
        ur = u_o[:, None] - uo2
        vr = v_o[:, None] - vo2

        tmag = bt1 * bt1 + bt2 * bt2
        tdotn = bt1 * n1 + bt2 * n2
        t1p = bt1 - tdotn * n1
        t2p = bt2 - tdotn * n2
        tmagp = t1p * t1p + t2p * t2p
        pos = tmagp > 0.
        t_rat = torch.where(pos, torch.sqrt(
            tmag / torch.where(pos, tmagp, 1.)), 0.)
        t1p = t_rat * t1p
        t2p = t_rat * t2p

        rotu = RR1y * angv[:, None] + RR2y * av2
        rotv = -(RR1x * angv[:, None] + RR2x * av2)
        ur2 = ur + rotu
        vr2 = vr + rotv
        upmag = ur2 * n1 + vr2 * n2
        tangd1 = t1p + (ur2 - upmag * n1) * dtf
        tangd2 = t2p + (vr2 - upmag * n2) * dtf

        if cfg.ignore_tangential_force:
            ss_factor = torch.zeros_like(L)
        else:
            ss_factor = -L * Thick * kspring / (l0b * 2.0 * p_["poisson1"])
        Fs_x = ss_factor * tangd1
        Fs_y = ss_factor * tangd2
        sstress = torch.sqrt(Fs_x * Fs_x + Fs_y * Fs_y) \
            / (L * Thick).clamp(min=1e-30)
        Ts = -(RR1x * Fs_y - RR1y * Fs_x)
        rel_rotation = brr + (angv[:, None] - av2) * dtf

        if not cfg.orig_dem_moment_of_inertia:
            theta = torch.sin(rot[:, None] - rt2)
            Tr = -kspring * (L * (L * L)) * Thick * theta / (12. * l0b)
        else:
            theta = rot[:, None] - rt2
            hl = 0.5 * L
            Tr = -rdiv(kspring, l0b) * p_["two_thirds"] \
                * (hl * (hl * hl)) * Thick * theta
        nstress = rdiv(kspring, l0b) * (-2. * half_delta
                                        + (theta * 0.5 * L).abs())
        dw = angv[:, None] - av2

        if cfg.break_bonds_on_sub_steps:
            breaking = valid & ((nstress > p_["tn"]) | (sstress > p_["tt"]))
            broken_new = torch.where(breaking, 1, bbrok)
            w = torch.where(valid & ~breaking, 1., 0.)
            wc = torch.where(breaking & (nstress < 0.), 1., 0.)
            wd = w + wc
            cx, cy = wc * Fn_x, wc * Fn_y
        else:
            broken_new = bbrok
            w = wd = torch.where(valid, 1., 0.)
            cx = cy = None
        fx = w * (Fn_x + Fs_x)
        fy = w * (Fn_y + Fs_y)
        tq = w * (Ts + Tr)
        dx = wd * (-dampb * ur)
        dy = wd * (-dampb * vr)
        td = w * (-dampb * dw)

        # ---- broken-bond contact (806-956 via 1789-1792) ----
        active = vstat & (bbrok == 1) & (blength > 0.) & (blength < crit)
        accel_spring = p_["cs"] * mratio * (crit - blength)
        af = torch.where(active, 1., 0.)
        kx = af * accel_spring * rx / lsafe
        ky = af * accel_spring * ry / lsafe
        rs2 = lsafe * lsafe
        P11 = (rx * rx) / rs2
        P12 = (rx * ry) / rs2
        P22 = (ry * ry) / rs2
        durel = uo2 - u_o[:, None]
        dvrel = vo2 - v_o[:, None]
        crad = p_["rad_damp"] * mratio
        ctan = p_["tan_damp"] * mratio
        if cfg.scale_damping_by_pmag:
            du = uo2 - u[:, None]
            dv = vo2 - v[:, None]

            def mag(Pa, Pb, Pc):
                q1 = Pa * du + Pb * dv
                q2 = Pb * du + Pc * dv
                return torch.sqrt(q1 * q1 + q2 * q2)
            crad = crad * mag(P11, P12, P22)
            ctan = ctan * mag(1. - P11, -P12, 1. - P22)
        Pd11 = crad * P11 + ctan * (1. - P11)
        Pd12 = crad * P12 + ctan * (-P12)
        Pd22 = crad * P22 + ctan * (1. - P22)
        kdx = af * (Pd11 * durel + Pd12 * dvrel)
        kdy = af * (Pd12 * durel + Pd22 * dvrel)

        zero = torch.zeros_like(u)
        F_x = F_y = T = Fd_x = Fd_y = T_d = zero
        cIA_x = cIA_y = cIAd_x = cIAd_y = zero
        for b in range(B):               # the kernel's slot order
            F_x = F_x + fx[:, b]
            F_y = F_y + fy[:, b]
            if cx is not None:
                F_x = F_x + cx[:, b]
                F_y = F_y + cy[:, b]
            T = T + tq[:, b]
            Fd_x = Fd_x + dx[:, b]
            Fd_y = Fd_y + dy[:, b]
            T_d = T_d + td[:, b]
            cIA_x = cIA_x + kx[:, b]
            cIA_y = cIA_y + ky[:, b]
            cIAd_x = cIAd_x + kdx[:, b]
            cIAd_y = cIAd_y + kdy[:, b]

        bbrok = torch.where(mvb, broken_new, bbrok)
        keep = mvb & valid
        blen = torch.where(keep, blength, blen)
        bt1 = torch.where(keep, tangd1, bt1)
        bt2 = torch.where(keep, tangd2, bt2)
        brr = torch.where(keep, rel_rotation, brr)
        bns = torch.where(keep, nstress, bns)
        bss = torch.where(keep, sstress, bss)

        # ---- assemble accelerations (_substep_forces) and kick ----
        IA_x = cIA_x + F_x / Mself
        IA_y = cIA_y + F_y / Mself
        IAd_x = cIAd_x + Fd_x / Mself
        IAd_y = cIAd_y + Fd_y / Mself
        ang_accel = (T + T_d) / (0.5 * Mself * (R1moi * R1moi))
        axn = IA_x + IAd_x
        ayn = IA_y + IAd_y
        if gdrag_rect is not None:
            axn = axn + u * gdrag_rect
            ayn = ayn + v * gdrag_rect
        uveln = uvel3 + dtf * (0.5 * axn)
        vveln = vvel3 + dtf * (0.5 * ayn)
        axf = torch.where(mv, axn, axf)
        ayf = torch.where(mv, ayn, ayf)
        bxf = torch.where(mv, 0., bxf)
        byf = torch.where(mv, 0., byf)
        u = torch.where(mv, uveln, u)
        v = torch.where(mv, vveln, v)
        u_o = torch.where(mv, uveln, u_o)
        v_o = torch.where(mv, vveln, v_o)
        anga = torch.where(mv, ang_accel, anga)

        # angular kick (icebergs.F90:6986-7034)
        av = angv + dtf * anga
        if gdrag_disk is not None:
            av = av / (1. - gdrag_disk * dtf)
        angv = torch.where(mv, av, angv)
        rot = torch.where(mv, rot + dtf * av, rot)

    car = (lon, lat, lon_o, lat_o, u, v, u_o, v_o, axf, ayf, bxf, byf,
           angv, anga, rot)
    return _finish(st, car, bbrok, (blen, bt1, bt2, brr, bns, bss))


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_PARAM_ORDER = ("dtf", "dtf2", "kspring", "poisson1", "tn", "tt", "cs",
                "rad_damp", "tan_damp", "dem_damp", "K", "A0c", "R0c", "l0c",
                "R0contact", "rho", "hexdenom", "pi", "two_sqrt3",
                "rho_ratio", "h_ground", "neg_cdrag", "two_thirds", "kpr",
                "inv_kpr", "pi180")


class _DemArgs(ctypes.Structure):
    """``DemArgs`` of ``csrc/dem_substeps.cu``, field for field."""
    _fields_ = ([(f, _P) for f in ("alive", "static_berg", "thick", "mass",
                                   "od", "flk", "length", "width",
                                   "bond_idx")]
                + [("car_in", _P * 15), ("car_out", _P * 15),
                   ("broken_in", _P), ("broken_out", _P),
                   ("bond_in", _P * 6), ("bond_out", _P * 6)]
                + [(f, ctypes.c_int) for f in ("n_sub", "nslots", "nd",
                                               "flags")]
                + [("deltas", ctypes.c_int * MAX_DELTAS)]
                + [(f, ctypes.c_float) for f in _PARAM_ORDER])


def instantiation(cfg: IcebergsConfig, max_bonds: int) -> str:
    """The kernel instantiation a launch takes: ``"dem"``, ``"dem_ll"`` or
    ``"dem_hex"`` (each compiled for its flag set in
    :data:`COMPILED_FLAGS` and 6 bond slots) where the configuration's
    flag set is exactly one of those and ``max_bonds`` is 6, else
    ``"generic"``.  Decided on the host from the configuration alone."""
    fl = _flags(cfg) if max_bonds == COMPILED_SLOTS else None
    return next((k for k, v in COMPILED_FLAGS.items() if v == fl),
                "generic")


def kernel_config(variant: str, nslots: int, block_n: int):
    """``(dynamic shared memory bytes, resident CTAs per SM)`` of a kernel
    instantiation at ``block_n`` threads on the current CUDA device."""
    lib = cuda_build.library()
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    cuda_build.check(lib.ib_dem_config(_VARIANTS[variant], nslots, block_n,
                                       ctypes.byref(smem),
                                       ctypes.byref(ctas)), "dem_config")
    return smem.value, ctas.value


def kernel_name(mangled: str):
    """The variant name of a K4 instantiation's mangled name (``None``
    for any other function)."""
    m = re.search(r"dem_substeps_kernelILi\d+ELi(n?)(\d+)E", mangled)
    if not m:
        return None
    if m.group(1):
        return "generic"
    return next((k for k, v in COMPILED_FLAGS.items()
                 if v == int(m.group(2))), None)


def kernel_resources() -> dict:
    """Registers, stack frame and spill bytes of each K4 instantiation
    (the names of ``_VARIANTS``), from the library's ``-Xptxas -v``
    report."""
    out = {}
    for name, r in cuda_build.resource_report().items():
        v = kernel_name(name)
        if v and "registers" in r:
            out[v] = r
    return out


def part3_substeps_vmem(st, cfg: IcebergsConfig, deltas,
                        block_n: int = 512, variant: str = None):
    """Run all ``cfg.n_sub_steps`` fast substeps per conglomerate block.
    Returns ``(state, nbroken)``.

    ``deltas`` come from :func:`analyze_bond_deltas` on the bond table
    this state carries.  A CPU state takes :func:`part3_substeps_plain`;
    a CUDA state launches K4 (counted in ``part3_substeps_vmem.launches``)
    in the instantiation :func:`instantiation` picks, or in ``variant``
    (``"generic"`` serves every flag set; the card tests and
    ``chip_smoke.py`` hold it to the plain version on the compiled
    instantiations' worlds too).  A compiled ``variant`` whose flag set
    or slot count is not this configuration's raises ``ValueError``, on
    any device: nothing falls back to another instantiation.
    """
    _check(st, cfg, deltas, block_n)
    variant = variant or instantiation(cfg, st.max_bonds)
    if variant not in ("generic", instantiation(cfg, st.max_bonds)):
        raise ValueError(f"K4 instantiation {variant!r} cannot run this "
                         "configuration")
    if st.device.type == "cpu":
        return part3_substeps_plain(st, cfg, deltas, block_n)
    if st.device.type != "cuda":
        raise NotImplementedError(f"no K4 kernel for {st.device}")
    if block_n > MAX_BLOCK or not 1 <= st.max_bonds <= MAX_SLOTS:
        raise ValueError(f"K4 takes block_n <= {MAX_BLOCK} and max_bonds in "
                         f"1..{MAX_SLOTS} (got {block_n}, {st.max_bonds})")
    lib = cuda_build.library()
    if lib.ib_dem_args_size() != ctypes.sizeof(_DemArgs):
        raise RuntimeError("DemArgs layout differs between C and Python")

    def src(x, dtype=None):
        x = x.contiguous()
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"{x.dtype}: need {dtype}")
        return x

    f32, i32 = torch.float32, torch.int32
    ins = dict(alive=src(st.alive, torch.bool),
               static_berg=src(st.static_berg, f32),
               thick=src(st.thickness, f32), mass=src(st.mass, f32),
               od=src(st.od, f32), flk=src(st.fl_k, f32),
               length=src(st.length, f32), width=src(st.width, f32),
               bond_idx=src(st.bond_idx, i32))
    car_in = [src(getattr(st, f), f32) for f in _CAR_FIELDS]
    bond_in = [src(getattr(st, f), f32) for f in _BOND_FIELDS]
    broken_in = src(st.bond_broken.to(i32))
    car_out = [torch.empty_like(x) for x in car_in]
    bond_out = [torch.empty_like(x) for x in bond_in]
    broken_out = torch.empty_like(broken_in)

    a = _DemArgs(**{k: v.data_ptr() for k, v in ins.items()})
    for k in range(15):
        a.car_in[k] = car_in[k].data_ptr()
        a.car_out[k] = car_out[k].data_ptr()
    for k in range(6):
        a.bond_in[k] = bond_in[k].data_ptr()
        a.bond_out[k] = bond_out[k].data_ptr()
    a.broken_in, a.broken_out = broken_in.data_ptr(), broken_out.data_ptr()
    a.n_sub, a.nslots, a.nd = cfg.n_sub_steps, st.max_bonds, len(deltas)
    a.flags = _flags(cfg)
    for k, dlt in enumerate(deltas):
        a.deltas[k] = dlt
    for k, v in _params(cfg).items():
        setattr(a, k, v)
    cuda_build.check(lib.ib_dem_substeps(
        ctypes.addressof(a), st.capacity // block_n, block_n,
        _VARIANTS[variant],
        cuda_build.stream_ptr(st.device)), "dem_substeps")
    part3_substeps_vmem.launches += 1
    return _finish(st, car_out, broken_out, bond_out)


part3_substeps_vmem.launches = 0

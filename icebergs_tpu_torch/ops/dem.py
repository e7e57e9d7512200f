"""Bonded-particle DEM forces (iKID, Huth et al 2022b Sci. Adv.).

Counterpart of ``icebergs_tpu/ops/dem.py``: the packing-shape helpers
(``_HEXDENOM``, ``_radius``, ``dem_K_damp``; ``dem.py:30-62``); the bond
partner tables (``_partner_gather``, ``bond_partner_static``,
``bond_partner_fields``); the bond forces with their bookkeeping
(``dem_bond_forces``: ``calculate_force_dem``, ``src/icebergs.F90:957-
1242``, with ``savestress`` and the in-kernel fracture of 1140-1199); the
unbonded same-conglomerate contact (``dem_contact_forces`` over an
(N, M) candidate slab or the bond table, ``dem_contact_forces_pairs``
over a compacted pair list: ``calculate_unbonded_same_conglom_dem_force``,
806-956); the stress fracture (``break_bonds_dem``,
icebergs_framework.F90:4713-4801); and the grounding drag coefficient
the substep loop reads (``mts._grounding_drag_coeff``, ``mts.py:548-
574``).  These run the MTS scan substep path; K4 (:mod:`.dem_substeps`)
runs the same physics in one launch for its flag set.

Partner fields always come from one row gather of a packed (N, F)
matrix.  The JAX package takes a one-hot matmul instead up to 4096
slots (``make_bond_onehot``, a TPU trick: its MXU is cheaper than its
gathers); the gather gives the same values on every valid bond slot
exactly, and the card has no reason to trade it for a selection matmul
(whose default precision on the card is TF32: ROADMAP.md Queue 3).

Sums over a row's bond slots or candidates run in slot order from +0
(:func:`slot_sums`), the order of XLA's reduction loop and of K4; sums
into rows from a pair list run in pair order per row
(:func:`segment_sum_sorted`), the JAX package's sequential scatter-add,
with no atomics: the same bits on every run.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import constants as C
from ..config import IcebergsConfig
from ..grid import pair_separation
from .accel import f32_scalar, rdiv

_HEXDENOM = 1. / (2. * math.sqrt(3.))


class DemOut(NamedTuple):
    F_x: torch.Tensor        # (N,) net bond force without damping
    F_y: torch.Tensor
    T: torch.Tensor          # net torque without damping
    Fd_x: torch.Tensor       # damping force
    Fd_y: torch.Tensor
    T_d: torch.Tensor        # damping torque
    # per-bond bookkeeping, (N, B)
    bond_length: torch.Tensor
    tangd1: torch.Tensor
    tangd2: torch.Tensor
    rel_rotation: torch.Tensor
    nstress: torch.Tensor
    sstress: torch.Tensor
    # bond_broken with the in-kernel per-substep fracture (None when
    # break_bonds_on_sub_steps is off)
    broken: Optional[torch.Tensor] = None


def _radius(cfg: IcebergsConfig, A):
    """DEM element radius by packing shape."""
    if cfg.hexagonal_icebergs:
        return torch.sqrt(A * _HEXDENOM)
    return 0.5 * torch.sqrt(A)


def dem_K_damp(cfg: IcebergsConfig) -> float:
    """2k/(3(1-nu^2)) (icebergs_framework.F90:1436)."""
    return 2. * cfg.dem_spring_coef / (3. * (1. - cfg.poisson ** 2))


def tdiv(x, c: float):
    """``x / c`` for a Python scalar ``c``, correctly rounded on every
    device (a CUDA tensor divided by a host scalar is multiplied by the
    scalar's reciprocal)."""
    return torch.div(x, x.new_full((), c))


def slot_sums(*xs):
    """Row sums of (N, M) slabs over their last axis, each in slot order
    from +0, all in one pass over the slots."""
    t = torch.stack(xs, 0)
    acc = torch.zeros_like(t[..., 0])
    for k in range(t.shape[-1]):
        acc = acc + t[..., k]
    return acc.unbind(0)


def segment_sum_sorted(vals, key, nseg: int):
    """Sums of the rows of ``vals`` (P, F) into ``nseg`` segments by
    ``key`` (P,), ascending: each segment's rows are added in order from
    +0, the JAX package's sequential scatter-add on the CPU, by one
    thread per segment and column on the card (no atomics).  Rows whose
    key is ``nseg`` or more are dropped.  Returns (nseg, F)."""
    bounds = torch.searchsorted(key, torch.arange(
        nseg + 1, dtype=key.dtype, device=key.device))
    return torch.segment_reduce(vals, "sum", lengths=bounds.diff(), axis=0,
                                unsafe=True)


def grounding_drag_coeff(cfg: IcebergsConfig, thickness, od, mass, length,
                         width, area_form: str, scan: bool = False):
    """gdrag of short-step grounding (``'rect'``) or of the grounding
    torque (``'disk'``; icebergs.F90:6868-6893, 6986-7034).  A hexagon's
    disk radius takes K4's product with 1/(2 sqrt 3)
    (``icebergs_tpu/ops/dem_vmem.py:310-311``) or, for the ``scan``, the JAX
    scan's division by 2 sqrt 3 (``icebergs_tpu/mts.py:567``)."""
    D = (cfg.rho_bergs / C.RHO_SEAWATER) * thickness
    if cfg.h_to_init_grounding > 0.:
        gf = (1.0 - tdiv(od - D, cfg.h_to_init_grounding)).clamp(0., 1.)
    else:
        gf = torch.where(D > od, 1.0, 0.0)
    if cfg.constant_interaction_LW:
        A0c = cfg.constant_length * cfg.constant_width
        MM = A0c * thickness * cfg.rho_bergs
        A0 = torch.full_like(mass, A0c)
    else:
        MM = mass
        A0 = length * width
    if area_form == "rect":
        AA = A0
    else:                       # disk of interaction radius
        if cfg.hexagonal_icebergs and scan:
            R1 = torch.sqrt(A0 / (2. * torch.sqrt(A0.new_full((), 3.))))
        elif cfg.hexagonal_icebergs:
            R1 = torch.sqrt(A0 * _HEXDENOM)
        elif cfg.iceberg_bonds_on:
            R1 = 0.5 * torch.sqrt(A0)
        else:
            R1 = torch.sqrt(tdiv(A0, C.PI))
        AA = C.PI * (R1 * R1)
    return torch.where(gf > 0., -cfg.cdrag_grounding * gf * AA / MM, 0.)


# --------------------------------------------------------------------------
# bond partner tables
# --------------------------------------------------------------------------

_BOND_PART_DYN = ("lon_old", "lat_old", "uvel_old", "vvel_old",
                  "ang_vel", "rot")
_BOND_PART_STATIC = ("thickness", "length", "width", "mass", "fl_k")


def _partner_gather(st, names, extra_alive: bool):
    """The partner rows of every bond slot, one row gather of the packed
    (N, F) matrix (a slot with no bond reads slot 0, masked later)."""
    cols = [getattr(st, n) for n in names]
    if extra_alive:
        cols.append(st.alive.to(st.dtype))
    g = torch.stack(cols, -1)[st.bond_idx.clamp(min=0).long()]
    part = {n: g[..., k] for k, n in enumerate(names)}
    if extra_alive:
        part["alive"] = g[..., len(names)] > 0.5
    return part


def bond_partner_static(st):
    """Partner columns constant across MTS substeps (geometry, mass,
    footloose state and aliveness): gathered once an outer step."""
    return _partner_gather(st, _BOND_PART_STATIC, True)


def bond_partner_fields(st, static=None):
    """Partner fields of the (N, B) bond slots, shared by the bond and the
    broken-bond contact forces; with ``static`` from
    :func:`bond_partner_static` only the 6 kinematic columns move."""
    if static is None:
        static = bond_partner_static(st)
    part = _partner_gather(st, _BOND_PART_DYN, False)
    part.update(static)
    return part


# --------------------------------------------------------------------------
# bond forces
# --------------------------------------------------------------------------

def dem_bond_forces(st, cfg: IcebergsConfig, dt, part=None) -> DemOut:
    """Every unbroken bond's force, torque and damping with the updated
    per-bond state (calculate_force_dem, savestress), the per-substep
    fracture when ``break_bonds_on_sub_steps`` is on.  ``part`` reuses a
    :func:`bond_partner_fields` table."""
    p = bond_partner_fields(st) if part is None else part
    valid = ((st.bond_idx >= 0) & (st.bond_broken != 1)
             & st.alive[:, None] & p["alive"]
             & (st.fl_k[:, None] != -1.) & (p["fl_k"] != -1.))
    ones = torch.ones_like(st.bond_length)
    if cfg.constant_interaction_LW:
        A0 = cfg.constant_length * cfg.constant_width
        R0 = (math.sqrt(A0 * _HEXDENOM) if cfg.hexagonal_icebergs
              else 0.5 * math.sqrt(A0))
        R1 = torch.full_like(st.bond_length, R0)
        R2 = R1
        M1 = (A0 * st.thickness * cfg.rho_bergs)[:, None] * ones
        M2 = A0 * p["thickness"] * cfg.rho_bergs
        Rmin = R1
        T_Rmin = p["thickness"]
        l0 = 2. * R1
    else:
        A1 = (st.length * st.width)[:, None]
        A2 = p["length"] * p["width"]
        M1 = st.mass[:, None] * ones
        M2 = p["mass"]
        R1 = _radius(cfg, A1) * ones
        R2 = _radius(cfg, A2)
        first_smaller = R1 < R2
        Rmin = torch.where(first_smaller, R1, R2)
        T_Rmin = torch.where(first_smaller, st.thickness[:, None],
                             p["thickness"])
        l0 = R1 + R2

    rx, ry = pair_separation(st.lon_old[:, None], st.lat_old[:, None],
                             p["lon_old"], p["lat_old"], cfg.grid_is_latlon,
                             cfg.Rearth)
    length = torch.sqrt(rx * rx + ry * ry)
    lsafe = torch.where(length > 0., length, 1.)
    n1 = rx / lsafe
    n2 = ry / lsafe

    half_delta = 0.5 * (l0 - length)
    RR1 = R1 - half_delta
    RR2 = R2 - half_delta
    RR1x, RR1y = RR1 * n1, RR1 * n2
    RR2x, RR2y = RR2 * n1, RR2 * n2

    # bond width and thickness at the contact point (Wang 2020)
    L = 2.0 * (Rmin + (Rmin - half_delta) * (R1 - R2).abs() / lsafe)
    dT = (st.thickness[:, None] - p["thickness"]).abs()
    Thick = T_Rmin + (Rmin - half_delta) * dT / lsafe

    k = cfg.dem_spring_coef
    Fn_mag = k * Thick * 2. * half_delta * L / l0
    Fn_x, Fn_y = Fn_mag * n1, Fn_mag * n2
    ur = st.uvel_old[:, None] - p["uvel_old"]
    vr = st.vvel_old[:, None] - p["vvel_old"]

    # the accumulated tangential displacement projected onto the contact
    # plane, magnitude kept
    t1, t2 = st.bond_tangd1, st.bond_tangd2
    tmag = t1 * t1 + t2 * t2
    tdotn = t1 * n1 + t2 * n2
    t1p = t1 - tdotn * n1
    t2p = t2 - tdotn * n2
    tmagp = t1p * t1p + t2p * t2p
    pos = tmagp > 0.
    t_rat = torch.where(pos, torch.sqrt(tmag / torch.where(pos, tmagp, 1.)),
                        0.)
    t1p = t_rat * t1p
    t2p = t_rat * t2p

    # relative tangential velocity with the particles' rotation
    angv, pangv = st.ang_vel[:, None], p["ang_vel"]
    rotu = RR1y * angv + RR2y * pangv
    rotv = -(RR1x * angv + RR2x * pangv)
    ur2 = ur + rotu
    vr2 = vr + rotv
    upmag = ur2 * n1 + vr2 * n2
    up, vp = upmag * n1, upmag * n2
    tangd1 = t1p + (ur2 - up) * dt
    tangd2 = t2p + (vr2 - vp) * dt

    # shear force and stress
    ss_factor = -L * Thick * k / (l0 * 2.0 * (1.0 + cfg.poisson))
    if cfg.ignore_tangential_force:
        ss_factor = torch.zeros_like(ss_factor)
    Fs_x = ss_factor * tangd1
    Fs_y = ss_factor * tangd2
    sstress = torch.sqrt(Fs_x * Fs_x + Fs_y * Fs_y) \
        / (L * Thick).clamp(min=1e-30)
    Ts = -(RR1x * Fs_y - RR1y * Fs_x)
    rel_rotation = st.bond_rel_rotation + (angv - pangv) * dt

    if not cfg.orig_dem_moment_of_inertia:
        theta = torch.sin(st.rot[:, None] - p["rot"])      # Wang 2020
        Tr = -k * (L * (L * L)) * Thick * theta / (12. * l0)
    else:
        theta = st.rot[:, None] - p["rot"]                 # Potyondy-Cundall
        hl = 0.5 * L
        Tr = -rdiv(k, l0) * (2. / 3.) * (hl * (hl * hl)) * Thick * theta
    nstress = rdiv(k, l0) * (-2. * half_delta + (theta * 0.5 * L).abs())

    damping_coef = cfg.dem_damping_coef * torch.sqrt(
        dem_K_damp(cfg) * M1 * M2 / (M1 + M2))
    dw = angv - pangv

    broken_new = None
    if cfg.break_bonds_on_sub_steps:
        # a bond whose fresh stress exceeds a threshold breaks now and
        # gives no force this substep, but the compression contact and
        # the linear damping when it failed under compression
        if cfg.fracture_criterion != "stress":
            raise ValueError("break_bonds_on_sub_steps requires "
                             "fracture_criterion='stress'")
        breaking = valid & (
            (nstress > cfg.frac_thres_n * cfg.frac_thres_scaling)
            | (sstress > cfg.frac_thres_t * cfg.frac_thres_scaling))
        broken_new = torch.where(breaking, 1, st.bond_broken).to(
            st.bond_broken.dtype)
        w = torch.where(valid & ~breaking, 1., 0.)
        wc = torch.where(breaking & (nstress < 0.), 1., 0.)
        wd = w + wc
        F_x, F_y, T, Fd_x, Fd_y, T_d = slot_sums(
            w * (Fn_x + Fs_x) + wc * Fn_x, w * (Fn_y + Fs_y) + wc * Fn_y,
            w * (Ts + Tr), wd * (-damping_coef * ur),
            wd * (-damping_coef * vr), w * (-damping_coef * dw))
    else:
        w = torch.where(valid, 1., 0.)
        F_x, F_y, T, Fd_x, Fd_y, T_d = slot_sums(
            w * (Fn_x + Fs_x), w * (Fn_y + Fs_y), w * (Ts + Tr),
            w * (-damping_coef * ur), w * (-damping_coef * vr),
            w * (-damping_coef * dw))

    return DemOut(
        F_x=F_x, F_y=F_y, T=T, Fd_x=Fd_x, Fd_y=Fd_y, T_d=T_d,
        bond_length=torch.where(valid, length, st.bond_length),
        tangd1=torch.where(valid, tangd1, st.bond_tangd1),
        tangd2=torch.where(valid, tangd2, st.bond_tangd2),
        rel_rotation=torch.where(valid, rel_rotation,
                                 st.bond_rel_rotation),
        nstress=torch.where(valid, nstress, st.bond_nstress),
        sstress=torch.where(valid, sstress, st.bond_sstress),
        broken=broken_new)


# --------------------------------------------------------------------------
# unbonded same-conglomerate contact
# --------------------------------------------------------------------------

def _contact_radii(cfg: IcebergsConfig, A):
    if cfg.hexagonal_icebergs:
        return torch.sqrt(A * _HEXDENOM)
    if cfg.iceberg_bonds_on:
        return 0.5 * torch.sqrt(A)
    return torch.sqrt(tdiv(A, C.PI))


def _contact_R0(cfg: IcebergsConfig, A0: float) -> float:
    if cfg.hexagonal_icebergs:
        return math.sqrt(A0 * _HEXDENOM)
    if cfg.iceberg_bonds_on:
        return 0.5 * math.sqrt(A0)
    return math.sqrt(A0 / C.PI)


def _contact_damping(cfg: IcebergsConfig):
    """(spring, radial, tangential) coefficients of the DEM contact: the
    critical values as the reference's double-precision host math."""
    s = cfg.spring_coef
    if cfg.critical_interaction_damping_on:
        rad = 2. * math.sqrt(s)
        tan = ((2. * math.sqrt(s)) / 4. if cfg.tang_crit_int_damp_on
               else cfg.tangental_damping_coef)
        return s, rad, tan
    return s, cfg.radial_damping_coef, cfg.tangental_damping_coef


def _contact_terms(cfg, rx, ry, crit, M1, M2, mask, du, dv, durel, dvrel):
    """The per-pair spring and damping terms of the DEM contact, masked
    to the engaged pairs: ``(fx, fy, dx, dy)``."""
    r = torch.sqrt(rx * rx + ry * ry)
    rsafe = torch.where(r > 0., r, 1.)
    spring_coef, radial_damping, tangental_damping = _contact_damping(cfg)
    active = mask & (r > 0.) & (r < crit)
    M_min = torch.minimum(M1, M2)
    mm = M_min / M1
    accel_spring = spring_coef * mm * (crit - r)
    fx = torch.where(active, accel_spring * rx / rsafe, 0.)
    fy = torch.where(active, accel_spring * ry / rsafe, 0.)
    rs2 = rsafe * rsafe
    P11 = (rx * rx) / rs2
    P12 = (rx * ry) / rs2
    P22 = (ry * ry) / rs2

    def pmag(Pa, Pb, Pc, coef):
        if not cfg.scale_damping_by_pmag:
            return coef
        q1 = Pa * du + Pb * dv
        q2 = Pb * du + Pc * dv
        return coef * torch.sqrt(q1 * q1 + q2 * q2)

    crad = pmag(P11, P12, P22, radial_damping * mm)
    ctan = pmag(1. - P11, -P12, 1. - P22, tangental_damping * mm)
    Pd11 = crad * P11 + ctan * (1. - P11)
    Pd12 = crad * P12 + ctan * (-P12)
    Pd22 = crad * P22 + ctan * (1. - P22)
    dx = torch.where(active, Pd11 * durel + Pd12 * dvrel, 0.)
    dy = torch.where(active, Pd12 * durel + Pd22 * dvrel, 0.)
    return fx, fy, dx, dy


# the partner fields of the contact, and the candidate entries one row
# block of the dense form gathers at once (about 2.4 GB of partner
# fields and 0.27 GB per (rows, M) temporary at M = 400)
_CONTACT_FIELDS = ("fl_k", "thickness", "lon_old", "lat_old", "uvel_old",
                   "vvel_old", "length", "width", "mass")
_DENSE_BLOCK = 1 << 26


def dem_contact_forces(st, cfg: IcebergsConfig, other, mask, part=None):
    """Unbonded same-conglomerate contact with explicit damping over an
    (N, M) candidate table ``other`` masked by ``mask``
    (calculate_unbonded_same_conglom_dem_force, icebergs.F90:806-956).
    With ``part`` from :func:`bond_partner_fields` (valid only when
    ``other`` is the bond table) its partner fields are reused; without,
    the partners are gathered in blocks of rows of ``_DENSE_BLOCK``
    candidates, which bounds the memory and leaves every row's bits as
    they are.  Returns ``(IA_x, IA_y, IAd_x, IAd_y)``, each row summed in
    slot order."""
    own = {k: getattr(st, k) for k in _CONTACT_FIELDS + ("uvel", "vvel")}
    if part is not None:
        return _contact_rows(cfg, own, part, mask)
    src = torch.stack([own[k] for k in _CONTACT_FIELDS], -1)
    N, M = other.shape
    rows = max(1, _DENSE_BLOCK // max(M, 1))
    outs = []
    for r0 in range(0, max(N, 1), rows):
        r = slice(r0, r0 + rows)
        g = dict(zip(_CONTACT_FIELDS, src[other[r].long()].unbind(-1)))
        outs.append(_contact_rows(cfg, {k: v[r] for k, v in own.items()}, g,
                                  mask[r]))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(z) for z in zip(*outs))


def _contact_rows(cfg: IcebergsConfig, own, g, mask):
    """:func:`dem_contact_forces` on rows whose own fields are ``own``
    ((R,) each) and whose partners' are ``g`` ((R, M) each)."""
    mask = mask & (own["fl_k"][:, None] != -1.) & (g["fl_k"] != -1.)
    if cfg.constant_interaction_LW:
        A0 = cfg.constant_length * cfg.constant_width
        R0 = _contact_R0(cfg, A0)
        crit = R0 + R0
        M1 = (A0 * own["thickness"] * cfg.rho_bergs)[:, None]
        M2 = A0 * g["thickness"] * cfg.rho_bergs
    else:
        crit = _contact_radii(cfg, (own["length"] * own["width"])[:, None]) \
            + _contact_radii(cfg, g["length"] * g["width"])
        M1 = own["mass"][:, None]
        M2 = g["mass"]
    rx, ry = pair_separation(own["lon_old"][:, None],
                             own["lat_old"][:, None], g["lon_old"],
                             g["lat_old"], cfg.grid_is_latlon, cfg.Rearth)
    u2, v2 = g["uvel_old"], g["vvel_old"]
    # the pmag velocity difference: the partner's *_old velocity less the
    # substep-start velocity (accel_explicit_inner_mts passes uvel0 for
    # both ends, icebergs.F90:1838-1841)
    terms = _contact_terms(cfg, rx, ry, crit, M1, M2, mask,
                           u2 - own["uvel"][:, None],
                           v2 - own["vvel"][:, None],
                           u2 - own["uvel_old"][:, None],
                           v2 - own["vvel_old"][:, None])
    return slot_sums(*terms)


def dem_contact_forces_pairs(st, cfg: IcebergsConfig, me, other, mask,
                             valid=None):
    """:func:`dem_contact_forces` on a compacted (P,) pair list (the
    frozen substep contact candidates of
    :func:`..mts.compact_conglom_pairs`): each pair's terms as the dense
    form's, summed into row ``me`` in pair order
    (:func:`segment_sum_sorted`).  ``me`` must ascend over the pairs
    where ``valid`` (all pairs when None); pairs outside ``valid`` must be
    masked.  Returns ``(IA_x, IA_y, IAd_x, IAd_y)``."""
    N = st.capacity
    packed = torch.stack([st.lon_old, st.lat_old, st.uvel_old, st.vvel_old,
                          st.uvel, st.vvel, st.length * st.width,
                          st.thickness, st.fl_k], -1)
    g1 = packed[me.long()]
    g2 = packed[other.long()]
    mask = mask & (g1[:, 8] != -1.) & (g2[:, 8] != -1.)
    if cfg.constant_interaction_LW:
        A0 = cfg.constant_length * cfg.constant_width
        R0 = _contact_R0(cfg, A0)
        crit = R0 + R0
        M1 = A0 * g1[:, 7] * cfg.rho_bergs
        M2 = A0 * g2[:, 7] * cfg.rho_bergs
    else:
        crit = _contact_radii(cfg, g1[:, 6]) + _contact_radii(cfg, g2[:, 6])
        M1 = st.mass[me.long()]
        M2 = st.mass[other.long()]
    # as the dense form: the partner's *_old velocity less the self
    # substep-start velocity in pmag
    terms = _contact_terms(cfg, g1[:, 0] - g2[:, 0], g1[:, 1] - g2[:, 1],
                           crit, M1, M2, mask, g2[:, 2] - g1[:, 4],
                           g2[:, 3] - g1[:, 5], g2[:, 2] - g1[:, 2],
                           g2[:, 3] - g1[:, 3])
    key = me if valid is None else torch.where(valid, me, N)
    acc = segment_sum_sorted(torch.stack(terms, -1), key, N)
    return acc.unbind(1)


# --------------------------------------------------------------------------
# fracture
# --------------------------------------------------------------------------

def break_bonds_dem(st, cfg: IcebergsConfig):
    """Stress-criterion fracture (break_bonds_dem,
    icebergs_framework.F90:4713-4801): bonds break where nstress >
    frac_thres_n or sstress > frac_thres_t (scaled); ``n_bonds``
    refreshed.  Returns ``(state, newly broken)``, the count a 0-dim
    int32."""
    zero = torch.zeros((), dtype=torch.int32, device=st.device)
    if cfg.fracture_criterion != "stress":
        return st, zero
    tn = cfg.frac_thres_n * cfg.frac_thres_scaling
    tt = cfg.frac_thres_t * cfg.frac_thres_scaling
    if tn <= 0. and tt <= 0.:
        return st, zero
    tn = tn if tn > 0. else math.inf
    tt = tt if tt > 0. else math.inf
    has = st.bond_idx >= 0
    breaking = has & (st.bond_broken != 1) & (
        (st.bond_nstress > tn) | (st.bond_sstress > tt))
    broken = torch.where(breaking, 1, st.bond_broken).to(
        st.bond_broken.dtype)
    live = has & (broken != 1)
    return (st.replace(bond_broken=broken,
                       n_bonds=live.sum(dim=1).to(st.dtype)),
            breaking.sum(dtype=torch.int32))


def moment_radius_sq(cfg: IcebergsConfig, st):
    """R1^2 of the DEM moment of inertia (``_substep_forces``): the
    constant interaction area's radius squared in the state's dtype as a
    Python float, or the elements' own."""
    dt = st.lon.dtype
    if cfg.constant_interaction_LW:
        A0 = cfg.constant_length * cfg.constant_width
        if cfg.hexagonal_icebergs:
            R1 = f32_scalar(lambda a: torch.sqrt(a / (2. * torch.sqrt(
                torch.tensor(3., dtype=dt)))), A0, dt)
        else:
            R1 = 0.5 * f32_scalar(torch.sqrt, A0, dt)
        return f32_scalar(lambda r: r * r, R1, dt)
    A0 = st.length * st.width
    if cfg.hexagonal_icebergs:
        R1 = torch.sqrt(tdiv(A0, f32_scalar(
            lambda s: 2. * torch.sqrt(s), 3., dt)))
    else:
        R1 = 0.5 * torch.sqrt(A0)
    return R1 * R1

"""Multiple-time-stepping velocity Verlet (MTS) with the iKID DEM loop.

Counterpart of ``icebergs_tpu/mts.py`` (port of ``evolve_icebergs_mts``,
``src/icebergs.F90:6576-7078``, ``accel_mts`` 1277-1708 and
``accel_explicit_inner_mts`` 1709-1947):

* **Part 1** — V_{n+1} from the slow forces plus the cross-conglomerate
  collision group, iterated to ``force_convergence``.  The group comes
  from the fused search (``neighbor_mode="fused"``,
  :func:`.ops.fused_contact.make_ia_fn_fused_mts1`: K2 with the
  conglomerate filter) or from the candidate tables (any other mode:
  :func:`.ops.forces.make_ia_fn` with ``mts_part=1``, evaluated by K7);
* **Part 2** — the half-kick by the slow acceleration, after the
  outer-step fracture (``break_bonds_dem``) when the substeps do not
  break bonds themselves;
* **Part 3** — ``n_sub_steps`` fast substeps over bond and contact
  forces: in one launch of K4 (:mod:`.ops.dem_substeps`) on the
  conglomerate-blocked layout (``substep_kernel="vmem"`` with its
  deltas), or as a Python loop over substeps in plain PyTorch (``"scan"``:
  drift, DEM bond forces with per-substep fracture, broken-bond and
  same-conglomerate contact from the frozen candidate set or its
  compacted pair list, torque and angular update; MTS without DEM:
  ``calculate_force`` bonds and contacts through K7, explicit or with
  the implicit solve of ``accel_mts(mts_part=3)``).

Host syncs: the Part-1 convergence loop reads its ``done`` flag once per
iteration (``MtsDiags.conv_iters``), and the implicit inner substeps'
``force_convergence`` loop once per iteration
(``MtsDiags.inner_conv_iters``, summed over substeps); nothing else
reads the card.  The per-substep broken-bond counts stay on the device.

``substep_sync`` (state -> state) runs at the top of every substep: the
ring ghost-state refresh of the tiled MTS step
(:func:`.parallel.domain.make_sharded_mts_step`); a given sync routes
the substeps to the scan, never to K4, as in the JAX package.  The cycle
itself is the generator :func:`evolve_icebergs_mts_sequence`, which
yields an :class:`MtsEvent` where it reads the card (each convergence
test, with its norms over the owned moving elements) and, with
``sync``, at the top of every substep; :func:`evolve_icebergs_mts`
answers the events for one state, the tiled step for all its tiles in
lockstep (one decision for all, from the norms summed over the tiles).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import constants as C
from .config import IcebergsConfig
from .dynamics import _advance_position, adjust_index_and_ground
from .grid import Grid, pair_separation
from .ops import dem as _dem
from .ops import forces as _forces
from .ops.accel import coriolis, rdiv
from .ops.dem import tdiv
from .ops.dem_substeps import part3_substeps_vmem, supports_vmem_substeps
from .ops.forces import compact_rows
from .ops.fused_contact import make_ia_fn_fused_mts1


class MtsEvent:
    """A point where the MTS cycle waits for its driver: ``kind``
    ``"conv"`` with ``value`` ``(usum, usum1, usum2, had_collision or
    None, tolerance)``, answered by whether the iteration has converged
    (:func:`converged`); ``"sync"`` with the substep's state, answered by
    the state to go on with."""
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value):
        self.kind, self.value = kind, value


def converged(usum, usum1, usum2, had_collision, tol) -> bool:
    """The convergence test of icebergs.F90:6663-6743 on the velocity
    norms (one host read): the relative change below ``tol``, or no
    collision (Part 1; ``had_collision`` None for the inner loop)."""
    denom = torch.sqrt(usum) + torch.sqrt(usum1)
    nc = torch.where(denom > 0., 2. * torch.sqrt(usum2) / denom, 0.)
    done = nc < tol
    if had_collision is not None:
        done = (~had_collision) | done
    return bool(done)


def drive_mts(seq, substep_sync=None):
    """Run an :func:`evolve_icebergs_mts_sequence` for one state: each
    convergence test decided on its own norms, each substep's state
    through ``substep_sync``.  Returns the sequence's ``(state,
    MtsDiags)``."""
    sent = None
    while True:
        try:
            ev = seq.send(sent)
        except StopIteration as done:
            return done.value
        sent = (substep_sync(ev.value) if ev.kind == "sync"
                else converged(*ev.value))


class MtsDiags(NamedTuple):
    broken_bonds: torch.Tensor       # 0-dim int32
    conv_iters: int                  # Part-1 iterations run (host count)
    p1_overflow: Optional[torch.Tensor] = None  # Part-1 drops
    # Part-1 rows on the exact fallback (not in the JAX MtsDiags)
    p1_fallback: Optional[torch.Tensor] = None
    # same-conglomerate candidates the skin prefilter kept out of the
    # frozen substep pair list (0-dim int32; 0 without one)
    skin_dropped: Optional[torch.Tensor] = None
    # candidates beyond the pair list's capacity (None without a list):
    # nonzero means the substep contacts missed pairs, grow the cap
    pair_overflow: Optional[torch.Tensor] = None
    # the implicit inner substeps' convergence iterations, summed over
    # substeps (host count; not in the JAX MtsDiags)
    inner_conv_iters: int = 0


def _slow_accel_mts(st, cfg: IcebergsConfig, ia_fn):
    """Part-1 acceleration (accel_mts with mts_part=1): u* = V_k, every
    explicit term in axn, the implicit 2x2 solve with scaling 0.5 and
    Crank-Nicolson Coriolis.  Returns (ax, ay, axn, ayn, bxn, byn,
    |Fdc|)."""
    scaling = 0.5
    u_star, v_star = st.uvel, st.vvel
    uvel0, vvel0 = st.uvel, st.vvel
    dt = cfg.dt
    f_cori = coriolis(cfg, st.lat)

    # dead slots carry mass 0: clamp so masked lanes stay finite
    M = st.mass.clamp(min=1e-30)
    T = st.thickness
    D = (cfg.rho_bergs / C.RHO_SEAWATER) * T
    F = T - D
    W, L = st.width, st.length
    hi = torch.minimum(st.hi, D)
    D_hi = (D - hi).clamp(min=0.)
    uo, vo, ui, vi, ua, va = st.uo, st.vo, st.ui, st.vi, st.ua, st.va
    # radius-based vertical faces for hexagonal DEM elements
    # (icebergs.F90:1378-1386)
    if cfg.dem and cfg.hexagonal_icebergs and cfg.radius_based_drag:
        L2 = 2. * torch.sqrt(L * W / (2. * torch.sqrt(M.new_full((), 3.))))
        W2 = L2
    else:
        L2, W2 = L, W

    if cfg.h_to_init_grounding > 0.:
        groundfrac = (1.0 - tdiv(st.od - D, cfg.h_to_init_grounding)
                      ).clamp(0., 1.)
    else:
        groundfrac = torch.where(D > st.od, 1.0, 0.0)
    c_gnd = torch.where(groundfrac > 0.,
                        (cfg.cdrag_grounding * W * L * groundfrac)
                        / M.clamp(min=1e-30), 0.)
    if cfg.short_step_mts_grounding:
        c_gnd = torch.zeros_like(c_gnd)

    # wave radiation
    uwave, vwave = ua - uo, va - vo
    wmod2 = uwave * uwave + vwave * vwave
    ampl = 0.5 * 0.02025 * wmod2
    Lwl = 0.32 * wmod2
    Cr = 0.06 * ((L2 - 0.125 * Lwl) / (0.125 * Lwl + 1.e-30)).clamp(0., 1.)
    wave_rad = rdiv(0.5 * C.RHO_SEAWATER, M) * Cr * C.GRAVITY * ampl \
        * torch.minimum(ampl, F) * (2. * W2 * L2) \
        / (W2 + L2).clamp(min=1e-30)
    wmod = torch.sqrt(ua * ua + va * va)
    nz = wmod != 0.
    uwave = torch.where(nz, ua / torch.where(nz, wmod, 1.), 0.)
    vwave = torch.where(nz, va / torch.where(nz, wmod, 1.), 0.)
    wave_rad = torch.where(nz, wave_rad, 0.)

    if cfg.iceberg_bonds_on and cfg.internal_bergs_for_drag:
        dragfrac = tdiv(cfg.n_max_bonds_shape - st.n_bonds,
                        cfg.n_max_bonds_shape)
    else:
        dragfrac = torch.ones_like(M)

    c_ocn = rdiv(C.RHO_SEAWATER, M) * cfg.ocean_drag_scale \
        * (0.5 * C.CD_WV * dragfrac * W2 * D_hi + C.CD_WH * W * L)
    c_atm = rdiv(C.RHO_AIR, M) * (0.5 * C.CD_AV * dragfrac * W2 * F
                                  + C.CD_AH * W * L)
    c_ice = torch.where(hi.abs() == 0., 0.,
                        rdiv(C.RHO_ICE, M) * (0.5 * C.CD_IV * dragfrac * W2
                                              * hi))
    c_ice = torch.where(ui.abs() + vi.abs() == 0., 0., c_ice)

    ia = ia_fn(uvel0, vvel0)
    if cfg.only_interactive_forces:
        axn = ia.IA_x * 0.
        ayn = ia.IA_y * 0.
    else:
        axn = -C.GRAVITY * st.ssh_x + wave_rad * uwave + ia.IA_x
        ayn = -C.GRAVITY * st.ssh_y + wave_rad * vwave + ia.IA_y
        axn = axn + f_cori * v_star
        ayn = ayn - f_cori * u_star

    def spd(a, b):
        return torch.sqrt(a * a + b * b)

    uveln, vveln = uvel0, vvel0
    ax = ay = torch.zeros_like(M)
    for itloop in (1, 2):
        if itloop == 2:
            ia = ia_fn(uveln, vveln)   # re-evaluate with the iterate
        if cfg.only_interactive_forces:
            RHS_x = (ia.IA_x / 2.) - scaling * (
                (ia.P11 * u_star + ia.P12 * v_star) - ia.Pu_x)
            RHS_y = (ia.IA_y / 2.) - scaling * (
                (ia.P21 * u_star + ia.P22 * v_star) - ia.Pu_y)
            A11 = 1. + scaling * dt * ia.P11
            A22 = 1. + scaling * dt * ia.P22
            A12 = scaling * dt * ia.P12
            A21 = scaling * dt * ia.P21
        else:
            drag_ocn = c_ocn * 0.5 * (spd(uveln - uo, vveln - vo)
                                      + spd(uvel0 - uo, vvel0 - vo))
            drag_atm = c_atm * 0.5 * (spd(uveln - ua, vveln - va)
                                      + spd(uvel0 - ua, vvel0 - va))
            drag_ice = c_ice * 0.5 * (spd(uveln - ui, vveln - vi)
                                      + spd(uvel0 - ui, vvel0 - vi))
            drag_gnd = c_gnd
            RHS_x = (axn / 2.) + scaling * (
                -drag_ocn * (u_star - uo) - drag_atm * (u_star - ua)
                - drag_ice * (u_star - ui) - drag_gnd * u_star)
            RHS_y = (ayn / 2.) + scaling * (
                -drag_ocn * (v_star - vo) - drag_atm * (v_star - va)
                - drag_ice * (v_star - vi) - drag_gnd * v_star)
            RHS_x = RHS_x - scaling * ((ia.P11 * u_star + ia.P12 * v_star)
                                       - ia.Pu_x)
            RHS_y = RHS_y - scaling * ((ia.P21 * u_star + ia.P22 * v_star)
                                       - ia.Pu_y)
            lam = drag_ocn + drag_atm + drag_ice + drag_gnd
            A11 = 1. + scaling * dt * lam + scaling * dt * ia.P11
            A22 = 1. + scaling * dt * lam + scaling * dt * ia.P22
            A12 = -scaling * dt * f_cori / 2. + scaling * dt * ia.P12
            A21 = scaling * dt * f_cori / 2. + scaling * dt * ia.P21
        detA = rdiv(1., A11 * A22 - A12 * A21)
        ax = detA * (A22 * RHS_x - A12 * RHS_y)
        ay = detA * (A11 * RHS_y - A21 * RHS_x)
        uveln = u_star + dt * ax
        vveln = v_star + dt * ay

    # the explicit split with the new velocity (CN Coriolis)
    if cfg.only_interactive_forces:
        axn, ayn = ia.IA_x, ia.IA_y
    else:
        axn = -C.GRAVITY * st.ssh_x + wave_rad * uwave + ia.IA_x \
            + f_cori * vveln
        ayn = -C.GRAVITY * st.ssh_y + wave_rad * vwave + ia.IA_y \
            - f_cori * uveln
    bxn = 2. * ax - axn
    byn = 2. * ay - ayn

    # collisional damping force magnitude (convergence bookkeeping)
    Fdc_x = M * (ia.Pu_x - (ia.P11 * uveln + ia.P12 * vveln))
    Fdc_y = M * (ia.Pu_y - (ia.P21 * uveln + ia.P22 * vveln))
    return ax, ay, axn, ayn, bxn, byn, Fdc_x.abs() + Fdc_y.abs()


# --------------------------------------------------------------------------
# the frozen substep contact candidates
# --------------------------------------------------------------------------

def _contact_masks(st, nbr, cfg: IcebergsConfig):
    """Substep contact candidates: same conglomerate, not bonded by an
    unbroken bond, both ends with open bond slots (the contact rules of
    accel_explicit_inner_mts, icebergs.F90:1817-1855)."""
    other = nbr.cand_idx.long()
    same = st.conglom_id[:, None] == st.conglom_id[other]
    bonds = torch.where(st.bond_idx >= 0, st.bond_idx, -2)
    unbroken_partner = ((nbr.cand_idx[:, :, None] == bonds[:, None, :])
                        & (st.bond_broken[:, None, :] != 1)).any(-1)
    m = nbr.cand_valid & same & ~unbroken_partner \
        & (st.n_bonds[other] < cfg.max_bonds)
    if cfg.dem:
        m = m & (st.n_bonds < cfg.max_bonds)[:, None]
    return m


def _ordered_bin_sums(vals, bins, nbins: int):
    """``zeros(nbins).at[bins].add(vals)`` of the JAX package (each bin's
    values added in slot order from +0, bins outside [0, nbins)
    dropped), by a stable sort and :func:`.ops.dem.segment_sum_sorted`:
    no atomics.  ``vals`` (N, F) -> (nbins, F)."""
    order = torch.argsort(bins, stable=True)
    return _dem.segment_sum_sorted(vals[order], bins[order], nbins)


def _pair_keep_mask(st, nbr, cfg: Optional[IcebergsConfig] = None,
                    dt=None):
    """The frozen substep contact candidates (N, M) shared by
    :func:`compact_conglom_pairs` and :func:`auto_pair_cap`: valid
    same-conglomerate candidates, less the velocity/acceleration skin
    prefilter when ``cfg.mts_pair_skin > 0``.  Returns ``(keepM,
    skin_dropped)``."""
    other = nbr.cand_idx.long()
    keepM = nbr.cand_valid & (st.conglom_id[:, None]
                              == st.conglom_id[other])
    skin_dropped = torch.zeros((), dtype=torch.int32, device=st.device)
    if cfg is None or dt is None or cfg.mts_pair_skin <= 0.:
        return keepM, skin_dropped
    rx, ry = pair_separation(st.lon[:, None], st.lat[:, None],
                             st.lon[other], st.lat[other],
                             cfg.grid_is_latlon, cfg.Rearth)
    r2 = rx * rx + ry * ry
    if cfg.constant_interaction_LW:
        A1 = torch.full_like(st.lon, cfg.constant_length
                             * cfg.constant_width)
    else:
        A1 = st.length * st.width
    rad = _forces._interaction_radius(cfg, A1)
    # contact engages at r < R1 + R2 (contact_distance does not enter);
    # the skin is mts_pair_skin x the worst internal speed (against the
    # own conglomerate's mean velocity) over the outer step, plus a
    # fracture-release acceleration term
    crit = rad[:, None] + rad[other]
    cid = st.conglom_id.clamp(min=0)
    ncid = st.capacity                 # ids bounded by the slot count
    w = torch.where(st.alive, 1., 0.).to(st.dtype)
    sums = _ordered_bin_sums(torch.stack([w * st.uvel, w * st.vvel, w], -1),
                             cid, ncid)
    g = sums[cid.clamp(max=ncid - 1).long()]
    n = g[:, 2].clamp(min=1.)
    mu = g[:, 0] / n
    mv = g[:, 1] / n
    du, dv = st.uvel - mu, st.vvel - mv
    vint = torch.sqrt(du * du + dv * dv)
    vint_max = torch.where(st.alive, vint, 0.).max()
    # a bond fracturing mid-step releases at most its threshold force
    # over its area ~2R*T, so a fragment of a raft at rest closes at most
    # ~a_rel*dt^2 within the step
    a_rel = torch.zeros((), dtype=rad.dtype, device=st.device)
    if cfg.dem and cfg.fracture_criterion != "none":
        sig = max(cfg.frac_thres_n, cfg.frac_thres_t) \
            * cfg.frac_thres_scaling
        if cfg.constant_interaction_LW:
            Mb = (cfg.constant_length * cfg.constant_width * st.thickness
                  * cfg.rho_bergs)
        else:
            Mb = st.mass
        a_berg = sig * 2. * rad * st.thickness / Mb.clamp(min=1.)
        a_rel = torch.where(st.alive, a_berg, 0.).max()
    reach = 1.05 * crit + cfg.mts_pair_skin * vint_max * dt \
        + a_rel * dt * dt
    drop = keepM & (r2 > reach * reach)
    return keepM & ~drop, drop.sum(dtype=torch.int32)


def compact_conglom_pairs(st, nbr, cap: int,
                          cfg: Optional[IcebergsConfig] = None, dt=None):
    """The frozen substep contact candidates compacted into a (cap,) pair
    list, row-major: first the rows with a candidate into ``max(1024,
    cap // 64)`` rows, then their candidates into ``cap`` pairs.  The
    set is fixed for the outer step (cells are not re-binned inside the
    substeps, as in the reference); the dynamic masks (breakage, open
    slots) are applied per substep (:func:`_pair_contact_masks`).  With
    ``cfg`` and ``dt`` the skin prefilter of :func:`_pair_keep_mask`
    applies.  Returns ``(me, other, pvalid, overflow, skin_dropped)``:
    ``me`` ascends over ``pvalid``; ``overflow`` counts the candidates of
    rows beyond the row stage (M each) and those beyond ``cap``."""
    M = nbr.cand_idx.shape[1]
    keepM, skin_dropped = _pair_keep_mask(st, nbr, cfg, dt)
    act_cap = max(1024, cap // 64)
    rsel, rvalid, row_overflow = compact_rows(keepM.any(dim=1), act_cap)
    rs = rsel.long()
    keep2 = keepM[rs] & rvalid[:, None]
    sel, pvalid, dropped = compact_rows(keep2.reshape(-1), cap)
    me = rsel[(sel // M).clamp(max=act_cap - 1).long()]
    other = nbr.cand_idx[rs].reshape(-1)[sel.long()]
    return me, other, pvalid, row_overflow * M + dropped, skin_dropped


def auto_pair_cap(st, nbr, cfg: IcebergsConfig, *, safety: float = 4.0,
                  minimum: int = 2048, multiple: int = 1024) -> int:
    """Host-side size of the frozen pair list from the state before a
    run: ``safety`` x the skin-filtered candidate count rounded up to a
    ``multiple``, at least ``minimum``, at most N x M.  One host read;
    overflow is still counted every step (``MtsDiags.pair_overflow``)."""
    keepM, _ = _pair_keep_mask(st, nbr, cfg, cfg.dt)
    n = int(keepM.sum())
    cap = max(minimum, math.ceil(safety * max(n, 1) / multiple) * multiple)
    return min(cap, keepM.shape[0] * keepM.shape[1])


def _pair_contact_masks(st, me, other, pvalid, cfg: IcebergsConfig):
    """The per-substep part of :func:`_contact_masks` on the pair
    list."""
    m_ = me.long()
    unbroken = ((st.bond_idx[m_] == other[:, None])
                & (st.bond_broken[m_] != 1)).any(-1)
    m = pvalid & ~unbroken & (st.n_bonds[other.long()] < cfg.max_bonds)
    if cfg.dem:
        m = m & (st.n_bonds[m_] < cfg.max_bonds)
    return m


# --------------------------------------------------------------------------
# one substep's forces
# --------------------------------------------------------------------------

def _broken_bond_contact(st, cfg: IcebergsConfig, part):
    """Contact through broken bonds (icebergs.F90:1789-1792), on the bond
    table's partner fields."""
    bo = st.bond_idx.clamp(min=0)
    bm = (st.bond_idx >= 0) & (st.bond_broken == 1) \
        & st.alive[:, None] & st.alive[bo.long()]
    return _dem.dem_contact_forces(st, cfg, bo, bm, part=part)


def _substep_forces(st, nbr, cfg: IcebergsConfig, dt, pairs=None,
                    part_static=None):
    """One substep's bond and contact accelerations (explicit inner MTS).
    Returns ``(axn, ayn, ang_accel, DemOut or None)``."""
    if cfg.dem:
        part = _dem.bond_partner_fields(st, static=part_static)
        out = _dem.dem_bond_forces(st, cfg, dt, part=part)
        zero = torch.zeros_like(st.uvel)
        IA_x = IA_y = IAd_x = IAd_y = zero
        if cfg.use_broken_bonds_for_substep_contact:
            # contact through broken-bond pairs only, on the bond forces'
            # partner fields
            c = _broken_bond_contact(st, cfg, part)
        else:
            if pairs is not None:
                me, po, pvalid = pairs
                pm = _pair_contact_masks(st, me, po, pvalid, cfg)
                c = _dem.dem_contact_forces_pairs(st, cfg, me, po, pm,
                                                  valid=pvalid)
            else:
                c = _dem.dem_contact_forces(st, cfg, nbr.cand_idx,
                                            _contact_masks(st, nbr, cfg))
            # broken-bond pairs collide too (icebergs.F90:1789-1792)
            b = _broken_bond_contact(st, cfg, part)
            c = tuple(x + y for x, y in zip(c, b))
        IA_x, IA_y = IA_x + c[0], IA_y + c[1]
        IAd_x, IAd_y = IAd_x + c[2], IAd_y + c[3]
        if cfg.constant_interaction_LW:
            M = cfg.constant_length * cfg.constant_width * st.thickness \
                * cfg.rho_bergs
        else:
            M = st.mass
        F_x, F_y, Fd_y = out.F_x, out.F_y, out.Fd_y
        if cfg.dem_beam_test > 0:
            F_x, F_y, Fd_y = _apply_beam_loads(st, cfg, F_x, F_y, Fd_y)
        IA_x = IA_x + F_x / M
        IA_y = IA_y + F_y / M
        IAd_x = IAd_x + out.Fd_x / M
        IAd_y = IAd_y + Fd_y / M
        ang_accel = (out.T + out.T_d) / (0.5 * M
                                         * _dem.moment_radius_sq(cfg, st))
        bond_updates = out
    else:
        # MTS without DEM: bond springs by calculate_force (bonded)
        bo, bv = _forces.bond_partner_table(st)
        uv = dict(u0=st.uvel, v0=st.vvel, u1=st.uvel, v1=st.vvel)
        ia_b = _forces.pair_forces(st, cfg, bo, bv, bonded=True,
                                   use_c_crit_dist=False, **uv)
        ia_c = _forces.pair_forces(st, cfg, nbr.cand_idx,
                                   _contact_masks(st, nbr, cfg),
                                   bonded=False, use_c_crit_dist=True, **uv)
        du, dv = st.uvel_old, st.vvel_old

        def damp(ia):
            # explicit damping IAd = P (u_other_old - u_self_old): the
            # matrix form folds u_self in via Pu - P u_self
            return (ia.Pu_x - (ia.P11 * du + ia.P12 * dv),
                    ia.Pu_y - (ia.P21 * du + ia.P22 * dv))

        bdx, bdy = damp(ia_b)
        cdx, cdy = damp(ia_c)
        IA_x = ia_b.IA_x + ia_c.IA_x
        IA_y = ia_b.IA_y + ia_c.IA_y
        IAd_x, IAd_y = bdx + cdx, bdy + cdy
        ang_accel = torch.zeros_like(IA_x)
        bond_updates = None
    return IA_x + IAd_x, IA_y + IAd_y, ang_accel, bond_updates


def _inner_accel_implicit(s, nbr, cfg: IcebergsConfig, dtf, axn_in,
                          ayn_in):
    """Implicit inner substep acceleration (accel_mts with mts_part=3 and
    only interactive forces, icebergs.F90:1480-1547): the springs in
    axn, the damping projections solved implicitly with scaling 0.5.
    Returns ``(ax, ay, axn, ayn, bxn, byn)``."""
    scaling = 0.5
    ia_fn = _forces.make_ia_fn(s, nbr, cfg, mts_part=3)
    u_star = s.uvel + 0.5 * dtf * axn_in
    v_star = s.vvel + 0.5 * dtf * ayn_in
    uveln, vveln = s.uvel, s.vvel
    ax = ay = torch.zeros_like(u_star)
    for itloop in (1, 2):
        ia = ia_fn(uveln, vveln)
        RHS_x = (ia.IA_x / 2.) - scaling * (
            (ia.P11 * u_star + ia.P12 * v_star) - ia.Pu_x)
        RHS_y = (ia.IA_y / 2.) - scaling * (
            (ia.P21 * u_star + ia.P22 * v_star) - ia.Pu_y)
        A11 = 1. + scaling * dtf * ia.P11
        A22 = 1. + scaling * dtf * ia.P22
        A12 = scaling * dtf * ia.P12
        A21 = scaling * dtf * ia.P21
        detA = rdiv(1., A11 * A22 - A12 * A21)
        ax = detA * (A22 * RHS_x - A12 * RHS_y)
        ay = detA * (A11 * RHS_y - A21 * RHS_x)
        uveln = u_star + dtf * ax
        vveln = v_star + dtf * ay
    axn, ayn = ia.IA_x, ia.IA_y
    return ax, ay, axn, ayn, 2. * ax - axn, 2. * ay - ayn


def _apply_beam_loads(st, cfg: IcebergsConfig, F_x, F_y, Fd_y):
    """DEM beam-test loads (icebergs.F90:1861-1877): a simply supported
    beam (pinned ends, centre load) or a cantilever (end load); the ends
    are the extreme live ``start_lon``, as dem_tests_init finds them."""
    start = torch.where(st.alive, st.start_lon, float("inf")).min()
    end = torch.where(st.alive, st.start_lon, float("-inf")).max()
    if cfg.dem_beam_test == 1:
        is_end = (st.start_lon == start) | (st.start_lon == end)
        is_mid = st.start_lon == 0.5 * (start + end)
        F_y = torch.where(is_end, 0., F_y)
        Fd_y = torch.where(is_end, 0., Fd_y)
        F_y = torch.where(is_mid, F_y - 1.5e5, F_y)
    elif cfg.dem_beam_test == 2:
        F_y = torch.where(st.start_lon == end, F_y - 1.5e10 / 3., F_y)
    return F_x, F_y, Fd_y


def _msum(moving, x):
    return torch.where(moving, x, 0.).sum()


def _substeps_scan(st, cfg: IcebergsConfig, nbr, pairs, moving,
                   broken_total, sync: bool = False):
    """All ``n_sub_steps`` fast substeps as a Python loop (the JAX
    package's ``lax.scan``), a generator of :class:`MtsEvent`: with
    ``sync`` each substep starts from the state its driver sends back.
    Returns ``(state, broken_total, inner_conv_iters)``."""
    counted = moving & (st.halo_berg < 0.5)

    def sel(new, old):
        return torch.where(moving, new, old)

    dtf = cfg.dt / max(cfg.n_sub_steps, 1)
    dtf_2 = 0.5 * dtf
    # partner columns constant across substeps: one gather an outer step
    part_static = _dem.bond_partner_static(st) if cfg.dem else None
    explicit_inner = cfg.explicit_inner_mts or cfg.dem
    bm = moving[:, None]
    inner_iters = 0
    s = st
    for _ in range(cfg.n_sub_steps):
        if sync:
            s = yield MtsEvent("sync", s)
        # drift (icebergs.F90:6790-6831)
        uvel2 = s.uvel + dtf_2 * (s.axn_fast + s.bxn_fast)
        vvel2 = s.vvel + dtf_2 * (s.ayn_fast + s.byn_fast)
        lonn, latn = _advance_position(cfg, s.lon, s.lat, uvel2, vvel2, dtf)
        # u_old <- u* for the interactions; the v component reads
        # bxn_fast, as the reference does (icebergs.F90:6826-6827)
        s = s.replace(lon=sel(lonn, s.lon), lat=sel(latn, s.lat),
                      lon_old=sel(lonn, s.lon_old),
                      lat_old=sel(latn, s.lat_old),
                      uvel_old=sel(s.uvel + dtf_2 * (s.axn_fast
                                                     + s.bxn_fast),
                                   s.uvel_old),
                      vvel_old=sel(s.vvel + dtf_2 * (s.ayn_fast
                                                     + s.bxn_fast),
                                   s.vvel_old))
        # kick
        axn_in = s.axn_fast + s.bxn_fast
        ayn_in = s.ayn_fast + s.byn_fast
        uvel3 = s.uvel + dtf_2 * axn_in
        vvel3 = s.vvel + dtf_2 * ayn_in
        if explicit_inner:
            axn, ayn, ang_accel, bu = _substep_forces(
                s, nbr, cfg, dtf, pairs=pairs, part_static=part_static)
            if cfg.short_step_mts_grounding:
                gdrag = _dem.grounding_drag_coeff(
                    cfg, s.thickness, s.od, s.mass, s.length, s.width,
                    "rect")
                axn = axn + s.uvel * gdrag
                ayn = ayn + s.vvel * gdrag
            bxn = torch.zeros_like(axn)
            byn = torch.zeros_like(ayn)
            uveln = uvel3 + dtf * (0.5 * axn)
            vveln = vvel3 + dtf * (0.5 * ayn)
        else:
            # implicit inner substeps (accel_mts), optionally iterated to
            # convergence (icebergs.F90:6833-6974): one host read of the
            # done flag per iteration
            bu = None
            ang_accel = s.ang_accel

            def kick(sv):
                ax, ay, axn, ayn, bxn, byn = _inner_accel_implicit(
                    sv, nbr, cfg, dtf, axn_in, ayn_in)
                return (uvel3 + dtf * ax, vvel3 + dtf * ay, axn, ayn, bxn,
                        byn)

            uveln, vveln, axn, ayn, bxn, byn = kick(s)
            if cfg.force_convergence:
                sv, it, done = s, 0, False
                while not done and it < 30:
                    sv = sv.replace(uvel_old=sel(uveln, sv.uvel_old),
                                    vvel_old=sel(vveln, sv.vvel_old))
                    un2, vn2, axn, ayn, bxn, byn = kick(sv)
                    usum = _msum(counted, uveln * uveln + vveln * vveln)
                    usum1 = _msum(counted, un2 * un2 + vn2 * vn2)
                    d1, d2 = un2 - uveln, vn2 - vveln
                    usum2 = _msum(counted, d1 * d1 + d2 * d2)
                    uveln, vveln = un2, vn2
                    it += 1
                    done = yield MtsEvent("conv", (
                        usum, usum1, usum2, None, cfg.convergence_tolerance))
                inner_iters += it
        s = s.replace(
            axn_fast=sel(axn, s.axn_fast), ayn_fast=sel(ayn, s.ayn_fast),
            bxn_fast=sel(bxn, s.bxn_fast), byn_fast=sel(byn, s.byn_fast),
            uvel=sel(uveln, s.uvel), vvel=sel(vveln, s.vvel),
            uvel_old=sel(uveln, s.uvel_old),
            vvel_old=sel(vveln, s.vvel_old),
            ang_accel=sel(ang_accel, s.ang_accel))
        if bu is not None:
            s = s.replace(
                bond_length=torch.where(bm, bu.bond_length, s.bond_length),
                bond_tangd1=torch.where(bm, bu.tangd1, s.bond_tangd1),
                bond_tangd2=torch.where(bm, bu.tangd2, s.bond_tangd2),
                bond_rel_rotation=torch.where(bm, bu.rel_rotation,
                                              s.bond_rel_rotation),
                bond_nstress=torch.where(bm, bu.nstress, s.bond_nstress),
                bond_sstress=torch.where(bm, bu.sstress, s.bond_sstress))
            if bu.broken is not None:
                # the in-kernel per-substep fracture (icebergs.F90:
                # 1140-1199)
                newly = bm & (bu.broken == 1) & (s.bond_broken != 1)
                broken_total = broken_total + newly.sum(dtype=torch.int32)
                brok = torch.where(bm, bu.broken, s.bond_broken)
                s = s.replace(bond_broken=brok, n_bonds=(
                    (s.bond_idx >= 0) & (brok != 1)).sum(dim=1).to(s.dtype))
        if cfg.dem:
            if cfg.use_grounding_torque:
                gdrag = _dem.grounding_drag_coeff(
                    cfg, s.thickness, s.od, s.mass, s.length, s.width,
                    "disk", scan=True)
            else:
                gdrag = torch.zeros_like(s.ang_vel)
            av = (s.ang_vel + dtf * s.ang_accel) / (1. - gdrag * dtf)
            s = s.replace(ang_vel=sel(av, s.ang_vel),
                          rot=sel(s.rot + dtf * av, s.rot))
            if cfg.break_bonds_on_sub_steps \
                    and not cfg.use_broken_bonds_for_substep_contact:
                # the idempotent partner pass (the in-kernel break above
                # already marked both directed lanes)
                s, nb2 = _dem.break_bonds_dem(s, cfg)
                broken_total = broken_total + nb2
    return s, broken_total, inner_iters


# --------------------------------------------------------------------------
# the outer step
# --------------------------------------------------------------------------

def evolve_icebergs_mts(st, grid: Grid, frc, cfg: IcebergsConfig, *,
                        pair_cap: Optional[int] = None,
                        contact_cap: Optional[int] = None,
                        substep_sync=None,
                        ncells_radius: Optional[int] = None,
                        max_per_cell: int = 16,
                        neighbor_mode: str = "tables",
                        fused_kw: Optional[dict] = None,
                        substep_kernel: str = "scan",
                        vmem_deltas=None, vmem_block_n: int = 512):
    """Full MTS cycle: Part 1 slow solve, Part 2 half-kick, Part 3
    substeps, then re-localization on the grid.  Returns ``(state,
    MtsDiags)``.  ``substep_sync`` (state -> state), if given, runs at
    the top of every substep, and the substeps run as the scan.  The
    other keywords are :func:`evolve_icebergs_mts_sequence`'s."""
    return drive_mts(evolve_icebergs_mts_sequence(
        st, grid, frc, cfg, pair_cap=pair_cap, contact_cap=contact_cap,
        sync=substep_sync is not None, ncells_radius=ncells_radius,
        max_per_cell=max_per_cell, neighbor_mode=neighbor_mode,
        fused_kw=fused_kw, substep_kernel=substep_kernel,
        vmem_deltas=vmem_deltas, vmem_block_n=vmem_block_n), substep_sync)


def evolve_icebergs_mts_sequence(st, grid: Grid, frc, cfg: IcebergsConfig,
                                 *, pair_cap: Optional[int] = None,
                                 contact_cap: Optional[int] = None,
                                 sync: bool = False,
                                 ncells_radius: Optional[int] = None,
                                 max_per_cell: int = 16,
                                 neighbor_mode: str = "tables",
                                 fused_kw: Optional[dict] = None,
                                 substep_kernel: str = "scan",
                                 vmem_deltas=None, vmem_block_n: int = 512):
    """The MTS cycle as a generator of :class:`MtsEvent` (see
    :func:`drive_mts`), returning ``(state, MtsDiags)``.  The convergence
    norms count the owned moving elements (a tile's halo copies and
    replicas are not its own); with ``sync`` every substep yields its
    state first and the substeps run as the scan.

    ``neighbor_mode="fused"`` searches Part 1's collision group with K2;
    any other mode builds the candidate tables (``max_per_cell``,
    ``ncells_radius``) and evaluates the group through K7, compacted to
    ``contact_cap`` rows when given.  The tables are also the substep
    contact candidates of DEM without
    ``use_broken_bonds_for_substep_contact`` and of MTS without DEM;
    ``pair_cap`` then compacts the DEM candidates into a frozen pair list
    of that capacity (:func:`compact_conglom_pairs`; size it with
    :func:`auto_pair_cap`).  ``substep_kernel="vmem"`` with
    ``vmem_deltas`` from :func:`.ops.dem_substeps.analyze_bond_deltas`
    runs the substeps in K4; otherwise they run as the scan."""
    dt = cfg.dt
    dt_2 = 0.5 * dt
    moving = st.alive & (st.static_berg < 0.5)
    counted = moving & (st.halo_berg < 0.5)
    radius = (ncells_radius if ncells_radius is not None
              else _forces.neighbor_radius(grid, cfg))

    def sel(new, old):
        return torch.where(moving, new, old)

    # the candidate tables: Part 1's collision group off the fused search,
    # and the substep contact candidates off the broken-bond table
    need_nbr = neighbor_mode != "fused" or not (
        cfg.dem and cfg.use_broken_bonds_for_substep_contact)
    nbr = _forces.build_neighbor_tables(
        st, grid, cfg, max_per_cell=max_per_cell,
        ncells_radius=radius) if need_nbr else None

    # ---- PART 1: slow forces --------------------------------------------
    # pair search and geometry once: positions are frozen during the
    # convergence loop, only the *_old velocities iterate
    p1_fallback = None
    if neighbor_mode == "fused":
        fkw = dict(fallback_cap=cfg.fused_fallback_cap)
        fkw.update(fused_kw or {})
        part1_refresh, p1stats = make_ia_fn_fused_mts1(
            st, grid, cfg, radius=radius, **fkw)
        p1_overflow, p1_fallback = p1stats.overflow, p1stats.n_fallback
    else:
        part1_refresh = _forces.make_ia_fn(st, nbr, cfg, mts_part=1,
                                           contact_cap=contact_cap,
                                           return_refresh=True)
        p1_overflow = part1_refresh.overflow

    def part1_once(s):
        return _slow_accel_mts(s, cfg, part1_refresh(s))

    conv_iters = 0
    broken_total = torch.zeros((), dtype=torch.int32, device=st.device)
    if not cfg.skip_first_outer_mts_step:
        if cfg.force_convergence:
            # fixed-point iteration on V_{n+1} until the velocity-change
            # norm is below tolerance (icebergs.F90:6663-6743)
            done = False
            while not done and conv_iters < 50:
                ax, ay, axn, ayn, bxn, byn, fdc = part1_once(st)
                up = sel(st.uvel + dt * ax, st.uvel_prev)
                vp = sel(st.vvel + dt * ay, st.vvel_prev)
                usum = _msum(counted, st.uvel_old * st.uvel_old
                             + st.vvel_old * st.vvel_old)
                usum1 = _msum(counted, up * up + vp * vp)
                du, dv = up - st.uvel_old, vp - st.vvel_old
                usum2 = _msum(counted, du * du + dv * dv)
                had_collision = (counted & (fdc != 0.)).any()
                st = st.replace(axn=sel(axn, st.axn), ayn=sel(ayn, st.ayn),
                                bxn=sel(bxn, st.bxn), byn=sel(byn, st.byn),
                                uvel_prev=up, vvel_prev=vp,
                                uvel_old=sel(up, st.uvel_old),
                                vvel_old=sel(vp, st.vvel_old))
                conv_iters += 1
                # the loop's one host sync
                done = yield MtsEvent("conv", (
                    usum, usum1, usum2, had_collision,
                    cfg.convergence_tolerance))
        else:
            ax, ay, axn, ayn, bxn, byn, _ = part1_once(st)
            st = st.replace(
                axn=sel(axn, st.axn), ayn=sel(ayn, st.ayn),
                bxn=sel(bxn, st.bxn), byn=sel(byn, st.byn),
                uvel=sel(st.uvel + dt * ax, st.uvel),
                vvel=sel(st.vvel + dt * ay, st.vvel))
            st = st.replace(uvel_prev=sel(st.uvel, st.uvel_prev),
                            vvel_prev=sel(st.vvel, st.vvel_prev))

        # outer-step fracture when the substeps do not break bonds
        if cfg.dem and not cfg.break_bonds_on_sub_steps:
            st, nb = _dem.break_bonds_dem(st, cfg)
            broken_total = broken_total + nb

        # ---- PART 2: half-kick by the slow acceleration ------------------
        u0 = st.uvel_prev + dt_2 * (st.axn + st.bxn)
        v0 = st.vvel_prev + dt_2 * (st.ayn + st.byn)
        st = st.replace(uvel=sel(u0, st.uvel), vvel=sel(v0, st.vvel),
                        uvel_old=sel(u0, st.uvel_old),
                        vvel_old=sel(v0, st.vvel_old))
        if cfg.force_convergence:
            st = st.replace(axn=sel(st.axn_fast, st.axn),
                            ayn=sel(st.ayn_fast, st.ayn),
                            bxn=sel(st.bxn_fast, st.bxn),
                            byn=sel(st.byn_fast, st.byn))

    # ---- PART 3: fast substeps ------------------------------------------
    skin_dropped = torch.zeros((), dtype=torch.int32, device=st.device)
    pair_overflow = None
    inner_iters = 0
    if substep_kernel == "vmem" and not sync and cfg.n_sub_steps > 0:
        if not supports_vmem_substeps(cfg):
            raise ValueError("substep kernel: unsupported flag set")
        if vmem_deltas is None:
            raise ValueError("substep kernel 'vmem' needs vmem_deltas "
                             "(analyze_bond_deltas)")
        st, nb = part3_substeps_vmem(st, cfg, vmem_deltas,
                                     block_n=vmem_block_n)
        broken_total = broken_total + nb
    elif cfg.n_sub_steps > 0:
        pairs = None
        if (pair_cap is not None and cfg.dem
                and not cfg.use_broken_bonds_for_substep_contact):
            me, ot, pv, pair_overflow, skin_dropped = compact_conglom_pairs(
                st, nbr, pair_cap, cfg=cfg, dt=cfg.dt)
            pairs = (me, ot, pv)
        st, broken_total, inner_iters = yield from _substeps_scan(
            st, cfg, nbr, pairs, moving, broken_total, sync)

    # finalize: re-localize on the grid (icebergs.F90:7056-7075)
    st = st.replace(uvel_old=sel(st.uvel, st.uvel_old),
                    vvel_old=sel(st.vvel, st.vvel_old))
    lonn, latn, i, j, xi, yj, _ = adjust_index_and_ground(
        grid, cfg, st.lon, st.lat, st.ine, st.jne, None)
    st = st.replace(lon=sel(lonn, st.lon), lat=sel(latn, st.lat),
                    lon_old=sel(lonn, st.lon_old),
                    lat_old=sel(latn, st.lat_old),
                    ine=torch.where(moving, i, st.ine),
                    jne=torch.where(moving, j, st.jne),
                    xi=sel(xi, st.xi), yj=sel(yj, st.yj))
    return st, MtsDiags(broken_bonds=broken_total, conv_iters=conv_iters,
                        p1_overflow=p1_overflow, p1_fallback=p1_fallback,
                        skin_dropped=skin_dropped,
                        pair_overflow=pair_overflow,
                        inner_conv_iters=inner_iters)

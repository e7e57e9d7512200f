"""Multiple-time-stepping velocity Verlet (MTS) with the iKID DEM loop.

Counterpart of ``icebergs_tpu/mts.py`` (``MtsDiags``, ``_slow_accel_mts``,
``evolve_icebergs_mts``; ``_grounding_drag_coeff`` is
:func:`.ops.dem.grounding_drag_coeff`; port of
``evolve_icebergs_mts``, ``src/icebergs.F90:6576-7078``) on the route of
the DEM flag set:

* **Part 1** — V_{n+1} from the slow forces plus the cross-conglomerate
  collision group (:func:`.ops.fused_contact.make_ia_fn_fused_mts1`, K2
  with the conglomerate filter), iterated to ``force_convergence``;
* **Part 2** — the half-kick by the slow acceleration;
* **Part 3** — all ``n_sub_steps`` explicit DEM substeps in one launch
  of K4 (:mod:`.ops.dem_substeps`) on the conglomerate-blocked layout.

The convergence ``lax.while_loop`` is a Python loop that reads its
``done`` flag on the host once per iteration (one sync each).  The scan
substep path (``substep_kernel="scan"``: ``ops/dem.py``'s bond and contact
forces, ``break_bonds_dem``, ``compact_conglom_pairs``, implicit inner
substeps) is ROADMAP.md Queue 1 item 16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import constants as C
from .config import IcebergsConfig
from .dynamics import adjust_index_and_ground
from .grid import Grid
from .ops.accel import coriolis, rdiv
from .ops.dem import tdiv
from .ops.dem_substeps import part3_substeps_vmem, supports_vmem_substeps
from .ops.fused_contact import make_ia_fn_fused_mts1


class MtsDiags(NamedTuple):
    broken_bonds: torch.Tensor       # 0-dim int32
    conv_iters: int                  # Part-1 iterations run (host count)
    p1_overflow: Optional[torch.Tensor] = None  # Part-1 fallback drops
    # Part-1 rows on the exact fallback (not in the JAX MtsDiags)
    p1_fallback: Optional[torch.Tensor] = None


def _slow_accel_mts(st, cfg: IcebergsConfig, ia_fn):
    """Part-1 acceleration (accel_mts with mts_part=1): u* = V_k, every
    explicit term in axn, the implicit 2x2 solve with scaling 0.5 and
    Crank-Nicolson Coriolis.  Returns (ax, ay, axn, ayn, bxn, byn,
    |Fdc|)."""
    scaling = 0.5
    u_star, v_star = st.uvel, st.vvel
    uvel0, vvel0 = st.uvel, st.vvel
    dt = cfg.dt
    if cfg.grid_is_latlon and not cfg.use_f_plane:
        raise NotImplementedError(
            "latitude-dependent Coriolis (ROADMAP.md Queue 1 item 11)")
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
    if cfg.dem and cfg.hexagonal_icebergs and cfg.radius_based_drag:
        raise NotImplementedError("hexagonal DEM faces (ROADMAP.md Queue 1 "
                                  "item 11)")
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


def evolve_icebergs_mts(st, grid: Grid, frc, cfg: IcebergsConfig, *,
                        neighbor_mode: str = "fused",
                        fused_kw: Optional[dict] = None,
                        ncells_radius: Optional[int] = None,
                        substep_kernel: str = "vmem",
                        vmem_deltas=None, vmem_block_n: int = 512):
    """Full MTS cycle: Part 1 slow solve, Part 2 half-kick, Part 3
    substeps (K4), then re-localization on the grid.

    ``vmem_deltas`` come from :func:`.ops.dem_substeps.analyze_bond_deltas`
    on the state's bond table (host side, before the run).  Returns
    ``(state, MtsDiags)``."""
    if neighbor_mode != "fused" or not (
            cfg.dem and cfg.use_broken_bonds_for_substep_contact):
        raise NotImplementedError(
            f"neighbor_mode={neighbor_mode!r} / the substep pair lists "
            "(ROADMAP.md Queue 1 item 16)")
    if cfg.n_sub_steps > 0 and (substep_kernel != "vmem"
                                or vmem_deltas is None):
        raise NotImplementedError(
            f"substep_kernel={substep_kernel!r} with deltas "
            f"{vmem_deltas!r}: the scan substep path (ROADMAP.md Queue 1 "
            "item 16)")
    if not supports_vmem_substeps(cfg):
        raise NotImplementedError("substep flag set outside K4 (ROADMAP.md "
                                  "Queue 1 item 16)")
    dt = cfg.dt
    dt_2 = 0.5 * dt
    moving = st.alive & (st.static_berg < 0.5)

    def sel(new, old):
        return torch.where(moving, new, old)

    # ---- PART 1: slow forces --------------------------------------------
    # pair search and geometry once: positions are frozen during the
    # convergence loop, only the *_old velocities iterate
    fkw = dict(fallback_cap=cfg.fused_fallback_cap)
    fkw.update(fused_kw or {})
    part1_refresh, p1stats = make_ia_fn_fused_mts1(
        st, grid, cfg, radius=ncells_radius, **fkw)

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

                def msum(x):
                    return torch.where(moving, x, 0.).sum()
                usum = msum(st.uvel_old * st.uvel_old
                            + st.vvel_old * st.vvel_old)
                usum1 = msum(up * up + vp * vp)
                du, dv = up - st.uvel_old, vp - st.vvel_old
                usum2 = msum(du * du + dv * dv)
                denom = torch.sqrt(usum) + torch.sqrt(usum1)
                normchange = torch.where(
                    denom > 0., 2. * torch.sqrt(usum2) / denom, 0.)
                had_collision = (moving & (fdc != 0.)).any()
                done_t = (~had_collision) | (normchange
                                             < cfg.convergence_tolerance)
                st = st.replace(axn=sel(axn, st.axn), ayn=sel(ayn, st.ayn),
                                bxn=sel(bxn, st.bxn), byn=sel(byn, st.byn),
                                uvel_prev=up, vvel_prev=vp,
                                uvel_old=sel(up, st.uvel_old),
                                vvel_old=sel(vp, st.vvel_old))
                conv_iters += 1
                done = bool(done_t)          # the loop's one host sync
        else:
            ax, ay, axn, ayn, bxn, byn, _ = part1_once(st)
            st = st.replace(
                axn=sel(axn, st.axn), ayn=sel(ayn, st.ayn),
                bxn=sel(bxn, st.bxn), byn=sel(byn, st.byn),
                uvel=sel(st.uvel + dt * ax, st.uvel),
                vvel=sel(st.vvel + dt * ay, st.vvel))
            st = st.replace(uvel_prev=sel(st.uvel, st.uvel_prev),
                            vvel_prev=sel(st.vvel, st.vvel_prev))

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

    # ---- PART 3: fast substeps, one K4 launch ---------------------------
    if cfg.n_sub_steps > 0:
        st, nb = part3_substeps_vmem(st, cfg, vmem_deltas,
                                     block_n=vmem_block_n)
        broken_total = broken_total + nb

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
                        p1_overflow=p1stats.overflow,
                        p1_fallback=p1stats.n_fallback)

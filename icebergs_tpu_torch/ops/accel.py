"""Momentum kernel: instantaneous iceberg acceleration.

Counterpart of ``icebergs_tpu/ops/accel.py`` (``accel``, port of
``src/icebergs.F90:1949-2443``): Coriolis, wave radiation, quadratic
drag, grounding ramp, surface slope, the berg-berg interaction closure,
the two-pass drag predictor-corrector and the implicit 2x2 solve, one
elementwise expression per term in the same order.

A Python scalar divided by a tensor is written ``rdiv(c, x)``: torch's
``c / x`` is ``x.reciprocal() * c``, which rounds differently from the
reference's true division.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import constants as C
from ..config import IcebergsConfig


class IA(NamedTuple):
    """Interaction accelerations + damping projection (interactive_force)."""
    IA_x: torch.Tensor
    IA_y: torch.Tensor
    P11: torch.Tensor
    P12: torch.Tensor
    P21: torch.Tensor
    P22: torch.Tensor
    Pu_x: torch.Tensor
    Pu_y: torch.Tensor


def zero_ia(like) -> IA:
    z = torch.zeros_like(like)
    return IA(z, z, z, z, z, z, z, z)


class AccelOut(NamedTuple):
    ax: torch.Tensor
    ay: torch.Tensor
    axn: torch.Tensor
    ayn: torch.Tensor
    bxn: torch.Tensor
    byn: torch.Tensor
    tickets: torch.Tensor


def rdiv(c: float, x):
    """``c / x`` for a Python scalar ``c``, correctly rounded."""
    return torch.div(x.new_full((), c), x)


def divc(x, c: float):
    """``x / c`` for a Python scalar ``c``, correctly rounded on any
    device (the card turns a Python-scalar divisor into a product with
    ``1 / c``; a 0-dim divisor keeps the division)."""
    return torch.div(x, x.new_full((), c))


def f32_scalar(fn, x: float, dtype=torch.float32) -> float:
    """``fn`` of a Python scalar evaluated in float32 (or the state's
    ``dtype``) on the host (a JAX weak-typed scalar op); the result is
    exact as a Python float, so no device scalar (and no host-device
    copy) is made."""
    return float(fn(torch.tensor(x, dtype=dtype)))


def coriolis(cfg: IcebergsConfig, lat):
    """The Coriolis parameter: ``2 Omega sin(PI_180 lat)`` per berg on a
    lat-lon grid unless ``use_f_plane``, else the f-plane value at
    ``cfg.lat_ref``; the two factors multiply in float32 as in JAX."""
    if cfg.grid_is_latlon and not cfg.use_f_plane:
        return torch.sin(lat * C.PI_180) * (2. * C.OMEGA)
    f = f32_scalar(lambda s: torch.tensor(2. * C.OMEGA,
                                          dtype=torch.float32)
                   * torch.sin(s), C.PI_180 * cfg.lat_ref)
    return f * torch.ones_like(lat)


def accel(cfg: IcebergsConfig, grid, *, lat, mass, thickness, width, length,
          n_bonds, env, uvel, vvel, uvel0, vvel0, dt, axn_in, ayn_in,
          loc_dx, ia_fn: Optional[Callable] = None) -> AccelOut:
    """Accelerations of every berg (elementwise over the slab); arguments
    as ``icebergs_tpu.ops.accel.accel``."""
    runge = cfg.Runge_not_Verlet
    interactive = cfg.interactive_icebergs_on and ia_fn is not None
    if not runge:
        alpha, beta, C_N = 1.0, 1.0, 1.0
        unpc = True
    else:
        alpha, beta, C_N = 0.0, 1.0, 0.0
        unpc = cfg.use_new_predictive_corrective

    u_star = uvel0 + axn_in * (dt / 2.)
    v_star = vvel0 + ayn_in * (dt / 2.)

    uo, vo, ui, vi, ua, va = env.uo, env.vo, env.ui, env.vi, env.ua, env.va
    ssh_x, ssh_y = env.ssh_x, env.ssh_y
    hi, od = env.hi, env.od

    f_cori = coriolis(cfg, lat)

    M = mass.clamp(min=1e-30)
    T = thickness
    D = (cfg.rho_bergs / C.RHO_SEAWATER) * T
    F = T - D
    W = width
    L = length

    hi = torch.minimum(hi, D)
    D_hi = (D - hi).clamp(min=0.)

    if cfg.h_to_init_grounding > 0.:
        groundfrac = (1.0 - (od - D) / cfg.h_to_init_grounding).clamp(0., 1.)
    else:
        groundfrac = torch.where(D > od, 1.0, 0.0)
    c_gnd = torch.where(groundfrac > 0.,
                        (cfg.cdrag_grounding * W * L * groundfrac) / M, 0.)

    Cr0 = 0.06
    uwave = ua - uo
    vwave = va - vo
    wmod2 = uwave * uwave + vwave * vwave
    ampl = 0.5 * 0.02025 * wmod2
    Lwavelength = 0.32 * wmod2
    Lcutoff = 0.125 * Lwavelength
    Ltop = 0.25 * Lwavelength
    Cr = Cr0 * ((L - Lcutoff) / ((Ltop - Lcutoff) + 1.e-30)).clamp(0., 1.)
    wave_rad = rdiv(0.5 * C.RHO_SEAWATER, M) * Cr * C.GRAVITY * ampl \
        * torch.minimum(ampl, F) * (2. * W * L) \
        / (W + L).clamp(min=1e-30)
    wmod = torch.sqrt(ua * ua + va * va)
    nonzero_wind = wmod != 0.
    wsafe = torch.where(nonzero_wind, wmod, 1.)
    uwave = torch.where(nonzero_wind, ua / wsafe, 0.)
    vwave = torch.where(nonzero_wind, va / wsafe, 0.)
    wave_rad = torch.where(nonzero_wind, wave_rad, 0.)

    if cfg.iceberg_bonds_on and cfg.internal_bergs_for_drag:
        N_max = cfg.n_max_bonds_shape
        dragfrac = (N_max - n_bonds) / N_max
    else:
        dragfrac = torch.ones_like(M)

    c_ocn = rdiv(C.RHO_SEAWATER, M) * cfg.ocean_drag_scale \
        * (0.5 * C.CD_WV * dragfrac * W * D_hi + C.CD_WH * W * L)
    c_atm = rdiv(C.RHO_AIR, M) * (0.5 * C.CD_AV * dragfrac * W * F
                                  + C.CD_AH * W * L)
    c_ice = torch.where(hi.abs() == 0., 0.,
                        rdiv(C.RHO_ICE, M) * (0.5 * C.CD_IV * dragfrac * W
                                              * hi))
    c_ice = torch.where(ui.abs() + vi.abs() == 0., 0., c_ice)

    zero = torch.zeros_like(M)
    axn = ayn = bxn = byn = zero

    gx = -C.GRAVITY * ssh_x + wave_rad * uwave
    gy = -C.GRAVITY * ssh_y + wave_rad * vwave
    if not runge:
        axn, ayn = gx, gy
    else:
        bxn, byn = gx, gy

    ia = ia_fn(uvel0, vvel0) if interactive else zero_ia(M)
    if interactive:
        if not runge:
            axn = axn + ia.IA_x
            ayn = ayn + ia.IA_y
        else:
            bxn = bxn + ia.IA_x
            byn = byn + ia.IA_y

    if alpha > 0.:
        if C_N > 0.:
            axn = axn + f_cori * v_star
            ayn = ayn - f_cori * u_star
        else:
            bxn = bxn + f_cori * v_star
            byn = byn - f_cori * u_star
    else:
        bxn = bxn + f_cori * vvel
        byn = byn - f_cori * uvel

    if unpc:
        uveln, vveln = uvel0, vvel0
    else:
        uveln, vveln = uvel, vvel

    def spd(a, b):
        return torch.sqrt(a * a + b * b)

    ax = ay = zero
    for itloop in (1, 2):   # drag predictor-corrector (icebergs.F90:2192)
        us, vs = (uvel0, vvel0) if itloop == 1 else (uveln, vveln)
        if unpc:
            drag_ocn = c_ocn * 0.5 * (spd(uveln - uo, vveln - vo)
                                      + spd(uvel0 - uo, vvel0 - vo))
            drag_atm = c_atm * 0.5 * (spd(uveln - ua, vveln - va)
                                      + spd(uvel0 - ua, vvel0 - va))
            drag_ice = c_ice * 0.5 * (spd(uveln - ui, vveln - vi)
                                      + spd(uvel0 - ui, vvel0 - vi))
        else:
            usm = 0.5 * (uveln + uvel)
            vsm = 0.5 * (vveln + vvel)
            drag_ocn = c_ocn * spd(usm - uo, vsm - vo)
            drag_atm = c_atm * spd(usm - ua, vsm - va)
            drag_ice = c_ice * spd(usm - ui, vsm - vi)
            us, vs = usm, vsm
        drag_gnd = c_gnd

        RHS_x = (axn / 2.) + bxn
        RHS_y = (ayn / 2.) + byn
        if beta > 0.:
            RHS_x = RHS_x - drag_ocn * (u_star - uo) \
                - drag_atm * (u_star - ua) \
                - drag_ice * (u_star - ui) - drag_gnd * u_star
            RHS_y = RHS_y - drag_ocn * (v_star - vo) \
                - drag_atm * (v_star - va) \
                - drag_ice * (v_star - vi) - drag_gnd * v_star
        else:
            RHS_x = RHS_x - drag_ocn * (uvel - uo) - drag_atm * (uvel - ua) \
                - drag_ice * (uvel - ui) - drag_gnd * uvel
            RHS_y = RHS_y - drag_ocn * (vvel - vo) - drag_atm * (vvel - va) \
                - drag_ice * (vvel - vi) - drag_gnd * vvel

        if interactive:
            if itloop > 1:
                ia = ia_fn(us, vs)
            if beta > 0.:
                RHS_x = RHS_x - ((ia.P11 * u_star + ia.P12 * v_star)
                                 - ia.Pu_x)
                RHS_y = RHS_y - ((ia.P21 * u_star + ia.P22 * v_star)
                                 - ia.Pu_y)
            else:
                RHS_x = RHS_x - ((ia.P11 * uvel + ia.P12 * vvel) - ia.Pu_x)
                RHS_y = RHS_y - ((ia.P21 * uvel + ia.P22 * vvel) - ia.Pu_y)

        if alpha + beta > 0.:
            if cfg.only_interactive_forces:
                RHS_x = (ia.IA_x / 2.) - ((ia.P11 * u_star + ia.P12 * v_star)
                                          - ia.Pu_x)
                RHS_y = (ia.IA_y / 2.) - ((ia.P21 * u_star + ia.P22 * v_star)
                                          - ia.Pu_y)
                A11 = 1. + dt * ia.P11
                A12 = dt * ia.P12
                A21 = dt * ia.P21
                A22 = 1. + dt * ia.P22
            else:
                lam = drag_ocn + drag_atm + drag_ice + drag_gnd
                A11 = 1. + beta * dt * lam
                A22 = 1. + beta * dt * lam
                A12 = -alpha * dt * f_cori
                A21 = alpha * dt * f_cori
                if C_N > 0.:
                    A12 = A12 / 2.
                    A21 = A21 / 2.
                if interactive:
                    A11 = A11 + dt * ia.P11
                    A12 = A12 + dt * ia.P12
                    A21 = A21 + dt * ia.P21
                    A22 = A22 + dt * ia.P22
            detA = rdiv(1., (A11 * A22) - (A12 * A21))
            ax = detA * (A22 * RHS_x - A12 * RHS_y)
            ay = detA * (A11 * RHS_y - A21 * RHS_x)
        else:
            ax, ay = RHS_x, RHS_y

        uveln = u_star + dt * ax
        vveln = v_star + dt * ay

    if cfg.only_interactive_forces:
        axn, ayn = ia.IA_x, ia.IA_y
    else:
        axn = ayn = zero
        if not runge:
            axn = -C.GRAVITY * ssh_x + wave_rad * uwave
            ayn = -C.GRAVITY * ssh_y + wave_rad * vwave
            if interactive:
                axn = axn + ia.IA_x
                ayn = ayn + ia.IA_y
        if C_N > 0.:
            axn = axn + f_cori * vveln
            ayn = ayn - f_cori * uveln
    bxn = ax - (axn / 2.)
    byn = ay - (ayn / 2.)

    speed = spd(uveln, vveln)
    if cfg.speed_limit > 0.:
        new_speed = loc_dx / dt * abs(cfg.speed_limit)
        tickets = (speed > 0.) & (new_speed < speed)
    else:
        tickets = torch.zeros_like(speed, dtype=torch.bool)

    if cfg.override_iceberg_velocities:
        return AccelOut(zero, zero, zero, zero, zero, zero, tickets)
    return AccelOut(ax, ay, axn, ayn, bxn, byn, tickets)

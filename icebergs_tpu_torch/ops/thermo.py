"""Thermodynamics: melt laws, basal-melt boundary-layer model, rolling.

Counterpart of ``icebergs_tpu/ops/thermo.py`` (``thermodynamics``,
``find_basal_melt``, ``rolling``, ``fl_bits_dimensions``,
``melt_by_class_field``; port of ``src/icebergs.F90:2844-3389,
3492-3828``), footloose's foot accumulation and the promotion of a
melted parent's footloose bits included.  The 14 per-berg melt columns are summed per cell in one of
three ways, as the JAX package sums them: deferred to the spreading pass
(``defer_cell_cols`` with ``parallel_reprod``), where they ride its
segment sums; in (cell, id) order by the reproducing slot sums
(``parallel_reprod`` alone, :func:`.spread.scatter_cell_deterministic`);
or by a plain accumulating scatter (``parallel_reprod=False``).  The
iterative 3-equation solve keeps its fixed trip counts (20 outer x 30
inner masked iterations) as Python loops.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import constants as C
from ..config import IcebergsConfig
from .accel import coriolis, divc, rdiv


# the 14 gridded melt fields, in the order of the per-berg melt columns
MELT_FIELDS = ("floating_melt", "calving_hflx", "berg_melt", "bergy_src",
               "bergy_melt", "fl_bits_melt", "melt_buoy", "melt_eros",
               "melt_conv", "fl_parent_melt", "fl_child_melt",
               "melt_buoy_fl", "melt_eros_fl", "melt_conv_fl")


class MeltDiags(NamedTuple):
    net_heat: torch.Tensor          # J into the ocean this step (0-dim)
    nbergs_melted: torch.Tensor
    # the 14 per-berg melt columns (MELT_FIELDS), reduced per cell by the
    # caller when deferred
    deferred_cols: Optional[list] = None
    # the 14 gridded fields (nx+2, ny+2) when not deferred
    floating_melt: Optional[torch.Tensor] = None
    calving_hflx: Optional[torch.Tensor] = None
    berg_melt: Optional[torch.Tensor] = None
    bergy_src: Optional[torch.Tensor] = None
    bergy_melt: Optional[torch.Tensor] = None
    fl_bits_melt: Optional[torch.Tensor] = None
    melt_buoy: Optional[torch.Tensor] = None
    melt_eros: Optional[torch.Tensor] = None
    melt_conv: Optional[torch.Tensor] = None
    fl_parent_melt: Optional[torch.Tensor] = None
    fl_child_melt: Optional[torch.Tensor] = None
    melt_buoy_fl: Optional[torch.Tensor] = None
    melt_eros_fl: Optional[torch.Tensor] = None
    melt_conv_fl: Optional[torch.Tensor] = None
    melt_by_class: Optional[torch.Tensor] = None   # (nx+2, ny+2, classes)
    bergy_src_kg: Optional[torch.Tensor] = None
    bergy_melt_kg: Optional[torch.Tensor] = None
    flb_bergy_melt_kg: Optional[torch.Tensor] = None
    berg_melt_kg: Optional[torch.Tensor] = None
    fl_bits_melt_kg: Optional[torch.Tensor] = None
    net_melt_kg: Optional[torch.Tensor] = None
    flb_internal_eros_kg: Optional[torch.Tensor] = None


_DTFR_DP = -7.53e-08
_DTFR_DS = -0.0573
_TFR_S0_P0 = 0.0832


def calculate_tfreeze(S, pres):
    """Linear freezing point of seawater (icebergs.F90:3779-3800)."""
    return (_TFR_S0_P0 + _DTFR_DS * S) + _DTFR_DP * pres


def calculate_density(T, S, rho_t0_s0, dr_dt, dr_ds):
    """Linear EOS (icebergs.F90:3802-3828)."""
    return rho_t0_s0 + dr_dt * T + dr_ds * S


def find_basal_melt(cfg: IcebergsConfig, dvo, lat, salt, temp, thickness,
                    use_three_equation: bool):
    """Basal melt rate (m/s) under ice-shelf-style thermodynamics
    (icebergs.F90:3492-3768)."""
    VK = 0.40
    ZETA_N = 0.052
    RC = 0.20
    dR0_dT = -0.038357
    dR0_dS = 0.805876
    RHO_T0_S0 = 999.910681
    Salin_Ice = 0.0
    kd_molec_salt = 8.02e-10
    kd_molec_temp = 1.41e-7
    kv_molec = 1.95e-6
    Cp_ml = 3974.0
    LF = 3.335e5
    p_atm = 101325.0
    c2_3 = 2.0 / 3.0

    density_ice = cfg.rho_bergs
    Rho0 = C.RHO_SEAWATER
    Hml = 10.0
    p_int = p_atm + (C.GRAVITY * thickness * density_ice)
    Rhoml = calculate_density(temp, salt, RHO_T0_S0, dR0_dT, dR0_dS)

    I_ZETA_N = 1.0 / ZETA_N
    I_LF = 1.0 / LF
    SC = kv_molec / kd_molec_salt
    PR = kv_molec / kd_molec_temp
    I_VK = 1.0 / VK
    RhoCp = Rho0 * Cp_ml
    Gam_mol_t = 12.5 * (PR ** c2_3) - 6.
    Gam_mol_s = 12.5 * (SC ** c2_3) - 6.

    ustar = torch.sqrt(cfg.cdrag_icebergs
                       * (dvo * dvo + cfg.utide_icebergs ** 2))
    ustar_h = ustar.clamp(min=cfg.ustar_icebergs_bg)
    absf = coriolis(cfg, lat).abs()
    hBL_neut = torch.where((absf * Hml <= VK * ustar_h) | (absf == 0.),
                           Hml, (VK * ustar_h) / absf.clamp(min=1e-30))
    hBL_neut_h_molec = ZETA_N * ((hBL_neut * ustar_h) / (5.0 * kv_molec))
    ln_neut = torch.where(hBL_neut_h_molec > 1.0,
                          torch.log(hBL_neut_h_molec.clamp(min=1e-30)), 0.0)

    def gam_TS(Gam_turb):
        if cfg.const_gamma:
            return (cfg.Gamma_T_3EQ * torch.ones_like(Gam_turb),
                    cfg.Gamma_T_3EQ / 35. * torch.ones_like(Gam_turb))
        return (rdiv(1.0, Gam_mol_t + Gam_turb),
                rdiv(1.0, Gam_mol_s + Gam_turb))

    out_of_bounds = torch.zeros_like(temp, dtype=torch.bool)
    lprec3 = torch.zeros_like(temp)
    if use_three_equation:
        dB_dS = rdiv(C.GRAVITY, Rhoml) * dR0_dS
        dB_dT = rdiv(C.GRAVITY, Rhoml) * dR0_dT
        Gam_turb_neut = I_VK * (ln_neut + (0.5 * I_ZETA_N - 1.0))
        z = torch.zeros_like(temp)
        fb = torch.zeros_like(temp, dtype=torch.bool)
        Sbdry, Sb_min, Sb_max = salt, z, z
        sb_min_set, sb_max_set, oob, done = fb, fb, fb, fb
        lprec_acc = z
        for _ in range(20):
            tfreeze = calculate_tfreeze(Sbdry, p_int)
            dT_ustar = (temp - tfreeze) * ustar_h
            dS_ustar = (salt - Sbdry) * ustar_h
            I_Gam_T, I_Gam_S = gam_TS(Gam_turb_neut)
            wT_flux = dT_ustar * I_Gam_T
            wB_flux = dB_dS * (dS_ustar * I_Gam_S) + dB_dT * wT_flux
            uh3 = ustar_h * ustar_h * ustar_h
            n_star_term = (ZETA_N / RC) * (hBL_neut * VK) / uh3

            need_inner = wB_flux > 0.0
            wB, wT, IGt, IGs, idone = (wB_flux, wT_flux, I_Gam_T, I_Gam_S,
                                       ~need_inner)
            for _ in range(30):
                I_n_star = torch.sqrt(1.0 + n_star_term * wB)
                Ins_safe = I_n_star.clamp(min=1e-30)
                dIns_dwB = 0.5 * n_star_term / Ins_safe
                big = hBL_neut_h_molec > I_n_star * I_n_star
                Gam_turb = torch.where(
                    big,
                    I_VK * ((ln_neut - 2.0 * torch.log(Ins_safe))
                            + (0.5 * I_ZETA_N * I_n_star - 1.0)),
                    I_VK * (0.5 * I_ZETA_N * I_n_star - 1.0))
                dG_dwB = torch.where(
                    big,
                    I_VK * (rdiv(-2.0, Ins_safe) + 0.5 * I_ZETA_N)
                    * dIns_dwB,
                    I_VK * (0.5 * I_ZETA_N) * dIns_dwB)
                IGt2, IGs2 = gam_TS(Gam_turb)
                wT2 = dT_ustar * IGt2
                wB2 = dB_dS * (dS_ustar * IGs2) + dB_dT * wT2
                DwB = wB2 - wB
                conv = DwB.abs() < 1e-4 * (wB2.abs() + wB.abs())
                dDwB = -dG_dwB * (dB_dS * (dS_ustar * (IGs2 * IGs2))
                                  + dB_dT * (dT_ustar * (IGt2 * IGt2))) - 1.0
                wB_new = wB - DwB / dDwB
                upd = ~idone
                wB = torch.where(upd, wB_new, wB)
                wT = torch.where(upd, wT2, wT)
                IGt = torch.where(upd, IGt2, IGt)
                IGs = torch.where(upd, IGs2, IGs)
                idone = idone | conv
            wT_flux = torch.where(need_inner, wT, wT_flux)
            I_Gam_S = torch.where(need_inner, IGs, I_Gam_S)

            t_flux = RhoCp * wT_flux
            exch_vel_s = ustar_h * I_Gam_S
            lprec = I_LF * t_flux
            mass_exch = exch_vel_s * Rho0
            Sbdry_it = (salt * mass_exch + Salin_Ice * lprec) \
                / (mass_exch + lprec)
            dS_it = Sbdry_it - Sbdry
            conv = dS_it.abs() < 1e-4 * (0.5 * (salt + Sbdry + 1.e-10))
            bad_max = (dS_it < 0.) & sb_max_set & (Sbdry > Sb_max)
            bad_min = (dS_it >= 0.) & sb_min_set & (Sbdry < Sb_min)
            new_oob = oob | ((bad_max | bad_min) & ~done)
            Sb_max = torch.where((dS_it < 0.) & ~done, Sbdry, Sb_max)
            sb_max_set = sb_max_set | ((dS_it < 0.) & ~done)
            Sb_min = torch.where((dS_it >= 0.) & ~done, Sbdry, Sb_min)
            sb_min_set = sb_min_set | ((dS_it >= 0.) & ~done)
            upd = ~done & ~new_oob
            Sbdry = torch.where(upd, Sbdry_it, Sbdry)
            lprec_acc = torch.where(~done, lprec, lprec_acc)
            done = done | conv | new_oob
            oob = new_oob
        out_of_bounds, lprec3 = oob, lprec_acc

    tfreeze2 = calculate_tfreeze(salt, p_int)
    Gam_turb = I_VK * (ln_neut + (0.5 * I_ZETA_N - 1.0))
    I_Gam_T2 = rdiv(1.0, Gam_mol_t + Gam_turb)
    exch_vel_t = ustar_h * I_Gam_T2
    wT_flux2 = exch_vel_t * (temp - tfreeze2)
    lprec2 = I_LF * (RhoCp * wT_flux2)
    lprec = (torch.where(out_of_bounds, lprec2, lprec3)
             if use_three_equation else lprec2)
    return lprec / density_ice


def rolling(cfg: IcebergsConfig, Tn, Wn, Ln):
    """Iceberg rolling (icebergs.F90:3307-3369): updated (Tn, Wn, Ln)."""
    Delta = 6.0
    Dn = (cfg.rho_bergs / C.RHO_SEAWATER) * Tn
    can = Dn > 0.

    def swap(a, b, cond):
        return torch.where(cond, b, a), torch.where(cond, a, b)

    if (not cfg.use_updated_rolling_scheme) and (cfg.tip_parameter < 999.):
        # scheme 3 (legacy WM79 variant kept for compat)
        cond = can & (torch.maximum(Wn, Ln)
                      < torch.sqrt(0.92 * (Dn * Dn) + 58.32 * Dn))
        Tn, Wn = swap(Tn, Wn, cond)
        Wn, Ln = swap(Wn, Ln, Wn > Ln)
        return Tn, Wn, Ln

    Wn, Ln = torch.minimum(Wn, Ln), torch.maximum(Wn, Ln)
    if (not cfg.use_updated_rolling_scheme) and (cfg.tip_parameter >= 999.):
        q = cfg.rho_bergs / C.RHO_SEAWATER
        crit = (6.0 * q * (1 - q) * (Tn * Tn)) - (12. * Delta * q * Tn)
        cond = can & (Wn < torch.sqrt(crit.clamp(min=0.))) & (crit > 0.)
        Tn, Wn = swap(Tn, Wn, cond)
        return Tn, torch.minimum(Wn, Ln), torch.maximum(Wn, Ln)

    if cfg.tip_parameter > 0.:
        tip = cfg.tip_parameter
    else:
        q = cfg.rho_bergs / C.RHO_SEAWATER
        tip = math.sqrt(6 * q * (1 - q))
    cond = can & ((tip * Tn) > Wn)
    Tn, Wn = swap(Tn, Wn, cond)
    return Tn, torch.minimum(Wn, Ln), torch.maximum(Wn, Ln)


_L_C = C.PI / (2. * math.sqrt(2.))
_LW_C = 1. / (C.GRAVITY * C.RHO_SEAWATER)
_B_C = 1. / (12. * (1. - 0.3 ** 2))


def fl_bits_dimensions(cfg: IcebergsConfig, thickness):
    """Representative footloose-bit dimensions (L, W, T)
    (icebergs.F90:3370-3389)."""
    l_w = (_LW_C * cfg.fl_youngs * _B_C * (thickness * thickness
                                           * thickness)) ** 0.25
    l_b = _L_C * l_w
    T_fl, W_fl, L_fl = rolling(cfg, thickness, l_b, 3. * l_b)
    return L_fl, W_fl, T_fl


def melt_by_class_field(st, grid, cfg: IcebergsConfig, melt_rate_w, alive):
    """Per-calving-class melt (id_melt_by_class, icebergs.F90:3147-3155):
    each berg's class is the nearest initial mass to its start mass, from
    the hemisphere's table (the first of equals, as argmin takes it);
    (nx+2, ny+2, classes), an accumulating scatter.  The tables stay
    Python floats: a device copy of them would be a host sync."""
    ms = cfg.initial_mass
    mn = (cfg.initial_mass_n if cfg.separate_distrib_for_n_hemisphere
          else cfg.initial_mass)
    south = st.lat < 0.
    best = k = None
    for c, (a, b) in enumerate(zip(ms, mn)):
        d = torch.where(south, (a - st.start_mass).abs(),
                        (b - st.start_mass).abs())
        if best is None:
            best, k = d, torch.zeros_like(d, dtype=torch.int64)
        else:
            closer = d < best
            best = torch.where(closer, d, best)
            k = torch.where(closer, c, k)
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    out = torch.zeros(grid.nx + 2, grid.ny + 2, len(ms), dtype=st.dtype,
                      device=st.device)
    return out.index_put_((I, J, k), torch.where(alive, melt_rate_w, 0.),
                          accumulate=True)


def thermodynamics(st, grid, frc, cfg: IcebergsConfig,
                   defer_cell_cols: bool = True, *, sort_ctx=None,
                   with_class_melt: bool = False):
    """Melt every berg, update its dimensions, roll, kill fully melted
    bergs (icebergs.F90:2844-3306).  Returns ``(state, MeltDiags)``: the
    per-berg melt columns deferred to the spreading pass when
    ``defer_cell_cols`` and ``cfg.parallel_reprod``, else the gridded
    melt fields, summed in (cell, id) order through ``sort_ctx``
    (:func:`.spread.make_sort_ctx`, made here when None) when
    reproducing.  ``with_class_melt`` adds ``melt_by_class``."""
    perday = 1. / 86400.
    dt = cfg.dt
    alive = st.alive
    SST = st.sst
    SSS = st.sss
    IC = (st.cn + cfg.sicn_shift).clamp(max=1.)
    M = st.mass
    T = st.thickness
    W = st.width
    L = st.length
    Vol = T * W * L

    def sq(x):
        return x * x

    dvo = torch.sqrt(sq(st.uvel - st.uo) + sq(st.vvel - st.vo))
    dva = torch.sqrt(sq(st.ua - st.uo) + sq(st.va - st.vo))
    Ss = 1.5 * torch.sqrt(dva) + 0.1 * dva

    Mv = (7.62e-3 * SST + 1.29e-3 * sq(SST)).clamp(min=0.) * perday
    Lsafe = L.clamp(min=1e-30)
    Mb = (0.58 * dvo ** 0.8 * (SST + 4.0) / Lsafe ** 0.2).clamp(min=0.) \
        * perday
    Me = ((1. / 12.) * (SST + 2.) * Ss
          * (1 + torch.cos(C.PI * (IC * IC * IC)))).clamp(min=0.) * perday
    Mv_fl, Me_fl = Mv, Me

    N_max = cfg.n_max_bonds_shape
    N_bonds = st.n_bonds if cfg.iceberg_bonds_on else torch.zeros_like(M)
    N_bonds = torch.where(st.static_berg == 1., N_max, N_bonds)

    if cfg.melt_icebergs_as_ice_shelf or cfg.use_mixed_melting:
        SSS_eff = SSS if cfg.use_mixed_layer_salinity_for_thermo \
            else torch.full_like(SSS, 35.0)
        Ms = find_basal_melt(cfg, dvo, st.lat, SSS_eff, SST, T,
                             cfg.Use_three_equation_model).clamp(min=0.)
        if cfg.melt_cutoff >= 0. and cfg.apply_thickness_cutoff_to_bergs_melt:
            Dn0 = (cfg.rho_bergs / C.RHO_SEAWATER) * T
            I, J = (st.ine + 1).long(), (st.jne + 1).long()
            thin = (grid.ocean_depth[I, J] - Dn0) < cfg.melt_cutoff
            Ms = torch.where(thin, 0., Ms)
        if cfg.use_mixed_melting:
            frac = (N_max - N_bonds) / N_max
            Me = frac * (Mv + Me)
            Mv = torch.zeros_like(Mv)
            Mb = frac * Mb + (N_bonds / N_max) * Ms
        else:
            Mv = torch.zeros_like(Mv)
            Me = torch.zeros_like(Me)
            Mb = Ms
    if cfg.set_melt_rates_to_zero:
        Mv = torch.zeros_like(Mv)
        Mb = torch.zeros_like(Mb)
        Me = torch.zeros_like(Me)

    Vsafe = Vol.clamp(min=1e-30)
    if cfg.use_operator_splitting:
        # product form of the reference's Mnew_k - Mnew_{k+1} differences
        # (thermo.py:413-419 explains why the subtraction is avoided)
        dT = torch.minimum(Mb * dt, T)
        Tn = (T - Mb * dt).clamp(min=0.)
        dMb = (M / Vsafe) * (W * L) * dT
        dv = Mv * dt
        dWv = torch.minimum(dv, W)
        dLv = torch.minimum(dv, L)
        Ln1 = (L - dv).clamp(min=0.)
        Wn1 = (W - dv).clamp(min=0.)
        dMv = (M / Vsafe) * Tn * (dWv * L + dLv * W - dWv * dLv)
        de = Me * dt
        dWe = torch.minimum(de, Wn1)
        dLe = torch.minimum(de, Ln1)
        Ln = (Ln1 - de).clamp(min=0.)
        Wn = (Wn1 - de).clamp(min=0.)
        dMe = (M / Vsafe) * Tn * (dWe * Ln1 + dLe * Wn1 - dWe * dLe)
        dM = dMb + dMv + dMe
        Mnew = M - dM
    else:
        Ln = (L - (Mv + Me) * dt).clamp(min=0.)
        Wn = (W - (Mv + Me) * dt).clamp(min=0.)
        Ln1, Wn1 = Ln, Wn
        Tn = (T - Mb * dt).clamp(min=0.)
        Mnew = (Tn * Wn * Ln / Vsafe) * M
        dM = M - Mnew
        dMb = (M / Vsafe) * (W * L) * Mb * dt
        dMe = (M / Vsafe) * (T * (W + L)) * Me * dt
        dMv = (M / Vsafe) * (T * (W + L)) * Mv * dt
    fl_k = st.fl_k
    if cfg.footloose:
        # the foot's area accumulates on fl_k (icebergs.F90:3016-3036)
        l_b3 = 3. * _L_C * (_LW_C * cfg.fl_youngs * _B_C
                            * (Tn * Tn * Tn)) ** 0.25
        fb = Tn * (1. - cfg.rho_bergs / C.RHO_SEAWATER)
        kd = Tn - fb
        fbs = fb.clamp(min=1e-30)
        kds = kd.clamp(min=1e-30)
        dk_wide = divc(dMe / fbs - dMv / kds, cfg.rho_bergs)
        dMv_l = dMv * (Wn1 + W) / (2. * (Ln1 + W)).clamp(min=1e-30)
        dMe_l = dMe * (Wn + Wn1) / (2. * (Ln + Wn1)).clamp(min=1e-30)
        dk_narrow = divc(dMe_l / fbs - dMv_l / kds, cfg.rho_bergs)
        dk = torch.where(W > l_b3, dk_wide, dk_narrow)
        apply = (fl_k >= 0) & (L > l_b3)
        fl_k = torch.where(apply, (fl_k + dk).clamp(min=0.), fl_k)

    # footloose bits melt (icebergs.F90:3039-3082)
    has_fl = st.mass_of_fl_bits > 0.
    Lfl, Wfl, Tfl = fl_bits_dimensions(cfg, T)
    Mfl = st.mass_of_fl_bits
    Volfl = (Lfl * Wfl * Tfl).clamp(min=1e-30)
    Mb_fl = (0.58 * dvo ** 0.8 * (SST + 4.0)
             / Lfl.clamp(min=1e-30) ** 0.2).clamp(min=0.) * perday
    Tnfl = (Tfl - Mb_fl * dt).clamp(min=0.)
    Mnew1_fl = (Tnfl * Wfl * Lfl / Volfl) * Mfl
    dMb_fl = Mfl - Mnew1_fl
    Lnfl = (Lfl - Mv_fl * dt).clamp(min=0.)
    Wnfl = (Wfl - Mv_fl * dt).clamp(min=0.)
    Mnew2_fl = (Tnfl * Wnfl * Lnfl / Volfl) * Mfl
    dMv_fl = Mnew1_fl - Mnew2_fl
    Lnfl = (Lnfl - Me_fl * dt).clamp(min=0.)
    Wnfl = (Wnfl - Me_fl * dt).clamp(min=0.)
    Mnew_fl = (Tnfl * Wnfl * Lnfl / Volfl) * Mfl
    dMe_fl = Mnew2_fl - Mnew_fl
    dMfl = Mfl - Mnew_fl
    dMb_fl = torch.where(has_fl, dMb_fl, 0.)
    dMv_fl = torch.where(has_fl, dMv_fl, 0.)
    dMe_fl = torch.where(has_fl, dMe_fl, 0.)
    dMfl = torch.where(has_fl, dMfl, 0.)
    Mnew_fl = torch.where(has_fl, Mnew_fl, st.mass_of_fl_bits)

    # bergy bits (icebergs.F90:3085-3131)
    if cfg.bergy_bit_erosion_fraction > 0.:
        frac_e = cfg.bergy_bit_erosion_fraction
        Mbits = st.mass_of_bits
        dMbitsE = frac_e * dMe
        nMbits = Mbits + dMbitsE
        Lbits = torch.minimum(torch.minimum(L, W),
                              T.clamp(max=40.)).clamp(min=1e-30)
        Abits = (Mbits / cfg.rho_bergs) / Lbits
        Mbb = (0.58 * dvo ** 0.8 * (SST + 2.0) / Lbits ** 0.2).clamp(
            min=0.) * perday
        Mbb = cfg.rho_bergs * Abits * Mbb
        dMbitsM = torch.minimum(Mbb * dt, nMbits)
        nMbits = nMbits - dMbitsM
        died = Mnew == 0.
        dMbitsM = torch.where(died, dMbitsM + nMbits, dMbitsM)
        nMbits = torch.where(died, 0., nMbits)

        Mbits_fl = st.mass_of_fl_bergy_bits
        dMbitsE_fl = torch.where(has_fl, frac_e * dMe_fl, 0.)
        nMbits_fl = Mbits_fl + dMbitsE_fl
        Lbits_fl = torch.minimum(torch.minimum(Lfl, Wfl),
                                 Tfl.clamp(max=40.)).clamp(min=1e-30)
        Abits_fl = (Mbits_fl / cfg.rho_bergs) / Lbits_fl
        Mbb_fl = (0.58 * dvo ** 0.8 * (SST + 2.0)
                  / Lbits_fl ** 0.2).clamp(min=0.) * perday
        Mbb_fl = cfg.rho_bergs * Abits_fl * Mbb_fl
        dMbitsM_fl = torch.where(has_fl, torch.minimum(Mbb_fl * dt,
                                                       nMbits_fl), 0.)
        nMbits_fl = nMbits_fl - dMbitsM_fl
        died_fl = has_fl & (Mnew_fl == 0.)
        dMbitsM_fl = torch.where(died_fl, dMbitsM_fl + nMbits_fl,
                                 dMbitsM_fl)
        nMbits_fl = torch.where(died_fl, 0., nMbits_fl)
        nMbits_fl = torch.where(has_fl, nMbits_fl, st.mass_of_fl_bergy_bits)
    else:
        dMbitsE = dMbitsM = dMbitsE_fl = dMbitsM_fl = torch.zeros_like(M)
        nMbits = st.mass_of_bits
        nMbits_fl = st.mass_of_fl_bergy_bits

    # per-berg melt columns (the reference's gridded melt diagnostics)
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    area = grid.area[I, J].clamp(min=1e-30)
    scale = st.mass_scaling
    w = torch.where(alive, scale / (dt * area), 0.)
    melt_tot = (dM - (dMbitsE - dMbitsM) + dMfl
                - (dMbitsE_fl - dMbitsM_fl))
    net_heat = torch.where(alive, melt_tot * st.heat_density * scale,
                           0.).sum()

    def _kg(x):
        return torch.where(alive, x * scale, 0.).sum()

    budget = dict(
        bergy_src_kg=_kg(dMbitsE), bergy_melt_kg=_kg(dMbitsM),
        flb_bergy_melt_kg=_kg(dMbitsM_fl), berg_melt_kg=_kg(dM),
        fl_bits_melt_kg=_kg(dMfl), net_melt_kg=_kg(melt_tot),
        flb_internal_eros_kg=_kg(dMbitsE_fl))
    parent = fl_k >= 0.
    child_melt = torch.where(parent, dMfl - (dMbitsE_fl - dMbitsM_fl),
                             dM - (dMbitsE - dMbitsM))
    fl_gate = parent & (dMfl > 0.)
    cols = [melt_tot * w, melt_tot * st.heat_density * w, dM * w,
            (dMbitsE + dMbitsE_fl) * w, (dMbitsM + dMbitsM_fl) * w,
            dMfl * w,
            torch.where(parent, dMb, 0.) * w,
            torch.where(parent, dMe, 0.) * w,
            torch.where(parent, dMv, 0.) * w,
            torch.where(parent, dM - (dMbitsE - dMbitsM), 0.) * w,
            child_melt * w,
            torch.where(fl_gate, dMb_fl, torch.where(parent, 0., dMb)) * w,
            torch.where(fl_gate, dMe_fl, torch.where(parent, 0., dMe)) * w,
            torch.where(fl_gate, dMv_fl, torch.where(parent, 0., dMv)) * w]
    cols = [torch.where(alive, v, 0.) for v in cols]
    fields = {}
    if not (defer_cell_cols and cfg.parallel_reprod):
        if cfg.parallel_reprod:
            from .spread import scatter_cell_deterministic
            out = scatter_cell_deterministic(
                grid, st, cols, alive, K=cfg.reprod_max_per_cell,
                sort_ctx=sort_ctx, method=cfg.slot_sum_method_eff)
        else:
            from .spread import scatter_cells
            out = scatter_cells(grid, I, J, cols)
        fields = dict(zip(MELT_FIELDS, out))
        cols = None

    if cfg.allow_bergs_to_roll:
        Tr, Wr, Lr = rolling(cfg, Tn, Wn, Ln)
        roll_ok = N_bonds == 0.
        Tn = torch.where(roll_ok, Tr, Tn)
        Wn = torch.where(roll_ok, Wr, Wn)
        Ln = torch.where(roll_ok, Lr, Ln)

    if not cfg.Iceberg_melt_without_decay:
        st = st.replace(
            mass=torch.where(alive, Mnew, st.mass),
            mass_of_bits=torch.where(alive, nMbits, st.mass_of_bits),
            mass_of_fl_bits=torch.where(alive, Mnew_fl, st.mass_of_fl_bits),
            mass_of_fl_bergy_bits=torch.where(alive, nMbits_fl,
                                              st.mass_of_fl_bergy_bits),
            thickness=torch.where(alive, Tn, st.thickness),
            width=torch.where(alive, torch.minimum(Wn, Ln), st.width),
            length=torch.where(alive, torch.maximum(Wn, Ln), st.length),
            fl_k=torch.where(alive, fl_k, st.fl_k))
        melted = alive & (Mnew <= 0.)
    else:
        melted = torch.zeros_like(alive)
    promote = melted & (Mnew_fl > 0.)
    kill = melted & ~promote
    if cfg.footloose:
        # a melted parent's footloose bits become a berg
        # (icebergs.F90:3225-3262)
        new_mass = Lnfl * Wnfl * Tnfl * cfg.rho_bergs
        new_scaling = Mnew_fl * st.mass_scaling / new_mass.clamp(min=1e-30)
        nMbits_fl_scaled = nMbits_fl * st.mass_scaling / new_scaling.clamp(
            min=1e-30)
        st = st.replace(
            mass=torch.where(promote, new_mass, st.mass),
            length=torch.where(promote, Lnfl, st.length),
            width=torch.where(promote, Wnfl, st.width),
            thickness=torch.where(promote, Tnfl, st.thickness),
            mass_scaling=torch.where(promote, new_scaling, st.mass_scaling),
            mass_of_bits=torch.where(promote, nMbits_fl_scaled,
                                     st.mass_of_bits),
            mass_of_fl_bits=torch.where(promote, 0., st.mass_of_fl_bits),
            mass_of_fl_bergy_bits=torch.where(promote, 0.,
                                              st.mass_of_fl_bergy_bits),
            fl_k=torch.where(promote, -1., st.fl_k))
    st = st.replace(alive=st.alive & ~kill)
    if with_class_melt:
        fields["melt_by_class"] = melt_by_class_field(
            st, grid, cfg, melt_tot * w, alive)
    return st, MeltDiags(net_heat=net_heat,
                         nbergs_melted=melted.sum(dtype=torch.int32),
                         deferred_cols=cols, **budget, **fields)

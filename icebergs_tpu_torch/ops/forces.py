"""Berg-berg contact forces: pair precompute and evaluation.

Counterpart of the pair half of ``icebergs_tpu/ops/forces.py``
(``_interaction_radius``, ``PairData``, ``precompute_pair_data``,
``precompute_pair_data_T``, ``eval_pair_ia``, ``eval_pair_ia_T``; port of
``calculate_force``, ``src/icebergs.F90:611-804``), for the legacy
non-bonded contact group on a Cartesian grid (metric factors 1).

``*_T`` functions hold pair slabs as (M, N) with the partner axis first
(the fused search's two partners); the plain ones as (N, M) (the exact
fallback's candidate strips).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..config import IcebergsConfig
from .accel import IA, f32_scalar


def _interaction_radius(cfg: IcebergsConfig, A):
    """Inscribed-circle radius by packing shape (Stern et al 2017 Eq 4)."""
    if cfg.hexagonal_icebergs or cfg.iceberg_bonds_on:
        raise NotImplementedError("hexagonal / bonded radii (ROADMAP.md "
                                  "Queue 1 items 10-11)")
    return torch.sqrt(A / C.PI)


class PairData(NamedTuple):
    """Velocity-independent pair quantities, precomputed once per step."""
    active: torch.Tensor
    IA_x: torch.Tensor       # (N,) spring accel
    IA_y: torch.Tensor
    P11: torch.Tensor        # radial projection per pair
    P12: torch.Tensor
    P22: torch.Tensor
    crad: torch.Tensor       # radial damping coef x (M_min/M1)
    ctan: torch.Tensor
    u2: torch.Tensor         # partner *_old velocity
    v2: torch.Tensor


def _damping(cfg: IcebergsConfig, spring_coef: float):
    """(radial, tangential) damping coefficients; the critical values
    are float32 square roots as in the reference's weak-typed math (the
    power-of-two scalings are exact either way)."""
    if cfg.critical_interaction_damping_on:
        s = f32_scalar(torch.sqrt, spring_coef)
        radial = 2. * s
        tangental = (2. * s / 4. if cfg.tang_crit_int_damp_on
                     else cfg.tangental_damping_coef)
        return radial, tangental
    return cfg.radial_damping_coef, cfg.tangental_damping_coef


def _legacy(cfg: IcebergsConfig) -> bool:
    return not (cfg.mts or cfg.contact_distance > 0.
                or cfg.contact_spring_coef_eff != cfg.spring_coef)


def _pair_terms(cfg, lon1, lat1, A1, M1, lon2, lat2, A2, M2, mask, u2,
                v2, axis):
    """The shared geometry / spring / projection chain of both layouts;
    ``axis`` is the partner axis the spring sums reduce over."""
    if not _legacy(cfg):
        raise NotImplementedError("modern contact dispatch (ROADMAP.md "
                                  "Queue 1 item 10)")
    r_dist_x = lon1 - lon2
    r_dist_y = lat1 - lat2
    r_dist = torch.sqrt(r_dist_x * r_dist_x + r_dist_y * r_dist_y)
    R1 = _interaction_radius(cfg, A1)
    R2 = _interaction_radius(cfg, A2)
    M_min = torch.minimum(M1, M2)
    crit_dist = (R1 + R2).clamp(min=cfg.contact_distance)
    spring_coef = cfg.contact_spring_coef_eff
    radial_damping, tangental_damping = _damping(cfg, spring_coef)
    active = mask & (r_dist > 0.) & (r_dist < crit_dist)

    rsafe = torch.where(r_dist > 0., r_dist, 1.)
    accel_spring = spring_coef * (M_min / M1) * (crit_dist - r_dist)
    IA_x = torch.where(active, accel_spring * r_dist_x / rsafe,
                       0.).sum(axis)
    IA_y = torch.where(active, accel_spring * r_dist_y / rsafe,
                       0.).sum(axis)
    rs2 = rsafe * rsafe
    mm = M_min / M1
    return PairData(active=active, IA_x=IA_x, IA_y=IA_y,
                    P11=(r_dist_x * r_dist_x) / rs2,
                    P12=(r_dist_x * r_dist_y) / rs2,
                    P22=(r_dist_y * r_dist_y) / rs2,
                    crad=radial_damping * mm, ctan=tangental_damping * mm,
                    u2=u2, v2=v2)


def precompute_pair_data(st, cfg: IcebergsConfig, other, mask, *,
                         partner_st) -> PairData:
    """(N, M) pair data of primaries ``st`` (any object with the fields
    read here) against ``partner_st`` rows ``other`` (N, M)."""
    o = other.long()
    fl_k2 = partner_st.fl_k[o]
    mask = mask & (st.fl_k[:, None] != -1.) & (fl_k2 != -1.)
    return _pair_terms(
        cfg, st.lon_old[:, None], st.lat_old[:, None],
        (st.length * st.width)[:, None], st.mass[:, None],
        partner_st.lon_old[o], partner_st.lat_old[o],
        partner_st.length[o] * partner_st.width[o], partner_st.mass[o],
        mask, partner_st.uvel_old[o], partner_st.vvel_old[o], -1)


def precompute_pair_data_T(st, cfg: IcebergsConfig, mask_T, *,
                           partner_fields) -> PairData:
    """(M, N) pair data with the partners' fields handed in
    (``partner_fields``: (M, N) lon2, lat2, u2, v2, A2g, M2g — the
    extraction kernel's output, whose engagement test already excluded
    fl_k == -1 on both sides)."""
    pf = partner_fields
    return _pair_terms(
        cfg, st.lon_old[None, :], st.lat_old[None, :],
        (st.length * st.width)[None, :], st.mass[None, :],
        pf["lon2"], pf["lat2"], pf["A2g"], pf["M2g"], mask_T,
        pf["u2"], pf["v2"], 0)


def _eval(pd: PairData, cfg: IcebergsConfig, u0, v0, u1, v1, axis):
    P11, P12, P22 = pd.P11, pd.P12, pd.P22
    u2, v2 = pd.u2, pd.v2

    def pmag(P11, P12, P22, coef):
        if not cfg.scale_damping_by_pmag:
            return coef
        du1, dv1 = u2 - u1, v2 - v1
        du0, dv0 = u2 - u0, v2 - v0
        a1 = P11 * du1 + P12 * dv1
        b1 = P12 * du1 + P22 * dv1
        a0 = P11 * du0 + P12 * dv0
        b0 = P12 * du0 + P22 * dv0
        m1 = torch.sqrt(a1 * a1 + b1 * b1)
        m0 = torch.sqrt(a0 * a0 + b0 * b0)
        return coef * 0.5 * (m1 + m0)

    wr = torch.where(pd.active, pmag(P11, P12, P22, pd.crad), 0.)
    wt = torch.where(pd.active, pmag(1. - P11, -P12, 1. - P22, pd.ctan), 0.)
    D11 = wr * P11 + wt * (1. - P11)
    D12 = wr * P12 + wt * (-P12)
    D22 = wr * P22 + wt * (1. - P22)
    oP12 = D12.sum(axis)
    return IA(IA_x=pd.IA_x, IA_y=pd.IA_y, P11=D11.sum(axis), P12=oP12,
              P21=oP12, P22=D22.sum(axis),
              Pu_x=(D11 * u2 + D12 * v2).sum(axis),
              Pu_y=(D12 * u2 + D22 * v2).sum(axis))


def eval_pair_ia(pd: PairData, cfg: IcebergsConfig, u0, v0, u1, v1) -> IA:
    """Velocity-dependent part of calculate_force on (N, M) slabs."""
    return _eval(pd, cfg, u0[:, None], v0[:, None], u1[:, None],
                 v1[:, None], -1)


def eval_pair_ia_T(pd: PairData, cfg: IcebergsConfig, u0, v0, u1,
                   v1) -> IA:
    """(M, N)-layout twin of :func:`eval_pair_ia`."""
    return _eval(pd, cfg, u0[None, :], v0[None, :], u1[None, :],
                 v1[None, :], 0)

"""Mass spreading of bergs onto the ocean grid + derived gridded fields.

Counterpart of the kernel branch of ``icebergs_tpu/ops/spread.py``
(``berg_spread_mass``, ``create_gridded_icebergs_fields``
``spread.py:799-837``, ``sum_slots``, ``_gridded_epilogue``; port of
``src/icebergs.F90:3390-3491, 3895-4243``): the per-cell sums come from
K3 (:mod:`.segment_spread`, in the JAX package's association: the slot
tree when a block overflows the TPU kernel's window, else sequential),
are shifted into the 9 neighbour slots of each cell and summed in the
reference's fixed slot order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import IcebergsConfig
from . import segment_spread as ss
from .thermo import fl_bits_dimensions


# K3's overflow rule, as the JAX package's PALLAS_SPREAD_CB /
# PALLAS_SPREAD_WINDOW (icebergs_tpu/ops/spread.py:779-780) set it: the
# TPU kernel's cells per block and window rows (None = its auto window).
# Read at each call, so that a test can force the overflow association in
# both packages the same way
SPREAD_CB = 128
SPREAD_WINDOW = None


class SpreadDiags(NamedTuple):
    spread_mass: torch.Tensor     # (nx+2, ny+2) kg/m2
    spread_area: torch.Tensor
    spread_uvel: torch.Tensor
    spread_vvel: torch.Tensor
    ustar_iceberg: torch.Tensor
    mass_on_ocean: torch.Tensor   # kg per cell
    u_iceberg: torch.Tensor
    v_iceberg: torch.Tensor
    mass: torch.Tensor
    virtual_area: torch.Tensor
    bergy_mass: torch.Tensor
    fl_bits_mass: torch.Tensor
    fl_bergy_bits_mass: torch.Tensor


def berg_spread_mass(st, grid, frc, cfg: IcebergsConfig):
    """Per-berg total mass to spread, incl. grounding trim and clipping
    (icebergs.F90:3929-3958; the reference's local rho_seawater = 1035)."""
    rho_sw = 1035.0
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    Mass_berg = st.mass
    Mfl = st.mass_of_fl_bits
    if cfg.grounding_fraction > 0.:
        Hocean = cfg.grounding_fraction * (grid.ocean_depth[I, J]
                                           + frc.ssh[I, J])
        Dn = (cfg.rho_bergs / rho_sw) * st.thickness
        trim = (Hocean / Dn.clamp(min=1e-30)).clamp(max=1.)
        Mass_berg = torch.where(Dn > Hocean, Mass_berg * trim, Mass_berg)
        Lfl, Wfl, Tfl = fl_bits_dimensions(cfg, st.thickness)
        Dnf = (cfg.rho_bergs / rho_sw) * Tfl
        trimf = (Hocean / Dnf.clamp(min=1e-30)).clamp(max=1.)
        Mfl = torch.where((Mfl > 0.) & (Dnf > Hocean), Mfl * trimf, Mfl)
    Mass = (Mass_berg + Mfl + st.mass_of_bits
            + st.mass_of_fl_bergy_bits) * st.mass_scaling
    if cfg.clipping_depth > 0.:
        Mass = torch.minimum(Mass, cfg.clipping_depth * grid.area[I, J]
                             * rho_sw)
    return Mass


def sum_slots(out9):
    """Fixed-order sum over the 9 slots (sum_up_spread_fields,
    icebergs.F90:6077-6152): a list of F (nx+2, ny+2) fields."""
    acc = out9[:, :, 0, :]
    for k in range(1, 9):
        acc = acc + out9[:, :, k, :]
    return [acc[..., f] for f in range(out9.shape[-1])]


def create_gridded_icebergs_fields(st, grid, frc, cfg: IcebergsConfig, *,
                                   key_alive, cell_starts,
                                   extra_cell_cols=None, cell_table=None):
    """The coupler fields from one K3 pass: over the presorted slab when
    ``cell_starts`` is given, else behind a payload sort (K1).
    ``cell_table`` is the grid's ``segment_spread.cell_tables`` (built
    here when not given; a step keeps it).

    ``key_alive`` is the sort key's aliveness (pre-thermodynamics: rows
    that died in thermodynamics keep their cell, so their deferred melt
    still lands); ``extra_cell_cols`` are per-berg columns summed per
    owning cell in the same pass.  Returns ``SpreadDiags`` or, with extra
    columns, ``(SpreadDiags, extra_fields)``."""
    if not cfg.parallel_reprod or cfg.hexagonal_icebergs:
        raise NotImplementedError("slot-scatter spreading (ROADMAP.md "
                                  "Queue 1 item 15)")
    nx, ny = grid.nx, grid.ny
    FX = len(extra_cell_cols or [])
    S, _ = ss.spread_cell_sums(st, grid, frc, cfg, extra_cell_cols,
                               key_alive=key_alive, cell_starts=cell_starts,
                               tbl=cell_table, cell_block=SPREAD_CB,
                               window=SPREAD_WINDOW)
    dt_ = S.dtype
    Sg = S[:, :36].reshape(ny, nx, 9, 4).permute(1, 0, 2, 3)
    out9 = torch.zeros(nx + 2, ny + 2, 9, 4, dtype=dt_, device=S.device)
    k = 0
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out9[1 + di:nx + 1 + di, 1 + dj:ny + 1 + dj, k] += Sg[:, :, k]
            k += 1
    mass_on, area_on, U_on, V_on = sum_slots(out9)

    def padded(cols):
        F = cols.shape[1]
        out = torch.zeros(nx + 2, ny + 2, F, dtype=dt_, device=S.device)
        out[1:-1, 1:-1, :] = cols.reshape(ny, nx, F).permute(1, 0, 2)
        return [out[..., f] for f in range(F)]

    cell = padded(S[:, 36:43])
    extra_fields = padded(S[:, 43:]) if FX else None
    return _gridded_epilogue(grid, frc, cfg, mass_on, area_on, U_on, V_on,
                             *cell, extra_fields,
                             extra_cell_cols is not None)


def _gridded_epilogue(grid, frc, cfg, mass_on, area_on, U_on, V_on,
                      mass_cell, mom_u, mom_v, virtual_area, bergy_mass,
                      fl_bits_mass, fl_bergy_bits_mass, extra_fields,
                      want_extras):
    """Gridded-field derivations (icebergs.F90:3440-3491)."""
    area_g = grid.area.clamp(min=1e-30)
    wet = grid.msk > 0.
    spread_mass = mass_on / area_g * wet
    spread_area = area_on / area_g * wet
    asafe = area_on.clamp(min=1e-30)
    spread_uvel = torch.where(area_on > 0., U_on / asafe, 0.)
    spread_vvel = torch.where(area_on > 0., V_on / asafe, 0.)

    def centers(f):
        return 0.25 * (f[:-1, :-1] + f[1:, :-1] + f[:-1, 1:] + f[1:, 1:])

    uo_p = torch.zeros_like(spread_mass)
    vo_p = torch.zeros_like(spread_mass)
    uo_p[1:-1, 1:-1] = centers(frc.uo)
    vo_p[1:-1, 1:-1] = centers(frc.vo)
    du, dv = spread_uvel - uo_p, spread_vvel - vo_p
    dvo = torch.sqrt(du * du + dv * dv)
    ustar = torch.sqrt(cfg.cdrag_icebergs
                       * (dvo * dvo + cfg.utide_icebergs ** 2))
    ustar_h = ustar.clamp(min=cfg.ustar_icebergs_bg)
    ustar_iceberg = torch.where(spread_area == 0., 0., ustar_h)

    msafe = mass_cell.clamp(min=1e-30)
    u_ice = torch.where(mass_cell > 0., mom_u / msafe, 0.)
    v_ice = torch.where(mass_cell > 0., mom_v / msafe, 0.)
    diags = SpreadDiags(spread_mass=spread_mass, spread_area=spread_area,
                        spread_uvel=spread_uvel, spread_vvel=spread_vvel,
                        ustar_iceberg=ustar_iceberg, mass_on_ocean=mass_on,
                        u_iceberg=u_ice, v_iceberg=v_ice, mass=mass_cell,
                        virtual_area=virtual_area, bergy_mass=bergy_mass,
                        fl_bits_mass=fl_bits_mass,
                        fl_bergy_bits_mass=fl_bergy_bits_mass)
    if want_extras:
        return diags, extra_fields
    return diags

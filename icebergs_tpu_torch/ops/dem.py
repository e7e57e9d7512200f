"""Bonded-particle DEM helpers (iKID, Huth et al 2022b Sci. Adv.).

Counterpart of the helpers at the top of ``icebergs_tpu/ops/dem.py``
(``_HEXDENOM``, ``_radius``, ``dem_K_damp``; ``dem.py:30-62``) and of the
grounding drag coefficient that the substep loop reads
(``mts._grounding_drag_coeff``, ``mts.py:548-574``, in the form the
substep kernel computes it, ``dem_vmem.py:295-317``).  The bond and
contact force kernels of that module run inside K4
(:mod:`.dem_substeps`) on this package's path; the scan substep path
that calls them directly is ROADMAP.md Queue 1 item 16.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C
from ..config import IcebergsConfig

_HEXDENOM = 1. / (2. * math.sqrt(3.))


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


def grounding_drag_coeff(cfg: IcebergsConfig, thickness, od, mass, length,
                         width, area_form: str):
    """gdrag of short-step grounding (``'rect'``) or of the grounding
    torque (``'disk'``; icebergs.F90:6868-6893, 6986-7034)."""
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
        if cfg.hexagonal_icebergs:
            R1 = torch.sqrt(A0 * _HEXDENOM)
        elif cfg.iceberg_bonds_on:
            R1 = 0.5 * torch.sqrt(A0)
        else:
            R1 = torch.sqrt(tdiv(A0, C.PI))
        AA = C.PI * (R1 * R1)
    return torch.where(gf > 0., -cfg.cdrag_grounding * gf * AA / MM, 0.)

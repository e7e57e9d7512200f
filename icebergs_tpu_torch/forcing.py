"""Forcing fields passed to the coupling step.

PyTorch counterpart of ``icebergs_tpu/forcing.py``: B-grid corner
velocities ``(nx+1, ny+1)`` and halo-padded A-grid scalars
``(nx+2, ny+2)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Forcing:
    uo: torch.Tensor     # ocean (corners)
    vo: torch.Tensor
    ui: torch.Tensor     # sea ice
    vi: torch.Tensor
    ua: torch.Tensor     # atmosphere
    va: torch.Tensor
    ssh: torch.Tensor    # centers, halo-padded
    sst: torch.Tensor
    sss: torch.Tensor
    cn: torch.Tensor
    hi: torch.Tensor

    def replace(self, **kw) -> "Forcing":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Forcing":
        return Forcing(**{f.name: getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)})


def uniform_forcing(nx: int, ny: int, *, uo=0., vo=0., ui=0., vi=0.,
                    ua=0., va=0., ssh=0., sst=5., sss=30., cn=0., hi=0.,
                    dtype=torch.float32, device) -> Forcing:
    """Constant forcing (driver/icebergs_driver.F90:253-266 defaults)."""
    def corner(v):
        return torch.full((nx + 1, ny + 1), v, dtype=dtype, device=device)

    def center(v):
        return torch.full((nx + 2, ny + 2), v, dtype=dtype, device=device)

    return Forcing(uo=corner(uo), vo=corner(vo), ui=corner(ui),
                   vi=corner(vi), ua=corner(ua), va=corner(va),
                   ssh=center(ssh), sst=center(sst), sss=center(sss),
                   cn=center(cn), hi=center(hi))


def swirl_forcing(nx: int, ny: int, dxy: float, *, uo=0.3, ua=5.0,
                  ssh=0., sst=5., sss=30., cn=0., hi=0., core_frac=0.35,
                  dtype=torch.float32, device) -> Forcing:
    """Divergence-free clockwise Rankine swirl on a uniform Cartesian grid
    (``icebergs_tpu.forcing.swirl_forcing``, the benchmark's forcing):
    solid-body rotation out to ``core_frac`` of the half-width, 1/r decay
    beyond, so the berg density stays statistically steady."""
    L = min(nx, ny) * dxy
    xc, yc = 0.5 * nx * dxy, 0.5 * ny * dxy
    r0 = core_frac * 0.5 * L
    x = np.arange(nx + 1) * dxy - xc
    y = np.arange(ny + 1) * dxy - yc
    X, Y = np.meshgrid(x, y, indexing="ij")
    rs = np.maximum(np.hypot(X, Y), 1e-9)
    prof = np.minimum(rs / r0, r0 / rs)
    ex, ey = Y / rs, -X / rs

    def t(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    def center(v):
        return torch.full((nx + 2, ny + 2), v, dtype=dtype, device=device)

    zero = torch.zeros(nx + 1, ny + 1, dtype=dtype, device=device)
    return Forcing(uo=t(prof * ex * uo), vo=t(prof * ey * uo), ui=zero,
                   vi=zero, ua=t(prof * ex * ua), va=t(prof * ey * ua),
                   ssh=center(ssh), sst=center(sst), sss=center(sss),
                   cn=center(cn), hi=center(hi))


def forcing_from_arrays(*, uo, vo, ui, vi, ua, va, ssh, sst, sss, cn, hi,
                        dtype=torch.float32, device) -> Forcing:
    """A Forcing from raw arrays (``icebergs_tpu.forcing.
    forcing_from_arrays``): corner fields (nx+1, ny+1); centre fields
    (nx, ny), halo-padded here with zeros, or already (nx+2, ny+2)."""
    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    ssh_shape = np.shape(ssh)
    nx, ny = ssh_shape[0], ssh_shape[1]
    if ssh_shape[0] == np.shape(uo)[0] + 1:
        nx, ny = nx - 2, ny - 2

    def center(a):
        a = np.asarray(a)
        return t(a if a.shape == (nx + 2, ny + 2) else np.pad(a, 1))

    return Forcing(uo=t(uo), vo=t(vo), ui=t(ui), vi=t(vi), ua=t(ua),
                   va=t(va), ssh=center(ssh), sst=center(sst),
                   sss=center(sss), cn=center(cn), hi=center(hi))

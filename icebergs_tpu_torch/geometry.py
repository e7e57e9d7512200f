"""Curvilinear-grid geometry: point-in-cell tests and the inverse
bilinear map of general quad cells.

Counterpart of ``icebergs_tpu/geometry.py`` (port of
``src/icebergs_framework.F90:5710-6575``): the sign-of-cross-product
point-in-quadrilateral and -pentagon tests (``sum_sign_dot_prod4/5``),
``is_point_in_cell`` with its bounding-box reject, ``calc_xiyj`` (the
quadratic solve that keeps the root nearest 0.5),
``pos_within_cell_curvilinear``, the local neighbourhood search
``find_cell_local`` and the host search ``find_cell_by_search_host``.
Every function is elementwise over the bergs, with the corner layout of
:mod:`.grid` (cell (i, j) has corners C[i..i+1, j..j+1]: 1 SW, 2 SE,
3 NE, 4 NW), expression for expression the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import Grid, apply_modulo_around_point


def _sign_or(l, tie):
    return torch.where(l == 0., tie, torch.sign(l))


def sum_sign_dot_prod4(x0, y0, x1, y1, x2, y2, x3, y3, x, y, Lx: float):
    """Point-in-quadrilateral by consistent edge cross-product signs
    (icebergs_framework.F90:6166-6229): the South and East edges belong
    to the cell, North and West do not."""
    xx = apply_modulo_around_point(x, x0, Lx)
    xx0 = apply_modulo_around_point(x0, x0, Lx)
    xx1 = apply_modulo_around_point(x1, x0, Lx)
    xx2 = apply_modulo_around_point(x2, x0, Lx)
    xx3 = apply_modulo_around_point(x3, x0, Lx)
    l0 = (xx - xx0) * (y1 - y0) - (y - y0) * (xx1 - xx0)
    l1 = (xx - xx1) * (y2 - y1) - (y - y1) * (xx2 - xx1)
    l2 = (xx - xx2) * (y3 - y2) - (y - y2) * (xx3 - xx2)
    l3 = (xx - xx3) * (y0 - y3) - (y - y3) * (xx0 - xx3)
    p0 = _sign_or(l0, -0.5)
    p1 = _sign_or(l1, 0.5)
    p2 = _sign_or(l2, 0.5)
    p3 = _sign_or(l3, -0.5)
    lhs = (p0.abs() + p2.abs()) + (p1.abs() + p3.abs())
    rhs = ((p0 + p2) + (p1 + p3)).abs()
    return lhs == rhs


def sum_sign_dot_prod5(x0, y0, x1, y1, x2, y2, x3, y3, x4, y4, x, y,
                       Lx: float):
    """Point-in-pentagon for the tripolar polar cells
    (icebergs_framework.F90:6233-6300)."""
    xx = apply_modulo_around_point(x, x0, Lx)
    xs = [apply_modulo_around_point(v, x0, Lx) for v in (x0, x1, x2, x3, x4)]
    ys = [y0, y1, y2, y3, y4]
    ps = []
    for k in range(5):
        k2 = (k + 1) % 5
        l = (xx - xs[k]) * (ys[k2] - ys[k]) - (y - ys[k]) * (xs[k2] - xs[k])
        ps.append(_sign_or(l, 0.))
    abs_sum = ps[0].abs()
    tot = ps[0]
    for p in ps[1:]:
        abs_sum = abs_sum + p.abs()
        tot = tot + p
    return (abs_sum - tot.abs()) < 0.5


def cell_corners(grid: Grid, i, j):
    """``(x1, x2, x3, x4, y1, y2, y3, y4)`` of cells (i, j): SW, SE, NE,
    NW."""
    i, j = i.long(), j.long()
    return (grid.lonc[i, j], grid.lonc[i + 1, j], grid.lonc[i + 1, j + 1],
            grid.lonc[i, j + 1], grid.latc[i, j], grid.latc[i + 1, j],
            grid.latc[i + 1, j + 1], grid.latc[i, j + 1])


def is_point_in_cell(grid: Grid, x, y, i, j, Lx: float):
    """Quad-cell membership with the latitude bounding-box reject
    (icebergs_framework.F90:6076-6160)."""
    x1, x2, x3, x4, y1, y2, y3, y4 = cell_corners(grid, i, j)
    ylo = torch.minimum(torch.minimum(y1, y2), torch.minimum(y3, y4))
    yhi = torch.maximum(torch.maximum(y1, y2), torch.maximum(y3, y4))
    in_y = (y >= ylo) & (y <= yhi)
    return in_y & sum_sign_dot_prod4(x1, y1, x2, y2, x3, y3, x4, y4, x, y,
                                     Lx)


def calc_xiyj(x1, x2, x3, x4, y1, y2, y3, y4, x, y, Lx: float):
    """Non-dimensional (xi, yj) of (x, y) in the quad
    (icebergs_framework.F90:6439-6534): the quadratic in yj by the
    stable root pair (q / a, c / q), the root nearest 0.5, then xi back
    substituted with the reference's fallback ladder."""
    alpha = x2 - x1
    delta = y2 - y1
    beta = x4 - x1
    epsilon = y4 - y1
    gamma = (x3 - x1) - (alpha + beta)
    kappa = (y3 - y1) - (delta + epsilon)
    a = kappa * beta - gamma * epsilon
    dx = apply_modulo_around_point(x, x1, Lx) - x1
    dy = y - y1
    b = (delta * beta - alpha * epsilon) - (kappa * dx - gamma * dy)
    c = alpha * dy - delta * dx

    d = 0.25 * (b * b) - a * c
    sq = torch.sqrt(d.clamp(min=0.))
    sgn_b = torch.where(b >= 0., 1., -1.)
    q = -(0.5 * b + sgn_b * sq)
    qsafe = torch.where(q != 0., q, 1.)
    big_a = a.abs() > 1.e-12
    asafe = torch.where(big_a, a, 1.)
    yy1 = q / asafe
    yy2 = torch.where(q != 0., c / qsafe, yy1)
    yj_quad = torch.where((yy1 - 0.5).abs() < (yy2 - 0.5).abs(), yy1, yy2)
    yj_lin = torch.where(b != 0., -c / torch.where(b != 0., b, 1.), 0.)
    yj = torch.where(big_a, yj_quad, yj_lin)

    aa = alpha + gamma * yj
    bb = delta + kappa * yj
    cc = (epsilon * alpha - beta * delta) + (epsilon * gamma
                                             - beta * kappa) * yj
    xi_a = (dx - beta * yj) / torch.where(aa != 0., aa, 1.)
    xi_b = (dy - epsilon * yj) / torch.where(bb != 0., bb, 1.)
    xi_c = (epsilon * dx - beta * dy) / torch.where(cc != 0., cc, 1.)
    xi = torch.where(aa != 0., xi_a, torch.where(bb != 0., xi_b, xi_c))
    return xi, yj


def pos_within_cell_curvilinear(grid: Grid, x, y, i, j, Lx: float):
    """``(xi, yj, inside)`` on a general quad grid (pos_within_cell's
    calc_xiyj path, icebergs_framework.F90:6310-6437)."""
    x1, x2, x3, x4, y1, y2, y3, y4 = cell_corners(grid, i, j)
    xi, yj = calc_xiyj(x1, x2, x3, x4, y1, y2, y3, y4, x, y, Lx)
    inside = (xi >= 0.) & (xi < 1.) & (yj >= 0.) & (yj < 1.)
    return xi, yj, inside


def find_cell_local(grid: Grid, x, y, i0, j0, Lx: float, radius: int = 2):
    """The first cell of the (2r+1)^2 neighbourhood of (i0, j0), rows
    south to north and each west to east, that holds (x, y) (find_cell's
    neighbourhood walk, icebergs_framework.F90:5710-).  Returns
    ``(i, j, found)``; where nothing holds the point, (i0, j0)."""
    best_i, best_j = i0, j0
    found = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for dj in range(-radius, radius + 1):
        for di in range(-radius, radius + 1):
            ii = (i0 + di).clamp(0, grid.nx - 1)
            jj = (j0 + dj).clamp(0, grid.ny - 1)
            hit = is_point_in_cell(grid, x, y, ii, jj, Lx) & ~found
            best_i = torch.where(hit, ii, best_i)
            best_j = torch.where(hit, jj, best_j)
            found = found | hit
    return best_i, best_j, found


def find_cell_by_search_host(grid: Grid, x, y, Lx: float):
    """Global search on the host (restart reads): the cell whose corner
    mean is nearest (find_cell_by_search's cost minimisation,
    icebergs_framework.F90:5760-), confirmed by the exact membership test
    over its 3x3 neighbourhood.  ``x``, ``y`` numpy arrays; returns numpy
    ``(i, j, found)``."""
    lonc = grid.lonc.cpu().numpy()
    latc = grid.latc.cpu().numpy()
    cx = 0.25 * (lonc[:-1, :-1] + lonc[1:, :-1] + lonc[:-1, 1:]
                 + lonc[1:, 1:])
    cy = 0.25 * (latc[:-1, :-1] + latc[1:, :-1] + latc[:-1, 1:]
                 + latc[1:, 1:])
    n = len(x)
    i0 = np.zeros(n, np.int32)
    j0 = np.zeros(n, np.int32)
    for k in range(n):
        d2 = (cx - x[k]) ** 2 + (cy - y[k]) ** 2
        i0[k], j0[k] = np.unravel_index(np.argmin(d2), d2.shape)
    dev = grid.lonc.device
    tx = torch.as_tensor(np.asarray(x), dtype=grid.lonc.dtype, device=dev)
    ty = torch.as_tensor(np.asarray(y), dtype=grid.latc.dtype, device=dev)
    i, j, found = find_cell_local(grid, tx, ty, torch.as_tensor(i0,
                                                               device=dev),
                                  torch.as_tensor(j0, device=dev), Lx,
                                  radius=1)
    return i.cpu().numpy(), j.cpu().numpy(), found.cpu().numpy()

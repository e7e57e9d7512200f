"""Exact hexagon/quadrant intersection areas (vectorised polygon clipping).

Counterpart of ``icebergs_tpu/ops/hexagon.py`` (port of the reference's
``Hexagon_into_quadrants_using_triangles``, ``src/icebergs.F90:
4244-4672``): the areas of a regular hexagon (apothem ``H``, orientation
``theta`` degrees, centre ``(x0, y0)``) in the four plane quadrants, by
clipping the convex hexagon against the half-planes x >= 0 and y >= 0
with a fixed-size Sutherland-Hodgman pass, branch-free over the slab.
Plain PyTorch (the JAX package runs it through XLA, not a TPU kernel).

The polygons are held slot-major, (K slots, N hexagons), so that each
slot is one contiguous row.  Every step rounds as the JAX expression
does: each clipped vertex lands on a zero slot of its own (the JAX
package's scatter-add: ``0 + v``), the shoelace and the residual's
quadrant sums run in slot order from +0, a division by a Python scalar
keeps the division (:func:`.dem.tdiv`), and the residual goes to the
first largest quadrant (``torch.argmax``, as ``jnp.argmax``).

Quadrant convention of the reference: Q1 = (+, +), Q2 = (-, +),
Q3 = (-, -), Q4 = (+, -).
"""

from __future__ import annotations

import math

import torch

from .dem import tdiv


def _hexagon_vertices(x0, y0, H, theta_deg):
    """Corners of the hexagon (flat-top, circumradius S = 2H/sqrt(3)),
    as the vertex layout at icebergs.F90:4592-4607: (6, N) x and y."""
    S = (2. / math.sqrt(3.)) * H
    hx = tdiv(H, math.sqrt(3.))
    z = torch.zeros_like(H)
    cx = torch.stack([S, hx, -hx, -S, -hx, hx])
    cy = torch.stack([z, H, H, z, -H, -H])
    th = torch.deg2rad(theta_deg)
    ct, st = torch.cos(th), torch.sin(th)
    rx = cx * ct - cy * st + x0
    ry = cx * st + cy * ct + y0
    return rx, ry


def slot_sum(x, dim: int = 0):
    """Sum over the slots of ``dim`` in slot order from +0 (XLA:CPU's
    reduce)."""
    acc = torch.zeros_like(x.select(dim, 0))
    for k in range(x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


def _next_slot(valid):
    """Each slot's successor in the live prefix, wrapping to slot 0."""
    K = valid.shape[0]
    n = valid.sum(dim=0, dtype=torch.int64)
    idx = torch.arange(K, device=valid.device)[:, None]
    return torch.where(idx + 1 < n[None, :], idx + 1, 0)


def _clip_halfplane(px, py, valid, axis: str):
    """Clip the polygons ``(px, py)`` (K slots x N, ``valid`` a live
    prefix) to the half-plane where coordinate ``axis`` is >= 0: K + 1
    slots out."""
    K, N = px.shape
    nxt = _next_slot(valid)
    qx = torch.gather(px, 0, nxt)
    qy = torch.gather(py, 0, nxt)
    d_cur, d_nxt = (px, qx) if axis == "x" else (py, qy)
    inside_cur = d_cur >= 0.
    inside_nxt = d_nxt >= 0.
    denom = d_nxt - d_cur
    t = torch.where(denom.abs() > 0.,
                    -d_cur / torch.where(denom == 0., 1., denom), 0.)
    # the intersection lies on the axis: its coordinate there is 0
    if axis == "x":
        ix = torch.zeros_like(px)
        iy = py + t * (qy - py)
    else:
        ix = px + t * (qx - px)
        iy = torch.zeros_like(py)

    emit_cur = inside_cur & valid
    emit_int = (inside_cur ^ inside_nxt) & valid
    counts = emit_cur.to(torch.int64) + emit_int.to(torch.int64)
    pos_cur = torch.cumsum(counts, dim=0) - counts
    pos_int = pos_cur + emit_cur.to(torch.int64)

    Ko = K + 1
    out_x = px.new_zeros(Ko, N)
    out_y = px.new_zeros(Ko, N)
    # each emitted vertex writes its own slot once, as 0 + v (the JAX
    # package's scatter-add into zeros); the rest write the last slot,
    # rebuilt below
    for emit, pos, vx, vy in ((emit_cur, pos_cur, px, py),
                              (emit_int, pos_int, ix, iy)):
        p = torch.where(emit, pos, Ko - 1)
        out_x.scatter_(0, p, torch.where(emit, vx, 0.) + 0.)
        out_y.scatter_(0, p, torch.where(emit, vy, 0.) + 0.)
    # the emitted vertices fill a prefix of the slots
    total = counts.sum(dim=0)
    out_v = torch.arange(Ko, device=px.device)[:, None] < total[None, :]
    good_last = out_v[Ko - 1]
    real_cur = emit_cur & (pos_cur == Ko - 1)
    real_int = emit_int & (pos_int == Ko - 1)
    lx = (slot_sum(torch.where(real_cur, px, 0.))
          + slot_sum(torch.where(real_int, ix, 0.)))
    ly = (slot_sum(torch.where(real_cur, py, 0.))
          + slot_sum(torch.where(real_int, iy, 0.)))
    out_x[Ko - 1] = torch.where(good_last, lx, 0.)
    out_y[Ko - 1] = torch.where(good_last, ly, 0.)
    return out_x, out_y, out_v


def _shoelace(px, py, valid):
    """Signed polygon area over the live prefix slots."""
    nxt = _next_slot(valid)
    qx = torch.gather(px, 0, nxt)
    qy = torch.gather(py, 0, nxt)
    cross = px * qy - qx * py
    return 0.5 * slot_sum(torch.where(valid, cross, 0.))


def hexagon_into_quadrants_using_triangles(x0, y0, H, theta_deg):
    """Areas of the hexagon in each quadrant: ``(A_hex, Q1, Q2, Q3, Q4)``
    (icebergs.F90:4562-4670), by exact convex clipping; 0-d inputs give
    0-d outputs."""
    flat = x0.dim() == 0
    if flat:
        x0, y0, H, theta_deg = (torch.atleast_1d(a)
                                for a in (x0, y0, H, theta_deg))
    px, py = _hexagon_vertices(x0, y0, H, theta_deg)
    valid = torch.ones(px.shape, dtype=torch.bool, device=px.device)

    A = _shoelace(px, py, valid)
    rx, ry, rv = _clip_halfplane(px, py, valid, "x")
    Ax = _shoelace(rx, ry, rv)
    ux, uy, uv = _clip_halfplane(px, py, valid, "y")
    Ay = _shoelace(ux, uy, uv)
    qx, qy, qv = _clip_halfplane(rx, ry, rv, "y")
    Axy = _shoelace(qx, qy, qv)

    Q1 = Axy.clamp(min=0.)
    Q2 = (Ay - Axy).clamp(min=0.)
    Q4 = (Ax - Axy).clamp(min=0.)
    Q3 = (A - Ax - Ay + Axy).clamp(min=0.)

    # the residual rounding goes to the first largest quadrant
    # (icebergs.F90:4650-4666)
    err = A - (Q1 + Q2 + Q3 + Q4)
    stacked = torch.stack([Q1, Q2, Q3, Q4])
    biggest = torch.argmax(stacked, dim=0)
    corr = torch.arange(4, device=A.device)[:, None] == biggest[None, :]
    stacked = stacked + torch.where(corr, err[None, :], 0.)
    Q1, Q2, Q3, Q4 = stacked.unbind(0)
    if flat:
        return A[0], Q1[0], Q2[0], Q3[0], Q4[0]
    return A, Q1, Q2, Q3, Q4

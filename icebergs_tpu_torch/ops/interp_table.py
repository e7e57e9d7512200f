"""Single-gather table interpolation of the forcing to the bergs.

Counterpart of the table path of ``icebergs_tpu/ops/pallas_interp.py``
(``interp_cell_table``, ``_env_rows_from_slots``, ``_quad_od_from_rows``,
``interp_to_bergs_table``; ``pallas_interp.py:69-273, 386-496``): every
per-cell quantity the interpolation reads is precomputed into a
(64, ncells) slot table, each berg reads its cell's column through K1
(:func:`..ops.pack.permute_cols_u32` from the table's rows, idx = cell
key; by the row route where the keys are random), and the per-berg
bilinear / stencil arithmetic follows term for term.  The walk's 5x5 and
9x9 land-mask anchors ride the same read.  MTS configurations read the
ocean depth through the quadratic stencil instead, from 25 more rows
(``with_quad_od``; 89 in all, which K1 moves as it moves 64).
"""

from __future__ import annotations

import torch

from ..config import IcebergsConfig
from ..grid import Grid
from .interp import global_offsets, stencil_lo
from .pack import permute_cols_u32, to_bits

# slot-row layout (pallas_interp.py:48-66)
S_CORN = 0            # field k, corner (io, jo) -> row 4k + 2io + jo
S_DDX = 32            # ddx at ((0,1),(0,0),(0,-1),(-1,1),(-1,0),(-1,-1))
S_DDY = 38            # ddy at ((1,0),(0,0),(-1,0),(1,-1),(0,-1),(-1,-1))
S_SST, S_SSS, S_CN, S_HI, S_OD = 44, 45, 46, 47, 48
S_NANX, S_NANY = 49, 50
S_M25L, S_M25H = 51, 52
S_M81 = 53            # rows 53..61
S_NROWS = 64
S_QOD = S_NROWS       # 25 quad-od rows when with_quad_od


def interp_cell_table(grid: Grid, frc, cfg: IcebergsConfig,
                      with_quad_od: bool = False):
    """(S_NROWS, ncells) float32 per-cell slot table in cell-key order
    (key = j*nx + i): the corner values, SSH-stencil slopes with their
    nonfinite-indicator bits, the A-grid scalars, ocean depth + ssh and
    the walk anchors — elementwise the values the JAX table holds.
    ``with_quad_od`` appends the 25 rows of the 5x5 (edge-padded)
    neighbourhood of ``ocean_depth + ssh`` that the MTS quadratic depth
    read touches."""
    rows = interp_cell_rows(grid, frc, cfg, with_quad_od)
    z = torch.zeros(grid.nx * grid.ny, dtype=torch.float32,
                    device=grid.msk.device)
    return torch.stack([z if r is None else r for r in rows])


def interp_cell_rows(grid: Grid, frc, cfg: IcebergsConfig,
                     with_quad_od: bool = False):
    """:func:`interp_cell_table` before the stack: its rows as a list of
    (ncells,) float32 tensors, ``None`` for the rows that are zero."""
    from ..dynamics import _msk25_table, _msk81_rows

    nx, ny = grid.nx, grid.ny
    dev = grid.msk.device
    rows = [None] * S_NROWS

    def key_order(a):                    # (nx, ny) -> (ncells,)
        return a.T.reshape(-1)

    for k, f in enumerate([grid.cosc, grid.sinc, frc.uo, frc.vo, frc.ui,
                           frc.vi, frc.ua, frc.va]):
        for io in (0, 1):
            for jo in (0, 1):
                rows[S_CORN + 4 * k + 2 * io + jo] = key_order(
                    f[io:io + nx, jo:jo + ny])

    ii = torch.arange(nx, device=dev) + 1
    jj = torch.arange(ny, device=dev) + 1

    def center(f, di, dj):
        # interior read of a halo-padded field at (i+1+di, j+1+dj),
        # edge-clamped like the reference's edge padding
        return f[(ii + di).clamp(0, nx + 1)][:, (jj + dj).clamp(0, ny + 1)]

    ssh, msk, dx, dy = frc.ssh, grid.msk, grid.dx, grid.dy

    def ddx(o0, o1):
        dxp = 0.5 * (center(dx, o0 + 1, o1) + center(dx, o0 + 1, o1 - 1))
        dx0 = 0.5 * (center(dx, o0, o1) + center(dx, o0, o1 - 1))
        den = dx0 + dxp
        v = 2. * (center(ssh, o0 + 1, o1) - center(ssh, o0, o1)) \
            / den.clamp(min=1e-30) \
            * center(msk, o0 + 1, o1) * center(msk, o0, o1)
        return v, den == 0.

    def ddy(o0, o1):
        dyp = 0.5 * (center(dy, o0, o1 + 1) + center(dy, o0 - 1, o1 + 1))
        dy0 = 0.5 * (center(dy, o0, o1) + center(dy, o0 - 1, o1))
        den = dy0 + dyp
        v = 2. * (center(ssh, o0, o1 + 1) - center(ssh, o0, o1)) \
            / den.clamp(min=1e-30) \
            * center(msk, o0, o1 + 1) * center(msk, o0, o1)
        return v, den == 0.

    # nonfinite stencil slots (den == 0) are stored as 0 with their bit
    # set; _env_rows_from_slots re-applies the reference NaN scrub
    for base, nan_row, fn, offs in (
            (S_DDX, S_NANX, ddx, ((0, 1), (0, 0), (0, -1),
                                  (-1, 1), (-1, 0), (-1, -1))),
            (S_DDY, S_NANY, ddy, ((1, 0), (0, 0), (-1, 0),
                                  (1, -1), (0, -1), (-1, -1)))):
        bits = torch.zeros(nx * ny, dtype=torch.float32, device=dev)
        for s, o in enumerate(offs):
            v, bad = fn(*o)
            v, bad = key_order(v), key_order(bad)
            bits = bits + torch.where(bad, float(1 << s), 0.)
            rows[base + s] = torch.where(bad, 0., v)
        rows[nan_row] = bits

    def interior(f):
        return key_order(f[1:nx + 1, 1:ny + 1])

    rows[S_SST] = interior(frc.sst)
    rows[S_SSS] = interior(frc.sss)
    rows[S_CN] = interior(frc.cn)
    rows[S_HI] = interior(frc.hi)
    rows[S_OD] = interior(grid.ocean_depth + frc.ssh)

    # walk anchors: the 25 packed bits split 13 + 12 so each row is
    # f32-exact
    m25 = key_order(_msk25_table(grid.msk)[3:nx + 3, 3:ny + 3])
    rows[S_M25L] = (m25 & 0x1FFF).to(torch.float32)
    rows[S_M25H] = (m25 >> 13).to(torch.float32)
    m81 = _msk81_rows(grid.msk)
    for k in range(9):
        rows[S_M81 + k] = key_order(
            m81[k, 5:nx + 5, 5:ny + 5]).to(torch.float32)

    if with_quad_od:
        # padded-array read fld[(i+1)+dx, (j+1)+dy] per interior cell
        fld = grid.ocean_depth + frc.ssh
        fldq = torch.nn.functional.pad(fld[None, None], (2, 2, 2, 2),
                                       mode="replicate")[0, 0]
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                rows.append(key_order(fldq[3 + dx:3 + dx + nx,
                                           3 + dy:3 + dy + ny]))
    return [None if r is None else r.to(torch.float32) for r in rows]


def _quad_od_from_rows(read, key, xi, yj, grid: Grid, cfg: IcebergsConfig):
    """MTS quadratic depth (``quad_interp_from_agrid``, regular grid,
    icebergs_framework.F90:7168-7255) from the 25 quad-od rows, with the
    local coordinate taken from ``i + xi`` as the JAX table path does."""
    nx, ny = grid.nx, grid.ny
    i = key % nx
    j = torch.div(key, nx, rounding_mode="floor")
    mind = 0 if cfg.rev_mind else 1
    # the window by the global cell's parity (:func:`.interp.stencil_lo`)
    io, jo, _, _ = global_offsets(grid)
    is_lo = stencil_lo(i, xi, nx, io, grid.nxg, mind)
    js_lo = stencil_lo(j, yj, ny, jo, grid.nyg, mind)
    dxo = is_lo - i
    dyo = js_lo - j
    xloc = (i - is_lo).to(xi.dtype) + xi - 1.5
    yloc = (j - js_lo).to(yj.dtype) + yj - 1.5
    xb = (0.5 * xloc * (xloc - 1.), (1. + xloc) * (1. - xloc),
          0.5 * xloc * (xloc + 1.))
    yb = (0.5 * yloc * (yloc - 1.), (1. + yloc) * (1. - yloc),
          0.5 * yloc * (yloc + 1.))

    def coeff(basis, d, o):
        c = torch.zeros_like(basis[0])
        for a in range(3):
            c = c + torch.where(d == o - a, basis[a], 0.)
        return c

    cx = [coeff(xb, dxo, o) for o in (-2, -1, 0, 1, 2)]
    cy = [coeff(yb, dyo, o) for o in (-2, -1, 0, 1, 2)]
    out = torch.zeros_like(xi)
    for oy in range(5):
        for ox in range(5):
            out = out + cx[ox] * cy[oy] * read(S_QOD + oy * 5 + ox)
    return out


def _env_rows_from_slots(read, xi, yj, cfg: IcebergsConfig):
    """Per-berg interpolation arithmetic on slot rows (``read(s)`` gives
    slot row ``s`` for every berg), term for term as the JAX function."""
    ob = cfg.old_bug_bilin
    vals = []
    for k in range(8):
        f00 = read(S_CORN + 4 * k + 0)
        f01 = read(S_CORN + 4 * k + 1)
        f10 = read(S_CORN + 4 * k + 2)
        f11 = read(S_CORN + 4 * k + 3)
        if ob:
            vals.append((f11 * (1. - xi) + f01 * xi) * (1. - yj)
                        + (f10 * (1. - xi) + f00 * xi) * yj)
        else:
            vals.append((f11 * xi + f01 * (1. - xi)) * yj
                        + (f10 * xi + f00 * (1. - xi)) * (1. - yj))
    cos_rot, sin_rot = vals[0], vals[1]
    uo, vo, ui, vi, ua, va = vals[2:8]

    dX = [read(S_DDX + s) for s in range(6)]
    dY = [read(S_DDY + s) for s in range(6)]
    hxp = torch.where(yj >= 0.5, (yj - 0.5) * dX[0] + (1.5 - yj) * dX[1],
                      (yj + 0.5) * dX[1] + (0.5 - yj) * dX[2])
    hxm = torch.where(yj >= 0.5, (yj - 0.5) * dX[3] + (1.5 - yj) * dX[4],
                      (yj + 0.5) * dX[4] + (0.5 - yj) * dX[5])
    ssh_x = xi * hxp + (1. - xi) * hxm
    hyp = torch.where(xi >= 0.5, (xi - 0.5) * dY[0] + (1.5 - xi) * dY[1],
                      (xi + 0.5) * dY[1] + (0.5 - xi) * dY[2])
    hym = torch.where(xi >= 0.5, (xi - 0.5) * dY[3] + (1.5 - xi) * dY[4],
                      (xi + 0.5) * dY[4] + (0.5 - xi) * dY[5])
    ssh_y = yj * hyp + (1. - yj) * hym

    def rot(u, v):
        return cos_rot * u + sin_rot * v, cos_rot * v - sin_rot * u

    uo, vo = rot(uo, vo)
    ui, vi = rot(ui, vi)
    ua, va = rot(ua, va)
    ssh_x, ssh_y = rot(ssh_x, ssh_y)

    # the reference NaN scrub (icebergs.F90:4893-4894) from the table's
    # nonfinite-indicator bits: slots (0,1,3,4) feed the yj >= 0.5 /
    # xi >= 0.5 branch, slots (1,2,4,5) the other
    bx = read(S_NANX).to(torch.int32)
    by = read(S_NANY).to(torch.int32)
    mlo, mhi = 0b011011, 0b110110
    px = bx & torch.where(yj >= 0.5, mlo, mhi).to(torch.int32)
    py = by & torch.where(xi >= 0.5, mlo, mhi).to(torch.int32)
    poison = (px | py) != 0
    ssh_x = torch.where(poison, 0., ssh_x)
    ssh_y = torch.where(poison, 0., ssh_y)
    return [uo, vo, ui, vi, ua, va, ssh_x, ssh_y,
            read(S_SST), read(S_SSS), read(S_CN), read(S_HI),
            read(S_OD), read(S_M25L), read(S_M25H)]


def interp_to_bergs_table(st, grid: Grid, frc, cfg: IcebergsConfig, *,
                          via_rows: bool = False):
    """Cache the interpolated environment on every berg.

    Returns ``(state_with_env, (m25_pre, m81_pre))``: the walk's packed
    5x5 anchor (N,) and 9x9 anchor rows (9, N), int32.  MTS configs take
    ``od`` from the quadratic stencil rows.  ``via_rows`` reads the table
    by K1's row route, for a slab whose cell keys are in random order."""
    if (cfg.coastal_drift != 0. or cfg.tidal_drift != 0.
            or (cfg.mts and cfg.A68_test)):
        raise ValueError("the table holds no coastal / tidal drift and no "
                         "A68 depth: such configs read interp_flds "
                         "(ops.interp.use_interp_table)")
    ncells = grid.nx * grid.ny
    key = torch.where(st.alive, st.jne * grid.nx + st.ine,
                      ncells).to(torch.int32)
    # K1 reads the table's rows where they lie (no stack); the dead key
    # (ncells) reads zeros
    tbl = interp_cell_rows(grid, frc, cfg, with_quad_od=cfg.mts)
    rows = permute_cols_u32([to_bits(r) for r in tbl], key,
                            via_rows=via_rows).view(torch.float32)

    def read(s):
        return rows[s]

    out = _env_rows_from_slots(read, st.xi, st.yj, cfg)
    if cfg.mts:
        out[12] = _quad_od_from_rows(read, key, st.xi, st.yj, grid, cfg)
    m25_pre = out[13].to(torch.int32) + out[14].to(torch.int32) * 8192
    m81_pre = torch.stack([read(S_M81 + k).to(torch.int32)
                           for k in range(9)])
    st = st.replace(uo=out[0], vo=out[1], ui=out[2], vi=out[3],
                    ua=out[4], va=out[5], ssh_x=out[6], ssh_y=out[7],
                    sst=out[8], sss=out[9], cn=out[10], hi=out[11],
                    od=out[12])
    return st, (m25_pre, m81_pre)

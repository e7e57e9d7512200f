"""K3: per-cell segment sums of the reproducible spreading pass.

Counterpart of ``icebergs_tpu/ops/pallas_spread.py`` (``cell_tables``,
``_weights_from_rows``, ``build_rows``, ``segment_spread_sums``,
``spread_cell_sums``).  Each cell's rows are
summed in (cell, id) order — the association of the TPU kernel's
selection matmul — by the CUDA kernel (one thread per cell) and by the
plain version (one vectorized add per occupancy rank).

The TPU kernel's window-overflow flags are computed as the reference
computes them and reported; neither version here has a window, so their
sums are valid either way.  (Where the JAX package sees overflow it
switches to a tree-sum fallback whose sums differ only in association.)
"""

from __future__ import annotations

import torch

from .. import cuda_build
from ..config import IcebergsConfig
from .accel import rdiv

# payload rows of the sorted stack (pallas_spread.py:47-60)
R_KEY, R_XI, R_YJ, R_AREA, R_MASS, R_LWMS, R_U, R_V = range(8)
R_MASSMS, R_VIRT, R_BITS, R_FLB, R_FLBB = 8, 9, 10, 11, 12
R_NFIX = 13
# per-cell table rows: 9 neighbour masks (dj, di row-major), cell area
T_MSK0 = 0
T_AREA = 9
T_NROWS = 16
N_SPREAD, N_CELLCOL = 36, 7


def cell_tables(grid):
    """(T_NROWS, ncells) static per-cell table (cell id = j*nx + i)."""
    nx, ny = grid.nx, grid.ny
    rows = [grid.msk[1 + di:nx + 1 + di, 1 + dj:ny + 1 + dj].T.reshape(-1)
            for dj in (-1, 0, 1) for di in (-1, 0, 1)]
    rows.append(grid.area[1:-1, 1:-1].T.reshape(-1))
    z = torch.zeros_like(rows[0])
    rows += [z] * (T_NROWS - len(rows))
    return torch.stack([r.to(torch.float32) for r in rows])


def _weights_from_rows(rows, tblrows, cfg: IcebergsConfig):
    """Rectangle spreading weights (9, W) from payload rows and the rows'
    cell-table columns (spread_weights' rectangle branch,
    icebergs.F90:3960-4001)."""
    x = rows[R_XI]
    y = rows[R_YJ]
    area_cell = tblrows[T_AREA]
    m = [tblrows[T_MSK0 + k] for k in range(9)]
    if cfg.use_old_spreading:
        xL = (0.5 - x).clamp(min=0.).clamp(max=0.5)
        xR = (x - 0.5).clamp(min=0.).clamp(max=0.5)
        yD = (0.5 - y).clamp(min=0.).clamp(max=0.5)
        yU = (y - 0.5).clamp(min=0.).clamp(max=0.5)
    else:
        L = torch.where(area_cell > 0.,
                        torch.sqrt(rows[R_AREA] / area_cell.clamp(min=1e-30)
                                   ).clamp(max=1.0), 1.0)
        Ls = L.clamp(min=1e-30)
        inv = rdiv(1., Ls)
        xL = (0.5 - x / Ls).clamp(min=0.).clamp(max=0.5)
        xR = (x / Ls + (0.5 - inv)).clamp(min=0.).clamp(max=0.5)
        yD = (0.5 - y / Ls).clamp(min=0.).clamp(max=0.5)
        yU = (y / Ls + (0.5 - inv)).clamp(min=0.).clamp(max=0.5)
    xC = (1. - (xL + xR)).clamp(min=0.)
    yC = (1. - (yD + yU)).clamp(min=0.)
    yDxL = yD * xL * m[0]
    yDxC = yD * xC * m[1]
    yDxR = yD * xR * m[2]
    yCxL = yC * xL * m[3]
    yCxR = yC * xR * m[5]
    yUxL = yU * xL * m[6]
    yUxC = yU * xC * m[7]
    yUxR = yU * xR * m[8]
    yCxC = 1. - (((yDxL + yUxR) + (yDxR + yUxL))
                 + ((yCxL + yCxR) + (yDxC + yUxC)))
    return torch.stack([yDxL, yDxC, yDxR, yCxL, yCxC, yCxR,
                        yUxL, yUxC, yUxR])


def auto_window(N, ncells, cell_block, headroom: float = 4.0):
    """The TPU kernel's static window rows per cell block."""
    exp = cell_block * N / max(ncells, 1)
    return -(-int(exp * headroom + 256) // 128) * 128


def window_bad(cell_starts, ncells: int, N: int, cell_block: int = 128,
               window: int = None):
    """(nblocks,) bool: cell blocks whose rows overflow the TPU kernel's
    window (``pallas_spread.py:178-183``)."""
    if window is None:
        window = auto_window(N, ncells, cell_block)
    WL = -(-(window + 128) // 128) * 128
    nblocks = -(-ncells // cell_block)
    b0 = torch.arange(nblocks, device=cell_starts.device) * cell_block
    cs = cell_starts.long()
    ws128 = cs[b0.clamp(max=ncells)] // 128
    wend = cs[(b0 + cell_block).clamp(max=ncells)]
    return (wend - ws128 * 128) > WL


def _row_products(rows_s, tbl, cfg: IcebergsConfig):
    """(43 + n_extra, N) per-row summands in the S column order."""
    ncells = tbl.shape[1]
    key = rows_s[R_KEY].long().clamp(max=ncells - 1)
    tblrows = tbl[:, key]
    w9 = _weights_from_rows(rows_s, tblrows, cfg)
    area_c = tblrows[T_AREA].clamp(min=1e-30)
    u, v = rows_s[R_U], rows_s[R_V]
    LWms = rows_s[R_LWMS]
    vals = torch.stack([rows_s[R_MASS], LWms, u * LWms, v * LWms])
    P9 = (w9[:, None, :] * vals[None, :, :]).reshape(N_SPREAD, -1)
    w_cell = rows_s[R_MASSMS] / area_c
    Pc = torch.stack([w_cell, w_cell * u, w_cell * v, rows_s[R_VIRT],
                      rows_s[R_BITS], rows_s[R_FLB], rows_s[R_FLBB]])
    return torch.cat([P9, Pc, rows_s[R_NFIX:]])


def segment_spread_sums_plain(rows_s, cell_starts, tbl,
                              cfg: IcebergsConfig):
    """Plain version: add row ``cell_starts[c] + k`` to cell ``c`` for
    k = 0 .. max occupancy - 1, vectorized over cells — each cell's rows
    in sorted order, as the kernel adds them."""
    N = rows_s.shape[1]
    P = _row_products(rows_s, tbl, cfg)
    cs = cell_starts.long()
    first, occ = cs[:-1], cs[1:] - cs[:-1]
    S = torch.zeros(P.shape[0], first.shape[0], dtype=P.dtype,
                    device=P.device)
    for k in range(int(occ.max()) if occ.numel() else 0):
        r = (first + k).clamp(max=N - 1)
        S = S + torch.where(k < occ, P[:, r], 0.)
    return S.T.contiguous()


def segment_spread_sums(rows_s, cell_starts, tbl, cfg: IcebergsConfig,
                        n_extra: int, *, cell_block: int = 128,
                        window: int = None):
    """Per-cell sums of the 36 spread products, 7 cell columns and
    ``n_extra`` pass-through rows of the cell-sorted payload ``rows_s``
    ((13 + n_extra, N) float32, row R_KEY the sorted cell key).

    Returns ``(S (ncells, 43 + n_extra), bad (nblocks,) bool)``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``segment_spread_sums.launches``)."""
    R, N = rows_s.shape
    ncells = tbl.shape[1]
    if R != R_NFIX + n_extra or rows_s.dtype != torch.float32:
        raise ValueError(f"rows_s {tuple(rows_s.shape)} {rows_s.dtype} "
                         f"for n_extra={n_extra}")
    if tbl.shape[0] != T_NROWS or cell_starts.shape != (ncells + 1,):
        raise ValueError(f"tbl {tuple(tbl.shape)}, cell_starts "
                         f"{tuple(cell_starts.shape)}")
    if not (rows_s.device == cell_starts.device == tbl.device):
        raise ValueError("rows_s, cell_starts and tbl on different devices")
    bad = window_bad(cell_starts, ncells, N, cell_block, window)
    if rows_s.device.type == "cpu":
        return segment_spread_sums_plain(rows_s, cell_starts, tbl, cfg), bad
    if rows_s.device.type != "cuda":
        raise NotImplementedError(f"no K3 kernel for {rows_s.device}")
    lib = cuda_build.library()
    if n_extra > lib.ib_max_spread_extra():
        raise ValueError(f"n_extra={n_extra} > "
                         f"{lib.ib_max_spread_extra()}")
    if not (rows_s.is_contiguous() and tbl.is_contiguous()
            and cell_starts.dtype == torch.int32):
        raise ValueError("rows_s/tbl must be contiguous, cell_starts int32")
    S = torch.empty(ncells, N_SPREAD + N_CELLCOL + n_extra,
                    dtype=torch.float32, device=rows_s.device)
    cuda_build.check(lib.ib_segment_spread_sums(
        rows_s.data_ptr(), N, cell_starts.data_ptr(), tbl.data_ptr(),
        S.data_ptr(), ncells, n_extra, int(cfg.use_old_spreading),
        cuda_build.stream_ptr(rows_s.device)), "segment_spread_sums")
    segment_spread_sums.launches += 1
    return S, bad


segment_spread_sums.launches = 0


def build_rows(st, grid, frc, cfg: IcebergsConfig, extra_cols,
               key_alive=None):
    """The payload stack's rows + sort keys (``build_rows``,
    ``pallas_spread.py:492-552``).  ``key_alive`` is the sort key's
    aliveness (pre-thermodynamics); value columns mask with the current
    ``st.alive``."""
    from .spread import berg_spread_mass
    from .thermo import fl_bits_dimensions

    nx = grid.nx
    alive = st.alive
    if key_alive is None:
        key_alive = alive
    key = torch.where(key_alive, st.jne * nx + st.ine,
                      grid.nx * grid.ny).to(torch.int32)
    af = alive.to(st.lon.dtype)
    L, W, T = st.length, st.width, st.thickness
    Area = L * W
    Mass = torch.where(alive, berg_spread_mass(st, grid, frc, cfg), 0.)
    LWms = Area * st.mass_scaling * af
    massms = st.mass * st.mass_scaling * af
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    area_c = grid.area[I, J].clamp(min=1e-30)
    zeros = torch.zeros_like(L)
    if cfg.bergy_bit_erosion_fraction > 0.:
        Lbits = torch.minimum(torch.minimum(L, W),
                              T.clamp(max=40.)).clamp(min=1e-30)
        Abits = (st.mass_of_bits / cfg.rho_bergs) / Lbits
    else:
        Abits = zeros
    Abits_fl = Abits_flb = zeros
    if cfg.fl_style == 'fl_bits':
        Lfl, Wfl, Tfl = fl_bits_dimensions(cfg, T)
        Abits_fl = (st.mass_of_fl_bits / cfg.rho_bergs) \
            / Tfl.clamp(min=1e-30)
        if cfg.bergy_bit_erosion_fraction > 0.:
            Lb2 = torch.minimum(torch.minimum(Lfl, Wfl),
                                Tfl.clamp(max=40.)).clamp(min=1e-30)
            Abits_flb = (st.mass_of_fl_bergy_bits / cfg.rho_bergs) / Lb2
    virt = (W * L + Abits + Abits_fl + Abits_flb) * st.mass_scaling * af
    w_cell_grid = torch.where(alive, st.mass_scaling / area_c, 0.)
    bits = (st.mass_of_bits + st.mass_of_fl_bergy_bits) * w_cell_grid
    flb = st.mass_of_fl_bits * w_cell_grid
    flbb = st.mass_of_fl_bergy_bits * w_cell_grid
    rows = [key.to(st.lon.dtype), st.xi, st.yj, Area, Mass, LWms,
            st.uvel, st.vvel, massms, virt, bits, flb, flbb]
    return key, rows + list(extra_cols or [])


def spread_cell_sums(st, grid, frc, cfg: IcebergsConfig, extra_cols, *,
                     key_alive, cell_starts, cell_block: int = 128,
                     window: int = None):
    """End-to-end kernel path.  With ``cell_starts`` the state slab is
    already (cell, id) sorted for ``key_alive`` rows and the rows stack
    directly; without, the payload rows are moved into the (cell,
    id_cnt, id_ij) order by K1 (the JAX package's one payload sort) and
    the cell starts come from the sorted keys.  Returns ``(S, nbad)``."""
    from .pack import from_bits, permute_cols_u32, to_bits
    from .sorted import lex_cell_id_order, starts_from_sorted_key

    key, rows = build_rows(st, grid, frc, cfg, extra_cols,
                           key_alive=key_alive)
    if cell_starts is None:
        # K1 writes the sorted rows from the row tensors (no stack)
        order = lex_cell_id_order(key, st.id_cnt, st.id_ij)
        rows_s = from_bits(permute_cols_u32([to_bits(r) for r in rows],
                                            order), rows[0].dtype)
        cell_starts = starts_from_sorted_key(key[order.long()],
                                             grid.nx * grid.ny)
    else:
        rows_s = torch.stack(rows)
    S, bad = segment_spread_sums(
        rows_s, cell_starts.to(torch.int32), cell_tables(grid), cfg,
        len(extra_cols or []), cell_block=cell_block, window=window)
    return S, bad.sum(dtype=torch.int32)

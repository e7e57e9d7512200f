"""K3: per-cell segment sums of the reproducible spreading pass.

Counterpart of ``icebergs_tpu/ops/pallas_spread.py`` (``cell_tables``,
``_weights_from_rows``, ``build_rows``, ``segment_spread_sums``,
``spread_cell_sums``) together with the overflow switch of
``icebergs_tpu/ops/spread.py::_pallas_spread_sums``.

Two associations, as the JAX package sums:

- **sequential** (the TPU kernel's selection matmul, whose contraction
  runs in row order): each cell's rows added in (cell, id) order;
- **slot tree** (``_cell_slot_sums_scatter_t``, ``spread.py:274-300``):
  the cell's row of rank k < K-1 in slot k (``0 + r_k``), ranks >= K-1
  added into slot K-1 in row order, empty slots 0, then a fixed pairwise
  tree over the K = ``cfg.reprod_max_per_cell`` slots, zero-padded at odd
  levels.

The JAX package takes the tree for every cell of a call as soon as one
128-cell block's rows overflow the TPU kernel's window (``nbad > 0``):
a clustered world's coupler fields then differ from the sequential sums
by association.  Both versions here take the same switch: the CUDA kernel
computes the window flags and their count on the device and reads the
count there (no host sync); the plain version reads it on the host.

:func:`segment_sums` is K3's pass-through: the per-cell sums of given
columns in an association the caller fixes, for the other slot-sum
methods of :mod:`.spread`, by a kernel of its own
(``csrc/segment_sums.cu``).
"""

from __future__ import annotations

import array
import ctypes
import re

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
    """(T_NROWS, ncells) static per-cell table (cell id = j*nx + i).  It
    depends on the grid alone: callers build it once per grid."""
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


def window_lanes(N: int, ncells: int, cell_block: int = 128,
                 window: int = None) -> int:
    """The TPU kernel's window rows WL (128-aligned, with 128 of slop)."""
    if window is None:
        window = auto_window(N, ncells, cell_block)
    return -(-(window + 128) // 128) * 128


def window_bad(cell_starts, ncells: int, N: int, cell_block: int = 128,
               window: int = None):
    """(nblocks,) bool: cell blocks whose rows overflow the TPU kernel's
    window (``pallas_spread.py:178-183``)."""
    WL = window_lanes(N, ncells, cell_block, window)
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


def slot_tree(x):
    """The fixed pairwise tree over the last axis, zero-padded to even at
    each level (``_cell_slot_sums_scatter_t``'s reduction)."""
    k = x.shape[-1]
    while k > 1:
        if k % 2:
            x = torch.cat([x, x.new_zeros(*x.shape[:-1], 1)], dim=-1)
            k += 1
        x = x[..., 0::2] + x[..., 1::2]
        k //= 2
    return x[..., 0]


def segment_spread_sums_plain(rows_s, cell_starts, tbl,
                              cfg: IcebergsConfig, tree: bool = False):
    """Plain version, vectorized over cells: the row of rank k of every
    cell is ``P[:, cell_starts[c] + k]``.  Sequential (``tree`` false):
    one add per rank, in rank order.  Slot tree: ranks k < K-1 into slot
    k, the rest added into slot K-1 in rank order, then
    :func:`slot_tree` (``K = cfg.reprod_max_per_cell``)."""
    return _sums_plain(_row_products(rows_s, tbl, cfg), cell_starts,
                       cfg.reprod_max_per_cell, tree)


def _sums_plain(P, cell_starts, K: int, tree: bool):
    """:func:`segment_spread_sums_plain` on per-row summands ``P`` (F, N):
    (ncells, F)."""
    N = P.shape[1]
    cs = cell_starts.long()
    first, occ = cs[:-1], cs[1:] - cs[:-1]
    zero = torch.zeros(P.shape[0], first.shape[0], dtype=P.dtype,
                       device=P.device)
    nmax = int(occ.max()) if occ.numel() else 0

    def rank(k):
        return torch.where(k < occ, P[:, (first + k).clamp(max=N - 1)], 0.)
    if not tree:
        S = zero
        for k in range(nmax):
            S = S + rank(k)
        return S.T.contiguous()
    slots = [zero + rank(k) if k < nmax else zero for k in range(K - 1)]
    tail = zero
    for k in range(K - 1, nmax):
        tail = tail + rank(k)
    return slot_tree(torch.stack(slots + [tail], dim=-1)).T.contiguous()


# columns a call may pass as a sequence (csrc/segment_sums.cu MAX_TABLE)
MAX_TABLE_COLS = 128


def segment_sums(cols, cell_starts, K: int, tree: bool):
    """Per-cell sums of cell-sorted columns in a chosen association: K3's
    pass-through, ``tree`` the slot tree over K slots, else sequential in
    row order.  ``cols``: F (N,) float32 columns in sorted order, as a
    sequence or the rows of an (F, N) matrix; ``cell_starts``: (ncells +
    1,) int32.  Returns (ncells, F).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/segment_sums.cu`` once a call for any F (counted in
    ``segment_sums.launches``), the association a kernel argument.  The
    kernel reads the columns where they lie: an (F, N) matrix by its base
    and row stride, a sequence by address (at most ``MAX_TABLE_COLS``
    columns); each column's own stride must be 1."""
    if not torch.is_tensor(cols):
        cols = list(cols)
    dev = cols[0].device
    ncells = cell_starts.shape[0] - 1
    if dev.type == "cpu":
        M = cols if torch.is_tensor(cols) else torch.stack(cols)
        return _sums_plain(M, cell_starts, K, tree)
    if dev.type != "cuda":
        raise NotImplementedError(f"no K3 kernel for {dev}")
    F, N = len(cols), cols[0].shape[0]
    if any(c.dtype != torch.float32 or c.dim() != 1 or c.shape[0] != N
           or c.device != dev for c in cols) or cell_starts.device != dev:
        raise ValueError("cols: need (N,) float32 columns on "
                         "cell_starts' device")
    lib = cuda_build.library()
    if not 1 <= K <= lib.ib_max_spread_slots():
        raise ValueError(f"K={K}: the K3 kernel takes 1 .. "
                         f"{lib.ib_max_spread_slots()} slots")
    if (cols.stride(1) != 1 if torch.is_tensor(cols)
            else any(c.stride() != (1,) for c in cols)):
        raise ValueError("cols: each column needs stride 1")
    if not torch.is_tensor(cols) and F > MAX_TABLE_COLS:
        raise ValueError(f"cols: {F} separate columns, the kernel's "
                         f"address table takes {MAX_TABLE_COLS}; pass an "
                         "(F, N) matrix")
    cs = cell_starts.to(torch.int32).contiguous()
    S = torch.empty(ncells, F, dtype=torch.float32, device=dev)
    if torch.is_tensor(cols):
        ptrs, base, stride = None, cols.data_ptr(), cols.stride(0)
    else:
        # the address table rides along so that it lives through the call
        ptrs = array.array("Q", [c.data_ptr() for c in cols])
        base, stride = None, 0
    cuda_build.check(lib.ib_segment_sums(
        ptrs.buffer_info()[0] if ptrs else None, base, stride,
        cs.data_ptr(), S.data_ptr(), ncells, F, K, int(tree),
        cuda_build.stream_ptr(dev)), "segment_sums")
    segment_sums.launches += 1
    return S


_VARIANTS = ("extra3", "extra14", "generic")


def _generic(variant) -> int:
    if variant not in (None, "generic"):
        raise ValueError(f"variant={variant!r}: need None or 'generic'")
    return int(variant == "generic")


def _payload(rows_s, n_extra: int):
    """The payload's rows as a list of (N,) tensors of one length, float
    type and device, from a (13 + n_extra, N) matrix or a sequence of
    rows: float32 for the kernel, float32 or float64 for the plain
    version (a CPU tensor)."""
    rows = list(rows_s)
    if len(rows) != R_NFIX + n_extra or any(
            r.dim() != 1 or r.dtype != rows[0].dtype
            or r.shape != rows[0].shape or r.device != rows[0].device
            for r in rows) or rows[0].dtype not in (
                (torch.float32, torch.float64)
                if rows[0].device.type == "cpu" else (torch.float32,)):
        raise ValueError(f"rows_s for n_extra={n_extra}: need "
                         f"{R_NFIX + n_extra} float32 rows (float64 on the "
                         "CPU) of one length on one device")
    return rows


def segment_spread_sums_count(rows_s, cell_starts, tbl, cfg: IcebergsConfig,
                              n_extra: int, *, cell_block: int = 128,
                              window: int = None, variant: str = None):
    """:func:`segment_spread_sums` that also returns the count of flagged
    blocks: ``(S, bad, nbad)``, ``nbad`` a 0-dim int32 tensor on the
    payload's device."""
    generic = _generic(variant)
    rows = _payload(rows_s, n_extra)
    N, dev = rows[0].shape[0], rows[0].device
    ncells = tbl.shape[1]
    K = cfg.reprod_max_per_cell
    if tbl.shape[0] != T_NROWS or cell_starts.shape != (ncells + 1,):
        raise ValueError(f"tbl {tuple(tbl.shape)}, cell_starts "
                         f"{tuple(cell_starts.shape)}")
    if not (dev == cell_starts.device == tbl.device):
        raise ValueError("rows_s, cell_starts and tbl on different devices")
    if dev.type == "cpu":
        bad = window_bad(cell_starts, ncells, N, cell_block, window)
        nbad = bad.sum(dtype=torch.int32)
        M = rows_s if torch.is_tensor(rows_s) else torch.stack(rows)
        return (segment_spread_sums_plain(M, cell_starts, tbl, cfg,
                                          tree=bool(nbad > 0)), bad, nbad)
    if dev.type != "cuda":
        raise NotImplementedError(f"no K3 kernel for {dev}")
    lib = cuda_build.library()
    if n_extra > lib.ib_max_spread_extra():
        raise ValueError(f"n_extra={n_extra} > "
                         f"{lib.ib_max_spread_extra()}")
    if not 1 <= K <= lib.ib_max_spread_slots():
        raise ValueError(f"reprod_max_per_cell={K}: the K3 kernel takes "
                         f"1 .. {lib.ib_max_spread_slots()} slots")
    if not all(r.stride() == (1,) for r in rows):
        raise ValueError("payload rows must have stride 1")
    if not (tbl.is_contiguous() and cell_starts.dtype == torch.int32):
        raise ValueError("tbl must be contiguous, cell_starts int32")
    S = torch.empty(ncells, N_SPREAD + N_CELLCOL + n_extra,
                    dtype=torch.float32, device=dev)
    bad = torch.empty(-(-ncells // cell_block), dtype=torch.bool, device=dev)
    nbad = torch.empty((), dtype=torch.int32, device=dev)
    # the payload rows after the key, by address (the array rides along
    # so that it lives through the call)
    ptrs = array.array("Q", [r.data_ptr() for r in rows[R_KEY + 1:]])
    cuda_build.check(lib.ib_segment_spread_sums(
        ptrs.buffer_info()[0], cell_starts.data_ptr(), tbl.data_ptr(),
        S.data_ptr(), bad.data_ptr(), nbad.data_ptr(), ncells, n_extra,
        cell_block, window_lanes(N, ncells, cell_block, window), K,
        int(cfg.use_old_spreading), generic,
        cuda_build.stream_ptr(dev)), "segment_spread_sums")
    segment_spread_sums.launches += 1
    return S, bad, nbad


def segment_spread_sums(rows_s, cell_starts, tbl, cfg: IcebergsConfig,
                        n_extra: int, *, cell_block: int = 128,
                        window: int = None, variant: str = None):
    """Per-cell sums of the 36 spread products, 7 cell columns and
    ``n_extra`` pass-through rows of the cell-sorted payload ``rows_s``
    ((13 + n_extra, N) float32, a matrix or a sequence of (N,) rows; row
    R_KEY the sorted cell key), in the JAX package's association: the
    slot tree when a block of ``cell_block`` cells overflows the TPU
    kernel's ``window``, else sequential.

    Returns ``(S (ncells, 43 + n_extra), bad (nblocks,) bool)``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``segment_spread_sums.launches``), the instantiation
    compiled for ``n_extra`` (3 or 14) or, with ``variant="generic"`` or
    another width, the generic one."""
    S, bad, _ = segment_spread_sums_count(
        rows_s, cell_starts, tbl, cfg, n_extra, cell_block=cell_block,
        window=window, variant=variant)
    return S, bad


segment_spread_sums.launches = 0
segment_sums.launches = 0


def kernel_config(n_extra: int, K: int, variant: str = None):
    """``(instantiation, dynamic shared memory bytes, resident CTAs per
    SM)`` of the K3 launch at these settings on the current CUDA device:
    ``"extra3"``, ``"extra14"`` or ``"generic"``."""
    v, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    cuda_build.check(cuda_build.library().ib_spread_config(
        n_extra, K, _generic(variant), ctypes.byref(v), ctypes.byref(smem),
        ctypes.byref(ctas)), "spread_config")
    return _VARIANTS[v.value], smem.value, ctas.value


def kernel_resources() -> dict:
    """Registers, stack frame and spill bytes of each K3 instantiation,
    from the library's ``-Xptxas -v`` report."""
    out = {}
    for name, r in cuda_build.resource_report().items():
        m = re.search(r"segment_spread_kernelILi(n?\d+)E", name)
        if m and "registers" in r:
            out[{"3": "extra3", "14": "extra14"}.get(m.group(1),
                                                      "generic")] = r
        elif "spread_window_flags" in name and "registers" in r:
            out["window_flags"] = r
    return out


def build_rows(st, grid, frc, cfg: IcebergsConfig, extra_cols,
               key_alive=None):
    """The payload stack's rows + sort keys (``build_rows``,
    ``pallas_spread.py:492-552``).  ``key_alive`` is the sort key's
    aliveness (pre-thermodynamics); value columns mask with the current
    ``st.alive``."""
    from .spread import berg_spread_mass, bits_areas

    nx = grid.nx
    alive = st.alive
    if key_alive is None:
        key_alive = alive
    key = torch.where(key_alive, st.jne * nx + st.ine,
                      grid.nx * grid.ny).to(torch.int32)
    af = alive.to(st.lon.dtype)
    L, W = st.length, st.width
    Area = L * W
    Mass = torch.where(alive, berg_spread_mass(st, grid, frc, cfg), 0.)
    LWms = Area * st.mass_scaling * af
    massms = st.mass * st.mass_scaling * af
    I, J = (st.ine + 1).long(), (st.jne + 1).long()
    area_c = grid.area[I, J].clamp(min=1e-30)
    Abits, Abits_fl, Abits_flb = bits_areas(st, cfg)
    virt = (W * L + Abits + Abits_fl + Abits_flb) * st.mass_scaling * af
    w_cell_grid = torch.where(alive, st.mass_scaling / area_c, 0.)
    bits = (st.mass_of_bits + st.mass_of_fl_bergy_bits) * w_cell_grid
    flb = st.mass_of_fl_bits * w_cell_grid
    flbb = st.mass_of_fl_bergy_bits * w_cell_grid
    rows = [key.to(st.lon.dtype), st.xi, st.yj, Area, Mass, LWms,
            st.uvel, st.vvel, massms, virt, bits, flb, flbb]
    return key, rows + list(extra_cols or [])


def spread_cell_sums(st, grid, frc, cfg: IcebergsConfig, extra_cols, *,
                     key_alive, cell_starts, tbl=None, cell_block: int = 128,
                     window: int = None):
    """End-to-end kernel path.  With ``cell_starts`` the state slab is
    already (cell, id) sorted for ``key_alive`` rows and K3 reads the row
    tensors where they lie; without, the payload rows are moved into the
    (cell, id_cnt, id_ij) order by K1 (the JAX package's one payload sort)
    and the cell starts come from the sorted keys.  ``tbl`` is the grid's
    :func:`cell_tables` (built here when not given).  Returns ``(S,
    nbad)``."""
    from .pack import from_bits, permute_cols_u32, to_bits
    from .sorted import lex_cell_id_order, starts_from_sorted_key

    key, rows = build_rows(st, grid, frc, cfg, extra_cols,
                           key_alive=key_alive)
    if cell_starts is None:
        # K1 writes the sorted rows from the row tensors (no stack)
        order = lex_cell_id_order(key, st.id_cnt, st.id_ij)
        rows = from_bits(permute_cols_u32([to_bits(r) for r in rows],
                                          order), rows[0].dtype)
        cell_starts = starts_from_sorted_key(key[order.long()],
                                             grid.nx * grid.ny)
    else:
        rows = [r.contiguous() for r in rows]
    S, _, nbad = segment_spread_sums_count(
        rows, cell_starts.to(torch.int32),
        cell_tables(grid) if tbl is None else tbl, cfg,
        len(extra_cols or []), cell_block=cell_block, window=window)
    return S, nbad

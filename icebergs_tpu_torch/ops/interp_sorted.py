"""K6: the sorted-frame field-to-berg interpolation.

Counterpart of ``icebergs_tpu/ops/pallas_interp.py``'s ``interp_sorted``
and ``interp_to_bergs_sorted`` (``pallas_interp.py:272-383, 499-542``),
the interface phase of ``interp_mode="kernel"`` on the persistent sorted
slab.  Each berg reads its cell's column of the (64, ncells) slot table
(:func:`.interp_table.interp_cell_table`) and runs the per-berg
bilinear / stencil arithmetic of :func:`.interp_table._env_rows_from_slots`
(13 Env rows and the two walk-anchor halves).  The plain version gathers
``tbl[:, key]`` and runs that function.

The TPU kernel selected each berg's column from a window of
``cell_window`` cells with a 0/1 matmul and flagged blocks whose cell
span overflowed the window; the JAX wrapper then re-did those rows
through the XLA interpolation under ``lax.cond``.  The CUDA kernel reads
each berg's column by index, so it is exact on every row and needs no
fallback (which would cost a host sync to decide).
:func:`window_bad_rows` computes the TPU wrapper's bad rows
(``pallas_interp.py:318-321``) for a caller who wants to see which rows
the TPU kernel would have sent to the fallback; the step does not.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from ..config import IcebergsConfig
from ..grid import Grid
from .interp_table import S_NROWS, _env_rows_from_slots, interp_cell_table

E_NROWS = 15          # 13 Env rows + the two walk-anchor halves


def window_bad_rows(key_s, ncells: int, block_n: int, cell_window: int):
    """The TPU kernel's bad rows: blocks of ``block_n`` sorted rows whose
    cell span exceeds the 128-aligned window (``pallas_interp.py:298,
    318-321``)."""
    N = key_s.shape[0]
    CL = -(-(cell_window + 128) // 128) * 128
    nblocks = -(-N // block_n)
    key = torch.cat([key_s.to(torch.int32),
                     key_s.new_full((nblocks * block_n - N,), ncells,
                                    dtype=torch.int32)])
    c0 = key[::block_n]
    c1 = key[block_n - 1::block_n].clamp(max=ncells - 1)
    w0 = torch.div(c0.clamp(max=ncells - 1), 128,
                   rounding_mode="floor") * 128
    bad = (c1 - w0 + 1) > CL
    # expand, not repeat_interleave: the latter reads its size on the host
    return bad[:, None].expand(-1, block_n).reshape(-1)[:N]


def interp_sorted_plain(tbl, key_s, xi, yj, cfg: IcebergsConfig):
    """Plain version: the (15, N) rows from ``tbl[:, key]`` (dead rows,
    key = ncells, read a zero column)."""
    tbl_pad = torch.cat([tbl, tbl.new_zeros(tbl.shape[0], 1)], dim=1)
    rows = tbl_pad[:, key_s.long()]
    return torch.stack(_env_rows_from_slots(lambda s: rows[s], xi, yj, cfg))


def interp_sorted(tbl, key_s, xi, yj, grid: Grid, cfg: IcebergsConfig):
    """Env rows of every berg, (15, N) float32.  ``tbl`` (64, ncells)
    from :func:`interp_cell_table`,
    ``key_s`` (N,) cell keys (dead rows = ncells), ``xi``/``yj`` (N,).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``interp_sorted.launches``)."""
    ncells = grid.nx * grid.ny
    N = key_s.shape[0]
    if tbl.shape != (S_NROWS, ncells) or tbl.dtype != torch.float32:
        raise ValueError(f"tbl {tuple(tbl.shape)} {tbl.dtype}: need "
                         f"({S_NROWS}, {ncells}) float32")
    if xi.shape != (N,) or yj.shape != (N,):
        raise ValueError("xi and yj must be (N,) like key_s")
    if tbl.device.type == "cpu":
        return interp_sorted_plain(tbl, key_s, xi, yj, cfg)
    if tbl.device.type != "cuda":
        raise NotImplementedError(f"no K6 kernel for {tbl.device}")
    if (key_s.dtype != torch.int32 or xi.dtype != torch.float32
            or yj.dtype != torch.float32):
        raise ValueError("key_s must be int32, xi and yj float32")
    tbl, key_s, xi, yj = (t.contiguous() for t in (tbl, key_s, xi, yj))
    out = torch.empty(E_NROWS, N, dtype=torch.float32, device=tbl.device)
    lib = cuda_build.library()
    cuda_build.check(lib.ib_interp_sorted(
        tbl.data_ptr(), ncells, key_s.data_ptr(), xi.data_ptr(),
        yj.data_ptr(), N, int(cfg.old_bug_bilin), out.data_ptr(),
        cuda_build.stream_ptr(tbl.device)), "interp_sorted")
    interp_sorted.launches += 1
    return out


interp_sorted.launches = 0


def interp_to_bergs_sorted(st, grid: Grid, frc, cfg: IcebergsConfig):
    """Cache the interpolated environment on every berg of the persistent
    sorted slab through K6.  Returns ``(state_with_env, m25_pre)``: the
    walk's packed 5x5 land-mask anchor, (N,) int32 (the walk then reads
    its 9x9 rows from the grid)."""
    if cfg.coastal_drift != 0. or cfg.tidal_drift != 0.:
        raise ValueError("the kernel interpolation serves steps without "
                         "coastal or tidal drift, as in the JAX package")
    if cfg.mts:
        raise ValueError("the kernel interpolation serves non-MTS steps "
                         "only, as in the JAX package")
    if not cfg.grid_is_regular:
        raise ValueError("the kernel interpolation serves regular grids "
                         "only, as in the JAX package (model.py:473-476)")
    ncells = grid.nx * grid.ny
    key_s = torch.where(st.alive, st.jne * grid.nx + st.ine,
                        ncells).to(torch.int32)
    tbl = interp_cell_table(grid, frc, cfg)
    rows = interp_sorted(tbl, key_s, st.xi, st.yj, grid, cfg)
    # lo + hi * 8192 reaches 2^25, beyond float32's exact integers
    m25_pre = rows[13].to(torch.int32) + rows[14].to(torch.int32) * 8192
    st = st.replace(uo=rows[0], vo=rows[1], ui=rows[2], vi=rows[3],
                    ua=rows[4], va=rows[5], ssh_x=rows[6], ssh_y=rows[7],
                    sst=rows[8], sss=rows[9], cn=rows[10], hi=rows[11],
                    od=rows[12])
    return st, m25_pre

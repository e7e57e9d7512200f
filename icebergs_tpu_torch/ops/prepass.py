"""K5: the contact prepass search over the cell-sorted slab.

Counterpart of ``icebergs_tpu/ops/pallas_prepass.py``'s ``_pack`` and
``contact_prepass_sorted`` (``pallas_prepass.py:55-243``): K2's search
without the partner-feature extraction.  Per sorted slot it returns the
engaged-candidate count, the smallest and largest engaged partner slot
(-1 when none) and the bad-block flag.  The layout at this function is
the JAX one: ``P`` (N, 8) float32 rows of lon_old, lat_old, interaction
radius, fl_k, alive, cell key, group id and 0.

The TPU kernel reads, for each of a block's 2r+1 strips, a window of
``window`` rows starting at the strip's first slot rounded down to a
multiple of 8, and keeps the candidates whose key lies in the strip's
cell range.  Since the slab is sorted by key (rows that died since the
sort carry the dead key and fail the alive test), that candidate set is
the slot range ``[cell_starts[c_lo], min(cell_starts[c_hi + 1],
8 * (cell_starts[c_lo] // 8) + window, N))`` with the key test, which is
what both versions here scan.  So the counts of bad blocks, whose window
is truncated, are the TPU kernel's too.  The bad flags (a block's cell
span wider than ``nx - (2r+1)``, or a strip that overflows its 8-aligned
window; not K2's 128-aligned rule) follow the TPU wrapper's rule
(``pallas_prepass.py:116-131``), so the fallback set and ``n_fallback``
stay the reference's: :func:`block_tables` and :func:`strip_ranges`
compute the tables in torch for the plain version (and the tests); the
CUDA kernel (``csrc/prepass_sorted.cu``) builds them per block itself.
It has an instantiation compiled for the `fused` paths' shape (BN 128,
radius 1, no group) and a generic one (:func:`kernel_config`), each in a
Cartesian and a lat-lon form (``*_ll``): on a lat-lon grid a pair is
measured in metres through the metric factors at its mean latitude, as
the TPU kernel does (``pallas_prepass.py:196-200``).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from .. import cuda_build
from . import forces as _forces
from ..grid import pair_separation
from .extract import metric_scalars, strip_cells

# packed feature columns (pallas_prepass.py:50, group id in column 6)
F_LON, F_LAT, F_RAD, F_FLK, F_ALIVE, F_KEY, F_GRP = range(7)
NFEAT = 8
_SLACK = float(np.float32(1. + 1e-6))


def prepass_features(st, grid, cfg, exclude_same_group: bool = False):
    """K5's inputs in the frame of ``st`` (``_pack``): the (N, 8) feature
    rows and the cell keys (dead rows = ncells); ``exclude_same_group``
    puts the conglomerate id in column 6."""
    ncells = grid.nx * grid.ny
    dtype = st.lon.dtype
    key = torch.where(st.alive, st.jne * grid.nx + st.ine,
                      ncells).to(torch.int32)
    A = st.length * st.width
    alive = st.alive.to(dtype)
    zero = torch.zeros_like(alive)
    grp = st.conglom_id.to(dtype) if exclude_same_group else zero
    P = torch.stack([st.lon_old, st.lat_old,
                     _forces._interaction_radius(cfg, A), st.fl_k, alive,
                     key.to(dtype), grp, zero], dim=-1)
    return P, key


def block_tables(key_s, cell_starts, nx: int, ny: int, block_n: int,
                 window: int, radius: int = 1):
    """Per block of ``block_n`` sorted rows: the strip cell ranges
    ``(c_lo, c_hi)`` (nblocks, 2r+1) int32 and the bad flag (nblocks,),
    as ``pallas_prepass.py:116-131`` computes them."""
    c_lo, c_hi, span_bad = strip_cells(key_s, nx, ny, block_n, radius)
    cs = cell_starts.long()
    ws8 = cs[c_lo.long()] // 8
    win_need = cs[(c_hi + 1).long()] - ws8 * 8
    return c_lo, c_hi, span_bad | (win_need > window).any(dim=1)


def strip_ranges(cell_starts, c_lo, c_hi, window: int, N: int):
    """The slot range ``[start, end)`` each strip scans (nblocks, 2r+1)."""
    cs = cell_starts.long()
    start = cs[c_lo.long()]
    end = torch.minimum(cs[(c_hi + 1).long()],
                        (start // 8) * 8 + window).clamp(max=N)
    return start, end


def prepass_sorted_plain(P, cell_starts, c_lo, c_hi, block_n: int,
                         window: int, contact_distance: float,
                         exclude_same_group: bool = False,
                         chunk_rows: int = 65536, rearth=None):
    """Plain version: each row's candidates as a (rows, 2r+1, W) slab of
    strip slots ``start + k`` (W = the longest strip range), engagement
    elementwise, count / min / max reductions.  Processed in row chunks.
    ``rearth``: the Earth's radius on a lat-lon grid (None: Cartesian).
    Returns ``(cnt, pmin, pmax)`` int32."""
    N = P.shape[0]
    dev = P.device
    big = 2 * N
    start, end = strip_ranges(cell_starts, c_lo, c_hi, window, N)
    length = (end - start).clamp(min=0)
    W = max(int(length.max()) if length.numel() else 0, 1)
    k = torch.arange(W, device=dev)
    cnt = torch.zeros(N, dtype=torch.int32, device=dev)
    pmin = torch.full((N,), -1, dtype=torch.int32, device=dev)
    pmax = torch.full((N,), -1, dtype=torch.int32, device=dev)
    for r0 in range(0, N, chunk_rows):
        rows = torch.arange(r0, min(N, r0 + chunk_rows), device=dev)
        blk = rows // block_n
        cand = start[blk][:, :, None] + k                # (n, ns, W)
        inrange = k < length[blk][:, :, None]
        ci = cand.clamp(0, max(N - 1, 0))
        clo = c_lo[blk].to(P.dtype)[:, :, None]
        chi = c_hi[blk].to(P.dtype)[:, :, None]

        def own(c):
            return P[rows, c][:, None, None]

        def cnd(c):
            return P[:, c][ci]

        valid = (inrange & (cnd(F_KEY) >= clo) & (cnd(F_KEY) <= chi)
                 & (cnd(F_ALIVE) > 0.5) & (own(F_ALIVE) > 0.5)
                 & (cand != rows[:, None, None])
                 & (own(F_FLK) != -1.) & (cnd(F_FLK) != -1.))
        if exclude_same_group:
            valid = valid & (cnd(F_GRP) != own(F_GRP))
        rx, ry = pair_separation(own(F_LON), own(F_LAT), cnd(F_LON),
                                 cnd(F_LAT), rearth is not None, rearth)
        r2 = rx * rx + ry * ry
        crit = (own(F_RAD) + cnd(F_RAD)).clamp(min=contact_distance)
        engaged = valid & (r2 > 0.) & (r2 <= crit * crit * _SLACK)
        vmin = torch.where(engaged, cand, big).amin(dim=(1, 2))
        cnt[rows] = engaged.sum(dim=(1, 2)).to(torch.int32)
        pmin[rows] = torch.where(vmin >= big, -1, vmin).to(torch.int32)
        pmax[rows] = torch.where(engaged, cand, -1).amax(
            dim=(1, 2)).to(torch.int32)
    return cnt, pmin, pmax


_VARIANTS = ("fused", "generic", "generic_group")
_VARIANTS = _VARIANTS + tuple(v + "_ll" for v in _VARIANTS)


def _generic(variant) -> int:
    if variant not in (None, "generic"):
        raise ValueError(f"variant={variant!r}: need None or 'generic'")
    return int(variant == "generic")


def kernel_config(block_n: int, radius: int, exclude_same_group: bool,
                  variant: str = None, latlon: bool = False):
    """``(instantiation, dynamic shared memory bytes, resident CTAs per
    SM)`` of the K5 launch at these settings on the current CUDA device:
    ``"fused"`` (BN 128, radius 1, no group) or a generic one (also where
    ``variant == "generic"``), with ``"_ll"`` on a lat-lon grid."""
    v, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    cuda_build.check(cuda_build.library().ib_prepass_config(
        block_n, 2 * radius + 1, int(exclude_same_group), _generic(variant),
        int(latlon), ctypes.byref(v), ctypes.byref(smem),
        ctypes.byref(ctas)), "prepass_config")
    return _VARIANTS[v.value], smem.value, ctas.value


def kernel_resources() -> dict:
    """Registers, stack frame and spill bytes of each K5 instantiation,
    from the library's ``-Xptxas -v`` report."""
    out = {}
    for name, r in cuda_build.resource_report().items():
        m = re.search(r"prepass_sorted_kernelILi(\d+)ELi(\d+)ELb([01])ELi"
                      r"\d+ELb([01])E", name)
        if m and "registers" in r:
            bn, ns, g, ll = m.groups()
            key = ("fused" if (bn, ns) == ("128", "3")
                   else "generic_group" if g == "1" else "generic")
            out[key + ("_ll" if ll == "1" else "")] = r
    return out


def contact_prepass_sorted(P, key_s, cell_starts, grid, cfg, *,
                           block_n: int = 256, window: int = 512,
                           radius: int = 1,
                           exclude_same_group: bool = False,
                           variant: str = None):
    """Engaged-contact search on the cell-sorted frame.  Returns
    ``(cnt, pmin, pmax, bad_block)``: (N,) int32 counts and smallest /
    largest engaged partner slots (-1 = none), and (N,) bool.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``contact_prepass_sorted.launches``), which builds
    the block tables itself; ``variant="generic"`` forces its generic
    instantiation (:func:`kernel_config`)."""
    generic = _generic(variant)
    rearth = float(cfg.Rearth) if cfg.grid_is_latlon else None
    if P.dim() != 2 or P.shape[1] != NFEAT or P.dtype != torch.float32:
        raise ValueError(f"P {tuple(P.shape)} {P.dtype}: need (N, "
                         f"{NFEAT}) float32")
    N = P.shape[0]
    ncells = grid.nx * grid.ny
    if key_s.shape != (N,) or cell_starts.shape != (ncells + 1,):
        raise ValueError(f"key_s {tuple(key_s.shape)}, cell_starts "
                         f"{tuple(cell_starts.shape)}")
    if not (P.device == key_s.device == cell_starts.device):
        raise ValueError("P, key_s and cell_starts on different devices")
    cd = float(cfg.contact_distance)
    if P.device.type == "cpu":
        c_lo, c_hi, bad = block_tables(key_s, cell_starts, grid.nx, grid.ny,
                                       block_n, window, radius)
        # expand, not repeat_interleave: the latter reads its size on the
        # host
        bad_block = bad[:, None].expand(-1, block_n).reshape(-1)[:N]
        return (*prepass_sorted_plain(P, cell_starts, c_lo, c_hi, block_n,
                                      window, cd, exclude_same_group,
                                      rearth=rearth),
                bad_block)
    if P.device.type != "cuda":
        raise NotImplementedError(f"no K5 kernel for {P.device}")
    if not 32 <= block_n <= 1024 or block_n % 32 or not 0 <= radius <= 4:
        raise ValueError(f"block_n={block_n}, radius={radius}: need a "
                         f"multiple of 32 in [32, 1024] and a radius <= 4")
    if (not P.is_contiguous() or P.data_ptr() % 16
            or key_s.dtype != torch.int32
            or cell_starts.dtype != torch.int32):
        raise ValueError("P must be contiguous and 16-byte aligned, key_s "
                         "and cell_starts int32")
    cnt = torch.empty(N, dtype=torch.int32, device=P.device)
    pmin = torch.empty_like(cnt)
    pmax = torch.empty_like(cnt)
    bad_block = torch.empty(N, dtype=torch.bool, device=P.device)
    lib = cuda_build.library()
    cuda_build.check(lib.ib_prepass_sorted(
        P.data_ptr(), N, key_s.data_ptr(), cell_starts.data_ptr(), grid.nx,
        ncells, block_n, 2 * radius + 1, window, int(exclude_same_group),
        generic, int(rearth is not None), cd, _SLACK,
        *metric_scalars(rearth), cnt.data_ptr(), pmin.data_ptr(),
        pmax.data_ptr(), bad_block.data_ptr(),
        cuda_build.stream_ptr(P.device)), "contact_prepass_sorted")
    contact_prepass_sorted.launches += 1
    return cnt, pmin, pmax, bad_block


contact_prepass_sorted.launches = 0

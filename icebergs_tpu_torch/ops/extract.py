"""K2: contact search + partner-feature extraction over the sorted slab.

Counterpart of ``icebergs_tpu/ops/pallas_prepass.py::contact_extract_sorted_g``
(``pallas_prepass.py:625-854``) and its bitwise twins.  The layout at this
function is the JAX one: ``PT`` (16, N) feature rows (``PT_*``), output
(24, N) rows (``EX_*``) and a per-row bad-block flag.

The bad flags (a block's cell span wider than ``nx - (2r+1)``, or a strip
that would not fit the TPU kernel's 128-aligned window) follow the TPU
wrapper's rule (``pallas_prepass.py:663-675``), so the set of bergs sent
to the exact fallback — and ``n_fallback`` — stay the reference's:
:func:`block_tables` computes the strip tables and flags in torch for the
plain version (and the tests); the CUDA kernel builds them per block
itself from the block's first and last key, so a call on the card is one
launch.  Rows of bad blocks carry the "no partner" result (count 0, min
slot 2N, max slot -1, zero features); the caller discards them as the JAX
package does.

``exclude_same_group`` (the MTS Part-1 collision group) also drops
candidates whose ``PT_GRP`` row (the conglomerate id) equals the berg's
own (``pallas_prepass.py:709-710, 743-744``).

On a lat-lon grid the distance test measures each pair in metres
through the metric factors at its mean latitude, as the TPU kernel does
(``pallas_prepass.py:746-750``; :func:`..grid.pair_separation`).

``epilogue=True`` (``contact_epilogue``, ``pallas_prepass.py:776-830``)
also runs the legacy contact group's velocity-independent pair
precompute: the spring-acceleration sums over every exact pair (r <
crit) of every strip in rows ``EX_IAX`` / ``EX_IAY``, and per selected
partner ``EX_EPI_NP`` rows from ``EX_F1`` / ``EX_F2``: u, v, P11, P12,
P22, the mass ratio min(M1, M2) / M1 and the exactness flag.  The sums
run in candidate order; rows with at most two exact pairs have the same
bits in any order (the others are bad rows that the caller masks).

The kernel (``csrc/extract_sorted.cu``) has instantiations compiled for
the two shapes the paths launch (:func:`kernel_config`): BN 128, radius 1
(the fast lane and per-step ``fused3``) and BN 256, radius 2 with the
conglomerate filter (MTS Part 1); other shapes take a generic one, and
``variant="generic"`` forces it onto those two (to time the
specialisation).  Each instantiation has a Cartesian and a lat-lon
form (``*_ll``).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from .. import constants as C
from .. import cuda_build
from ..grid import pair_separation

# PT feature rows (pallas_prepass.py:258-261)
PT_LON, PT_LAT, PT_U, PT_V, PT_AREA, PT_MASS = range(6)
PT_RAD, PT_ALIVE, PT_KEY, PT_GRP, PT_FLK = 8, 9, 10, 11, 12
PT_NF = 16
PT_NEVAL = 6
# output rows (pallas_prepass.py:264-267)
EX_CNT, EX_VMIN, EX_VMAX = 0, 1, 2
EX_F1 = 4
EX_F2 = 12
EX_NOUT = 24
# epilogue rows (pallas_prepass.py:268-273)
EX_IAX, EX_IAY = 3, 20
EX_EPI_NP = 7
_NFEAT = 8                    # PT rows 0..7 copied per partner
_SLACK = float(np.float32(1. + 1e-6))


def window_lanes(window: int) -> int:
    """The TPU kernel's window width WL (128-aligned, with 128 slop)."""
    return -(-(window + 128) // 128) * 128


def strip_cells(key_s, nx: int, ny: int, block_n: int, radius: int = 1):
    """Per block of ``block_n`` sorted rows (the tail padded with dead
    keys): the inclusive strip cell ranges ``(c_lo, c_hi)`` (nblocks,
    2r+1) over grid rows j-r .. j+r of the block's cell span, and the
    span flag (a span wider than ``nx - (2r+1)``), as both TPU search
    wrappers compute them."""
    N = key_s.shape[0]
    ncells = nx * ny
    nstrips = 2 * radius + 1
    nblocks = -(-N // block_n)
    key = torch.cat([key_s.to(torch.int32),
                     key_s.new_full((nblocks * block_n - N,), ncells,
                                    dtype=torch.int32)])
    c0 = key[::block_n]
    c1c = key[block_n - 1::block_n].clamp(max=ncells - 1)
    span_bad = (c1c - c0) > (nx - nstrips)
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32,
                        device=key.device) * nx
    c_lo = (c0[:, None] - radius + offs[None, :]).clamp(0, ncells - 1)
    c_hi = (c1c[:, None] + radius + offs[None, :]).clamp(-1, ncells - 1)
    return c_lo.contiguous(), c_hi.contiguous(), span_bad


def block_tables(key_s, cell_starts, nx: int, ny: int, block_n: int,
                 window: int, radius: int = 1):
    """Per block of ``block_n`` sorted rows: the strip cell ranges
    ``(c_lo, c_hi)`` (nblocks, 2r+1) int32 and the bad flag (nblocks,)."""
    c_lo, c_hi, span_bad = strip_cells(key_s, nx, ny, block_n, radius)
    cs = cell_starts.long()
    ws128 = cs[c_lo.long()] // 128
    win_need = cs[(c_hi + 1).long()] - ws128 * 128
    win_bad = (win_need > window_lanes(window)).any(dim=1)
    return c_lo, c_hi, span_bad | win_bad


def extract_sorted_plain(PT, cell_starts, c_lo, c_hi, bad, block_n: int,
                         contact_distance: float, chunk_rows: int = 65536,
                         exclude_same_group: bool = False,
                         epilogue: bool = False, spring: float = 0.,
                         exact_counts: bool = False, rearth=None):
    """Plain version: each row's candidates as a (rows, 2r+1, W) slab of
    strip slots ``cell_starts[c_lo] + k`` (W = the longest strip of a
    good block), engagement elementwise, count / min / max reductions,
    features gathered by slot (with ``epilogue``, the spring sums masked
    by exactness and summed over the slab, and the selected partners'
    rows recomputed from their slots).  Processed in row chunks.
    ``exact_counts`` (with ``epilogue``) also returns each row's number
    of exact pairs, (N,) int32.  ``rearth``: the Earth's radius on a
    lat-lon grid (None: Cartesian)."""
    N = PT.shape[1]
    dev = PT.device
    nstrips = c_lo.shape[1]
    big = 2 * N
    cs = cell_starts.long()
    start = cs[c_lo.long()]                             # (nb, ns)
    length = (cs[(c_hi + 1).long()] - start).clamp(min=0)
    length = torch.where(bad[:, None], 0, length)
    W = max(int(length.max()) if length.numel() else 0, 1)
    k = torch.arange(W, device=dev)
    out = torch.zeros(EX_NOUT, N, dtype=PT.dtype, device=dev)
    nexact = torch.zeros(N, dtype=torch.int32, device=dev)
    for r0 in range(0, N, chunk_rows):
        rows = torch.arange(r0, min(N, r0 + chunk_rows), device=dev)
        blk = rows // block_n
        cand = start[blk][:, :, None] + k                # (n, ns, W)
        inrange = k < length[blk][:, :, None]
        ci = cand.clamp(0, N - 1)
        clo = c_lo[blk].to(PT.dtype)[:, :, None]
        chi = c_hi[blk].to(PT.dtype)[:, :, None]

        def own(r):
            return PT[r, rows][:, None, None]

        def cnd(r):
            return PT[r][ci]

        valid = (inrange & (cnd(PT_KEY) >= clo) & (cnd(PT_KEY) <= chi)
                 & (cnd(PT_ALIVE) > 0.5) & (own(PT_ALIVE) > 0.5)
                 & (cand != rows[:, None, None])
                 & (own(PT_FLK) != -1.) & (cnd(PT_FLK) != -1.))
        if exclude_same_group:
            valid = valid & (cnd(PT_GRP) != own(PT_GRP))
        rx, ry = pair_separation(own(PT_LON), own(PT_LAT), cnd(PT_LON),
                                 cnd(PT_LAT), rearth is not None, rearth)
        r2 = rx * rx + ry * ry
        crit = (own(PT_RAD) + cnd(PT_RAD)).clamp(min=contact_distance)
        engaged = valid & (r2 > 0.) & (r2 <= crit * crit * _SLACK)
        cnt = engaged.sum(dim=(1, 2))
        vmin = torch.where(engaged, cand, big).amin(dim=(1, 2))
        vmax = torch.where(engaged, cand, -1).amax(dim=(1, 2))
        out[EX_CNT, rows] = cnt.to(PT.dtype)
        out[EX_VMIN, rows] = vmin.to(PT.dtype)
        out[EX_VMAX, rows] = vmax.to(PT.dtype)
        has = (cnt > 0)[None, :]
        if epilogue:
            r = torch.sqrt(r2)
            rsafe = torch.where(r2 > 0., r, 1.)
            exact = valid & (r2 > 0.) & (r < crit)
            nexact[rows] = exact.sum(dim=(1, 2), dtype=torch.int32)
            M1 = own(PT_MASS).clamp(min=1e-30)
            aspr = spring * (torch.minimum(M1, cnd(PT_MASS)) / M1) \
                * (crit - r)
            out[EX_IAX, rows] = torch.where(exact, aspr * (rx / rsafe),
                                            0.).sum(dim=(1, 2))
            out[EX_IAY, rows] = torch.where(exact, aspr * (ry / rsafe),
                                            0.).sum(dim=(1, 2))
            for base, q in ((EX_F1, vmin.clamp(max=N - 1)),
                            (EX_F2, vmax.clamp(min=0))):
                d = _partner_rows(PT, rows, q, contact_distance, rearth)
                out[base:base + EX_EPI_NP, rows] = torch.where(has, d, 0.)
            continue
        out[EX_F1:EX_F1 + _NFEAT, rows] = torch.where(
            has, PT[:_NFEAT][:, vmin.clamp(max=N - 1)], 0.)
        out[EX_F2:EX_F2 + _NFEAT, rows] = torch.where(
            has, PT[:_NFEAT][:, vmax.clamp(min=0)], 0.)
    return (out, nexact) if exact_counts else out


def _partner_rows(PT, rows, q, contact_distance: float, rearth=None):
    """(7, n) epilogue rows of the partners in slots ``q``: u, v, P11,
    P12, P22, min(M1, M2) / M1, exactness (an engaged partner has r2 >
    0, so rsafe = r)."""
    rx, ry = pair_separation(PT[PT_LON, rows], PT[PT_LAT, rows],
                             PT[PT_LON, q], PT[PT_LAT, q],
                             rearth is not None, rearth)
    r2 = rx * rx + ry * ry
    crit = (PT[PT_RAD, rows] + PT[PT_RAD, q]).clamp(min=contact_distance)
    r = torch.sqrt(r2)
    rs2 = r * r
    M1 = PT[PT_MASS, rows].clamp(min=1e-30)
    return torch.stack([PT[PT_U, q], PT[PT_V, q], (rx * rx) / rs2,
                        (rx * ry) / rs2, (ry * ry) / rs2,
                        torch.minimum(M1, PT[PT_MASS, q]) / M1,
                        (r < crit).to(PT.dtype)])


_VARIANTS = ("fused3", "part1", "generic", "generic_group", "fused3_epi",
             "generic_epi")
_VARIANTS = _VARIANTS + tuple(v + "_ll" for v in _VARIANTS)


def metric_scalars(rearth):
    """``(kpr, pi180)`` for the kernels' lat-lon metric
    (``csrc/latlon.cuh``): ``PI_180 * Rearth`` folded in double and
    ``PI_180``, each rounded once to float32 where ctypes passes it
    (zeros on a Cartesian grid)."""
    if rearth is None:
        return 0., 0.
    return C.PI_180 * rearth, C.PI_180


def latlon_kx(L_w, L_c, rearth: float):
    """``metric_kx(box_cos(..), box_cos(..))`` of ``csrc/latlon.cuh`` on
    float32 tensors, from the largest |latitude| of the warp's box
    (``L_w``) and of the chunk's (``L_c``): a lower bound of the metric's
    x factor ``kpr * cos(pi180 * lat_ref)`` over every pair whose mean
    latitude has ``|lat_ref| <= max(L_w, L_c)``.  ``torch.fmin`` and
    ``torch.fmax`` skip a NaN as ``fminf`` and ``fmaxf`` do."""
    kpr, pi180 = (torch.tensor(v, dtype=torch.float32, device=L_w.device)
                  for v in metric_scalars(rearth))
    c = torch.fmin(torch.cos(pi180 * L_w), torch.cos(pi180 * L_c))
    return kpr * torch.fmax(c * (1. - 2. ** -16), torch.zeros_like(c))


def gap2_metric(gx, gy, kx, rearth: float):
    """``gap2_metric`` of ``csrc/latlon.cuh`` on float32 tensors: the
    lower bound of r2 over the pairs whose longitude and latitude gaps are
    at least ``gx`` and ``gy``, with ``kx`` from :func:`latlon_kx`.  K2's
    chunk skip and its per-candidate skip drop a pair only where this
    exceeds ``cb * cb * slack``."""
    kpr = torch.tensor(metric_scalars(rearth)[0], dtype=torch.float32,
                       device=gx.device)
    gxm = torch.where(kx > 0., gx * kx, 0.)
    gym = gy * kpr
    return gxm * gxm + gym * gym


def _generic(variant) -> int:
    if variant not in (None, "generic"):
        raise ValueError(f"variant={variant!r}: need None or 'generic'")
    return int(variant == "generic")


def kernel_config(block_n: int, radius: int, exclude_same_group: bool,
                  variant: str = None, epilogue: bool = False,
                  latlon: bool = False):
    """``(instantiation, dynamic shared memory bytes, resident CTAs per
    SM)`` of the K2 launch at these settings on the current CUDA device:
    ``"fused3"`` (BN 128, radius 1), ``"part1"`` (BN 256, radius 2, the
    conglomerate filter), ``"fused3_epi"`` (BN 128, radius 1, the pair
    epilogue) or a generic one (also where ``variant == "generic"``),
    with ``"_ll"`` on a lat-lon grid."""
    v, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    cuda_build.check(cuda_build.library().ib_extract_config(
        block_n, 2 * radius + 1, int(exclude_same_group), _generic(variant),
        int(epilogue), int(latlon), ctypes.byref(v), ctypes.byref(smem),
        ctypes.byref(ctas)), "extract_config")
    return _VARIANTS[v.value], smem.value, ctas.value


def kernel_resources() -> dict:
    """Registers, stack frame and spill bytes of each K2 instantiation,
    from the library's ``-Xptxas -v`` report."""
    out = {}
    for name, r in cuda_build.resource_report().items():
        m = re.search(r"extract_sorted_kernelILi(\d+)ELi(\d+)ELb([01])ELi"
                      r"\d+ELb([01])ELb([01])E", name)
        if m and "registers" in r:
            bn, ns, g, e, ll = m.groups()
            key = ({("128", "3", "0"): "fused3",
                    ("256", "5", "1"): "part1"}.get((bn, ns, g))
                   or ("generic_group" if g == "1" else "generic"))
            if e == "1":
                key = "fused3_epi" if key == "fused3" else "generic_epi"
            out[key + ("_ll" if ll == "1" else "")] = r
    return out


def extract_sorted(PT, key_s, cell_starts, grid, cfg, *, block_n: int = 128,
                   window: int = 160, radius: int = 1,
                   exclude_same_group: bool = False, variant: str = None,
                   epilogue: bool = False):
    """Contact search + extraction.  Returns ``(out (24, N) f32,
    bad_block (N,) bool)``.  ``variant="generic"`` launches the generic
    instantiation whatever the shape (:func:`kernel_config`);
    ``epilogue`` runs the pair epilogue with the config's contact spring
    (not with ``exclude_same_group``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``extract_sorted.launches``), which builds the
    block tables itself."""
    generic = _generic(variant)
    if PT.dim() != 2 or PT.shape[0] != PT_NF or PT.dtype != torch.float32:
        raise ValueError(f"PT {tuple(PT.shape)} {PT.dtype}: need "
                         f"({PT_NF}, N) float32")
    N = PT.shape[1]
    ncells = grid.nx * grid.ny
    if key_s.shape != (N,) or cell_starts.shape != (ncells + 1,):
        raise ValueError(f"key_s {tuple(key_s.shape)}, cell_starts "
                         f"{tuple(cell_starts.shape)}")
    if not (PT.device == key_s.device == cell_starts.device):
        raise ValueError("PT, key_s and cell_starts on different devices")
    cd = float(cfg.contact_distance)
    if epilogue and exclude_same_group:
        raise ValueError("the pair epilogue serves the legacy contact "
                         "group only (no exclude_same_group)")
    spring = float(cfg.contact_spring_coef_eff) if epilogue else 0.
    rearth = float(cfg.Rearth) if cfg.grid_is_latlon else None
    if PT.device.type == "cpu":
        c_lo, c_hi, bad = block_tables(key_s, cell_starts, grid.nx, grid.ny,
                                       block_n, window, radius)
        # expand, not repeat_interleave: the latter reads its size on the
        # host
        bad_block = bad[:, None].expand(-1, block_n).reshape(-1)[:N]
        return (extract_sorted_plain(PT, cell_starts, c_lo, c_hi, bad,
                                     block_n, cd,
                                     exclude_same_group=exclude_same_group,
                                     epilogue=epilogue, spring=spring,
                                     rearth=rearth),
                bad_block)
    if PT.device.type != "cuda":
        raise NotImplementedError(f"no K2 kernel for {PT.device}")
    if not 32 <= block_n <= 1024 or block_n % 32 or not 0 <= radius <= 4:
        raise ValueError(f"block_n={block_n}, radius={radius}: need a "
                         f"multiple of 32 in [32, 1024] and a radius <= 4")
    if (not PT.is_contiguous() or key_s.dtype != torch.int32
            or cell_starts.dtype != torch.int32):
        raise ValueError("PT must be contiguous, key_s and cell_starts "
                         "int32")
    out = torch.empty(EX_NOUT, N, dtype=torch.float32, device=PT.device)
    bad_block = torch.empty(N, dtype=torch.bool, device=PT.device)
    lib = cuda_build.library()
    cuda_build.check(lib.ib_extract_sorted(
        PT.data_ptr(), N, key_s.data_ptr(), cell_starts.data_ptr(), grid.nx,
        ncells, window_lanes(window), out.data_ptr(), bad_block.data_ptr(),
        block_n, 2 * radius + 1, int(exclude_same_group), generic,
        int(epilogue), int(rearth is not None), cd, _SLACK, spring,
        *metric_scalars(rearth), cuda_build.stream_ptr(PT.device)),
        "extract_sorted")
    if epilogue:
        extract_sorted.epilogue_launches += 1
    else:
        extract_sorted.launches += 1
    return out, bad_block


extract_sorted.launches = 0            # the search alone
extract_sorted.epilogue_launches = 0   # with the pair epilogue

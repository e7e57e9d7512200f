"""K7: the velocity-dependent pair evaluation over (N, M) pair slabs.

Counterpart of ``icebergs_tpu/ops/pallas_pairs.py`` (``_pallas_eval``,
``eval_pair_ia_pallas``): the pmag-scaled damping projections of
``calculate_force`` (icebergs.F90:706-804) on the precomputed pair
slabs, reduced over the M candidates to the five damping sums; the
spring sums ``IA_x``/``IA_y`` pass through.  The plain version is
:func:`.forces.eval_pair_ia`.

The kernel sums each row's active terms in ascending candidate order
from +0, the same bits on every run.  A row with at most two active
pairs then equals the plain version bit for bit (the inactive pairs'
zeros add exactly); on a row with more, ``torch.sum``'s order differs
from it by rounding, at most (M - 1) ulp of the row's sum of magnitudes.
The kernel writes the five sums as one (5, N) tensor, so each field is
contiguous (``P21`` is ``P12``).
"""

from __future__ import annotations

import ctypes
import re

import torch

from .. import cuda_build
from ..config import IcebergsConfig
from .accel import IA
from .forces import PairData, eval_pair_ia

_SLABS = ("P11", "P12", "P22", "crad", "ctan", "u2", "v2")


def eval_pair_ia_kernel(pd: PairData, cfg: IcebergsConfig, u0, v0, u1,
                        v1) -> IA:
    """:func:`.forces.eval_pair_ia` through K7.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (counted in
    ``eval_pair_ia_kernel.launches``, and by M in ``.launches_by_m``; N =
    0 launches nothing)."""
    if pd.P11.device.type == "cpu":
        return eval_pair_ia(pd, cfg, u0, v0, u1, v1)
    if pd.P11.device.type != "cuda":
        raise NotImplementedError(f"no K7 kernel for {pd.P11.device}")
    N, M = pd.P11.shape
    slabs = [getattr(pd, f) for f in _SLABS]
    rows = (u0, v0, u1, v1)
    if (pd.active.shape != (N, M) or pd.active.dtype != torch.bool
            or any(s.shape != (N, M) or s.dtype != torch.float32
                   for s in slabs)
            or any(r.shape != (N,) or r.dtype != torch.float32
                   for r in rows)):
        raise ValueError("K7 takes (N, M) float32 slabs, an (N, M) bool "
                         "active mask and (N,) float32 velocities")
    args = [t.contiguous() for t in (pd.active, *slabs, *rows)]
    if args[0].data_ptr() % 16:
        # the mask streams in 16-byte vectors from its base
        args[0] = args[0].clone()
    out = torch.empty(5, N, dtype=torch.float32, device=pd.P11.device)
    if N:
        cuda_build.check(cuda_build.library().ib_pair_eval(
            *(t.data_ptr() for t in args), N, M,
            int(cfg.scale_damping_by_pmag), out.data_ptr(),
            cuda_build.stream_ptr(out.device)), "eval_pair_ia_kernel")
        eval_pair_ia_kernel.launches += 1
        by_m = eval_pair_ia_kernel.launches_by_m
        by_m[M] = by_m.get(M, 0) + 1
    s11, s12, s22, sux, suy = out.unbind(0)
    return IA(IA_x=pd.IA_x, IA_y=pd.IA_y, P11=s11, P12=s12, P21=s12,
              P22=s22, Pu_x=sux, Pu_y=suy)


eval_pair_ia_kernel.launches = 0
eval_pair_ia_kernel.launches_by_m = {}     # the same launches by M


def kernel_config(m: int, pmag: bool):
    """``(rows per tile, static shared memory bytes, resident CTAs per
    SM)`` of the K7 launch at M = ``m`` on the current CUDA device."""
    tr, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    cuda_build.check(cuda_build.library().ib_pair_eval_config(
        m, int(pmag), ctypes.byref(tr), ctypes.byref(smem),
        ctypes.byref(ctas)), "pair_eval_config")
    return tr.value, smem.value, ctas.value


def kernel_resources() -> dict:
    """Registers, stack frame and spill bytes of each K7 instantiation
    (``"pmag"``, ``"plain"``), from the library's ``-Xptxas -v``
    report."""
    out = {}
    for name, r in cuda_build.resource_report().items():
        m = re.search(r"pair_eval_kernelILb([01])E", name)
        if m and "registers" in r:
            out["pmag" if m.group(1) == "1" else "plain"] = r
    return out

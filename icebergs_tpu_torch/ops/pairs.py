"""K7: the velocity-dependent pair evaluation over (N, M) pair slabs.

Counterpart of ``icebergs_tpu/ops/pallas_pairs.py`` (``_pallas_eval``,
``eval_pair_ia_pallas``): the pmag-scaled damping projections of
``calculate_force`` (icebergs.F90:706-804) on the precomputed pair
slabs, reduced over the M candidates to the five damping sums; the
spring sums ``IA_x``/``IA_y`` pass through.  The plain version is
:func:`.forces.eval_pair_ia`.

The kernel sums each row's M terms across a warp's lanes and a shuffle
tree, not in ``torch.sum``'s order, so it agrees with the plain version
to rounding, not bit for bit.  Inactive pairs contribute exact zeros and
a row rarely has more than two active pairs, so the sums usually agree
exactly; where three or more terms are nonzero each order's error is at
most (M - 1) ulp of the row's sum of magnitudes.
"""

from __future__ import annotations

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
    ``eval_pair_ia_kernel.launches``)."""
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
    out = torch.empty(N, 8, dtype=torch.float32, device=pd.P11.device)
    lib = cuda_build.library()
    cuda_build.check(lib.ib_pair_eval(
        *(t.data_ptr() for t in args), N, M,
        int(cfg.scale_damping_by_pmag), out.data_ptr(),
        cuda_build.stream_ptr(out.device)), "eval_pair_ia_kernel")
    eval_pair_ia_kernel.launches += 1
    return IA(IA_x=pd.IA_x, IA_y=pd.IA_y, P11=out[:, 0], P12=out[:, 1],
              P21=out[:, 1], P22=out[:, 2], Pu_x=out[:, 3], Pu_y=out[:, 4])


eval_pair_ia_kernel.launches = 0

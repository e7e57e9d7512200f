"""State checksum.

PyTorch counterpart of ``icebergs_tpu.diag.berg_chksum``
(``icebergs_tpu/diag.py:30-47``): an order-invariant hash of the live
state, the sum of the float bit patterns modulo 2^32.
"""

from __future__ import annotations

import torch

CHKSUM_FIELDS = ("lon", "lat", "uvel", "vvel", "mass", "thickness",
                 "width", "length", "axn", "ayn", "bxn", "byn",
                 "start_lon", "start_lat", "start_day", "start_mass",
                 "mass_scaling", "mass_of_bits", "heat_density")

_U32 = 0xFFFFFFFF


def berg_chksum(st, fields=CHKSUM_FIELDS):
    """``(chksum, n)``: 0-dim int64 tensors holding the u32 hash of the
    live bergs and their count — bit for bit the JAX package's value.

    torch has no usable uint32 sum, so each field's bits are widened to
    int64 in ``[0, 2^32)``, summed exactly (N < 2^31 rows) and wrapped."""
    alive = st.alive & (st.halo_berg < 0.5)
    total = torch.zeros((), dtype=torch.int64, device=alive.device)
    for f in fields:
        arr = getattr(st, f)
        bits = (arr.view(torch.int32) if arr.dtype == torch.float32
                else arr.to(torch.int32)).to(torch.int64) & _U32
        total = (total + torch.where(alive, bits, 0).sum()) & _U32
    return total, alive.sum(dtype=torch.int64)

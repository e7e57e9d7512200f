"""The interpolated environment a berg carries.

Counterpart of ``icebergs_tpu/ops/interp.py``'s ``Env``.  The per-field
XLA interpolation ``interp_flds`` (``interp_mode="xla"``) is not ported;
the step reads the environment through :mod:`.interp_table`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Env(NamedTuple):
    uo: torch.Tensor
    vo: torch.Tensor
    ui: torch.Tensor
    vi: torch.Tensor
    ua: torch.Tensor
    va: torch.Tensor
    ssh_x: torch.Tensor
    ssh_y: torch.Tensor
    sst: torch.Tensor
    sss: torch.Tensor
    cn: torch.Tensor
    hi: torch.Tensor
    od: torch.Tensor

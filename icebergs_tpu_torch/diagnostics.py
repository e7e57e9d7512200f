"""Gridded diagnostics manager: the diag_manager analog.

Counterpart of ``icebergs_tpu/diagnostics.py``.  The reference registers
~50 gridded fields with FMS diag_manager (``register_diag_field`` /
``send_data``, icebergs.F90:5529-5634; id fields
icebergs_framework.F90:210-224) and lets a ``diag_table`` select which
are written.  A :class:`DiagManager` holds the named fields, accumulates
each step's values on the device (time-averaged or instantaneous sums)
and drains them to a NetCDF history file in :meth:`DiagManager.flush`,
the only place that reads them on the host; the file is the JAX
package's, variable for variable.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from scipy.io import netcdf_file

from .diag import bergs_per_cell, list_chksum_per_cell

# the reference's diagnostic catalog (register_diag_field names,
# icebergs_framework.F90:210-229 registrations / send_data block
# icebergs.F90:5529-5634).  One row per reference field; `melt` is the
# reference's name for floating_melt's registered field and
# melt_m_per_year its unit-converted twin (icebergs.F90:5551-5553).
CATALOG = (
    # calving pipeline
    "calving", "calving_hflx", "calving_hflx_in", "accum_calving",
    "unused_calving", "real_calving", "stored_ice", "stored_heat",
    "running_mean_calving", "running_mean_calving_hflx",
    # melt
    "melt", "melt_m_per_year", "floating_melt", "berg_melt", "melt_buoy",
    "melt_eros", "melt_conv", "melt_by_class", "melt_buoy_fl",
    "melt_eros_fl", "melt_conv_fl", "fl_parent_melt", "fl_child_melt",
    # bits
    "bergy_src", "bergy_melt", "bergy_mass", "fl_bits_src", "fl_bits_melt",
    "fl_bits_mass", "fl_bergy_bits_mass",
    # spread / gridded state
    "spread_mass", "spread_area", "spread_uvel", "spread_vvel",
    "ustar_iceberg", "mass_on_ocean", "mass", "virtual_area", "u_iceberg",
    "v_iceberg",
    # forcing copies (icebergs.F90:5529-5548, 5604-5610)
    "uo", "vo", "ui", "vi", "ua", "va", "sst", "sss", "cn", "hi", "ssh",
    "taux", "tauy", "depth",
    # per-cell bookkeeping (icebergs.F90:5620-5634)
    "berg_count", "bergs_per_cell", "list_chksum",
)


class DiagState(NamedTuple):
    sums: Dict[str, torch.Tensor]    # accumulated (nx+2, ny+2) fields
    count: int                       # steps accumulated


class DiagManager:
    """Register fields, accumulate per step, flush to NetCDF."""

    def __init__(self, grid, selected=None, average: bool = True):
        self.grid = grid
        self.names = tuple(selected) if selected is not None else CATALOG
        self.average = average
        self._created: set = set()   # paths this manager created this run

    def init_state(self, dtype=torch.float32) -> DiagState:
        shape = (self.grid.nx + 2, self.grid.ny + 2)
        return DiagState(
            sums={n: torch.zeros(shape, dtype=dtype, device=self.grid.device)
                  for n in self.names}, count=0)

    def send_data(self, dstate: DiagState, fields: dict) -> DiagState:
        """Accumulate a step's fields (send_data analog): names outside
        the selection and None values are ignored, 3-D fields are summed
        over the class axis.  On the device, no host read."""
        sums = dict(dstate.sums)
        for n in self.names:
            v = fields.get(n)
            if v is None:
                continue
            if v.dim() == 3:
                v = v.sum(dim=-1)
            sums[n] = sums[n] + v
        # after a step the fields go in name order, as the JAX package's
        # jitted accumulator returns them: the history file's variables
        # follow this order
        return DiagState(sums={n: sums[n] for n in sorted(sums)},
                         count=dstate.count + 1)

    def flush(self, dstate: DiagState, path: str, time_value: float = 0.):
        """Append the accumulated (time-averaged) record to the NetCDF
        history file and return a cleared accumulator.  Repeated flushes
        grow the unlimited Time axis in place, the diag_manager
        history-file behaviour."""
        n = max(dstate.count, 1)
        rec = {}
        for name, arr in dstate.sums.items():
            a = arr.cpu().numpy()[1:-1, 1:-1]
            if self.average:
                a = a / n
            rec[name] = a
        first = path not in self._created
        self._created.add(path)
        with netcdf_file(path, "w" if first else "a") as f:
            if first:
                f.createDimension("Time", None)  # unlimited; must be first
                f.createDimension("xaxis_1", self.grid.nx)
                f.createDimension("yaxis_1", self.grid.ny)
                f.createVariable("Time", "d", ("Time",))
                for name in rec:
                    f.createVariable(name, "d",
                                     ("Time", "yaxis_1", "xaxis_1"))
            tv = f.variables["Time"]
            t = tv.shape[0] if tv.shape and tv.shape[0] else 0
            tv[t] = float(time_value)
            for name, a in rec.items():
                f.variables[name][t] = a.T
        return self.init_state(next(iter(dstate.sums.values())).dtype)


def _to_center(a):
    """Corner (B-grid) field averaged to the halo-padded centres, so that
    every catalog field shares the (nx+2, ny+2) shape."""
    c = 0.25 * (a[:-1, :-1] + a[1:, :-1] + a[:-1, 1:] + a[1:, 1:])
    return torch.nn.functional.pad(c, (1, 1, 1, 1))


def collect_forcing_fields(frc=None, grid=None) -> dict:
    """The forcing-copy fields (icebergs.F90:5529-5548) and the grid's
    depth.  Apart from :func:`collect_step_fields` so that a driver with
    constant forcing computes them once (``forcing_fields=``)."""
    d = {}
    if frc is not None:
        for n in ("uo", "vo", "ui", "vi", "ua", "va"):
            v = getattr(frc, n, None)
            if v is not None:
                d[n] = _to_center(v)
        for n in ("sst", "sss", "cn", "hi", "ssh"):
            v = getattr(frc, n, None)
            if v is not None:
                d[n] = v
        for n in ("taux", "tauy"):
            v = getattr(frc, n, None)
            if v is not None:
                d[n] = _to_center(v) if v.dim() == 2 and \
                    v.shape[0] != d.get("sst", v).shape[0] else v
    if grid is not None and getattr(grid, "ocean_depth", None) is not None:
        d["depth"] = grid.ocean_depth
    return d


def collect_step_fields(outputs, extra: Optional[dict] = None, *,
                        frc=None, grid=None, st=None, cfg=None,
                        forcing_fields: Optional[dict] = None) -> dict:
    """The send_data field dict of a step's ``StepDiags`` /
    ``RunOutputs``, with the forcing copies and the depth
    (``forcing_fields``: a precomputed :func:`collect_forcing_fields`)
    and, given ``st`` and ``grid``, the per-cell count and hash
    (icebergs.F90:5620-5634)."""
    d = {}
    for name in CATALOG:
        v = getattr(outputs, name, None)
        if v is not None:
            d[name] = v
    fm = d.get("floating_melt")
    if fm is not None:
        d.setdefault("melt", fm)
        if cfg is not None:
            d.setdefault("melt_m_per_year",
                         fm * (86400.0 * 365.0 / cfg.rho_bergs))
    if forcing_fields is not None:
        d.update(forcing_fields)
    elif frc is not None or grid is not None:
        d.update(collect_forcing_fields(frc, grid))
    if st is not None and grid is not None:
        d["bergs_per_cell"] = bergs_per_cell(st, grid)
        d["list_chksum"] = list_chksum_per_cell(st, grid)
    if extra:
        d.update(extra)
    return d


def monitor_a_berg(st, berg_id: int, label: str = ""):
    """Single-particle tracing (monitor_a_berg / debug_iceberg_with_id,
    icebergs_framework.F90:4245-4269): print the berg's vitals if it is
    present.  Host side."""
    from .ids import ids_of_state
    ids = np.asarray(ids_of_state(st))
    alive = st.alive.cpu().numpy()
    hit = np.nonzero(alive & (ids == berg_id))[0]
    vals = {f: getattr(st, f).cpu().numpy() for f in
            ("lon", "lat", "uvel", "vvel", "mass")}
    for s in hit:
        print(f"KID-TPU monitor[{label}] id={berg_id} slot={s} "
              f"lon={float(vals['lon'][s]):.6f} "
              f"lat={float(vals['lat'][s]):.6f} "
              f"u={float(vals['uvel'][s]):.6f} "
              f"v={float(vals['vvel'][s]):.6f} "
              f"mass={float(vals['mass'][s]):.6e}")
    return len(hit) > 0

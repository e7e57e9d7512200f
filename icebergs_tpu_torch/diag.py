"""Checksums, budgets and state reports.

PyTorch counterpart of ``icebergs_tpu/diag.py`` (``berg_chksum``,
``bergs_per_cell``, ``list_chksum_per_cell``, ``grd_chksum2``,
``grd_chksum3``, ``calving_chksum``, ``check_state``, ``Budgets``,
``compute_budgets``, ``report_budget``, ``IntervalBudget``,
``report_full_budget``; port of
``src/icebergs_framework.F90:6606-7070`` and the budget tables of
``src/icebergs.F90:5683-5995``).  The hashes are order-invariant sums of
bit patterns modulo 2^32, bit for bit the JAX package's uint32 values
(here int64 tensors in [0, 2^32): torch has no usable uint32 sum); a
float64 field hashes as the sum of its two 32-bit words, as the JAX
package's does.  ``debug_write_and_stop`` writes a restart file;
``dump_halo_state`` lists the multi-device halo (ROADMAP.md Queue 1 item
13) and raises.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
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
        bits = _u32(getattr(st, f))
        total = (total + torch.where(alive, bits, 0).sum()) & _U32
    return total, alive.sum(dtype=torch.int64)


def _u32(arr):
    """The u32 bit pattern of each element, widened to int64 in
    [0, 2^32): float32 bits; a float64's two 32-bit words summed mod
    2^32; integers wrapped as the JAX ``astype``."""
    if arr.dtype == torch.float32:
        return arr.view(torch.int32).to(torch.int64) & _U32
    if arr.dtype == torch.float64:
        w = arr.view(torch.int32).view(*arr.shape, 2).to(torch.int64) & _U32
        return (w[..., 0] + w[..., 1]) & _U32
    return arr.to(torch.int64) & _U32


def _as_i32(x):
    """An int64 tensor in [0, 2^32) as the int32 of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bergs_per_cell(st, grid):
    """Live, owned bergs per cell, (nx+2, ny+2) int32 (the id_count
    diagnostic, icebergs.F90:5620-5627)."""
    alive = st.alive & (st.halo_berg < 0.5)
    out = torch.zeros((grid.nx + 2, grid.ny + 2), dtype=torch.int32,
                      device=st.device)
    return out.index_put_(((st.ine + 1).long(), (st.jne + 1).long()),
                          alive.to(torch.int32), accumulate=True)


def list_chksum_per_cell(st, grid, fields=CHKSUM_FIELDS):
    """Per-cell u32 hash of the live bergs' fields as int32 (the
    id_chksum diagnostic, icebergs.F90:5628-5634): bit for bit the JAX
    package's."""
    alive = st.alive & (st.halo_berg < 0.5)
    total = torch.zeros(st.capacity, dtype=torch.int64, device=st.device)
    for f in fields:
        total = (total + torch.where(alive, _u32(getattr(st, f)), 0)) & _U32
    out = torch.zeros((grid.nx + 2, grid.ny + 2), dtype=torch.int64,
                      device=st.device)
    out.index_put_(((st.ine + 1).long(), (st.jne + 1).long()),
                   torch.where(alive, total, 0), accumulate=True)
    return _as_i32(out & _U32)


def grd_chksum2(field):
    """Gridded-field u32 hash (0-dim int64 in [0, 2^32), the JAX uint32's
    value) and stats (grd_chksum2)."""
    f32 = field.to(torch.float32)
    return dict(chksum=_u32(field).sum() & _U32, minv=field.min(),
                maxv=field.max(), mean=field.mean(),
                rms=torch.sqrt((f32 * f32).mean()))


def grd_chksum3(field):
    """Class-resolved hash of an (nx+2, ny+2, nclasses) field (the
    ``grd_chksum3`` family, icebergs_framework.F90:6606-7070): the total,
    a per-class (last axis) vector and the stats."""
    if field.dim() != 3:
        raise ValueError(f"grd_chksum3 takes a 3-D field, not "
                         f"{tuple(field.shape)}")
    per_class = _u32(field).sum(dim=(0, 1)) & _U32
    f32 = field.to(torch.float32)
    return dict(chksum=per_class.sum() & _U32, per_class=per_class,
                minv=field.min(), maxv=field.max(), mean=field.mean(),
                rms=torch.sqrt((f32 * f32).mean()))


def calving_chksum(calv):
    """u32 hash of the whole calving state (the ``write_restart_calving``
    payload: stored_ice, stored_heat, rmean_calving, rmean_calving_hflx;
    icebergs_fms2io.F90:1484-1598).  Returns ``(total, grd_chksum3 of
    stored_ice)``."""
    c3 = grd_chksum3(calv.stored_ice)
    total = c3["chksum"]
    for f in (calv.stored_heat, calv.rmean_calving,
              calv.rmean_calving_hflx):
        total = (total + _u32(f).sum()) & _U32
    return total, c3


def check_state(st, grid, cfg, label: str = "", fatal: bool = True):
    """Runtime invariant checks (check_position, duplicate ids, finite
    values; icebergs.F90:7117-7131, icebergs_framework.F90:7344-7453).
    Host side: returns the problems found, and raises if ``fatal``."""
    from .ids import check_for_duplicate_ids
    from .ops.forces import check_bond_reciprocity

    def host(x):
        return x.detach().cpu().numpy()

    problems = []
    alive = host(st.alive)
    if alive.any():
        for f in ("lon", "lat", "uvel", "vvel", "mass", "thickness"):
            if not np.all(np.isfinite(host(getattr(st, f))[alive])):
                problems.append(f"non-finite {f}")
        ine, jne = host(st.ine)[alive], host(st.jne)[alive]
        if (ine < 0).any() or (ine >= grid.nx).any() \
                or (jne < 0).any() or (jne >= grid.ny).any():
            problems.append("cell index out of range")
        xi, yj = host(st.xi)[alive], host(st.yj)[alive]
        if (xi < -1e-4).any() or (xi > 1 + 1e-4).any() \
                or (yj < -1e-4).any() or (yj > 1 + 1e-4).any():
            problems.append("xi/yj outside the unit cell")
        dups = check_for_duplicate_ids(st)
        if len(dups):
            problems.append(f"{len(dups)} duplicate ids")
        if cfg.iceberg_bonds_on:
            nbad = int(check_bond_reciprocity(st))
            if nbad:
                problems.append(f"{nbad} non-reciprocal bonds")
    if problems and fatal:
        raise RuntimeError(f"check_state[{label}]: " + "; ".join(problems))
    return problems


def debug_write_and_stop(st, cfg, path: str = "debug_state.nc",
                         message: str = "debugwriteandstop"):
    """Write the whole particle state as a restart file and stop
    (debugwriteandstop, icebergs.F90:180-191): raises RuntimeError."""
    from .io.restart import write_restart_bergs
    write_restart_bergs(path, st, cfg)
    raise RuntimeError(f"KID-TPU {message}: state dumped to {path}")


def dump_halo_state(st, label: str = "", device: int = -1, file=None):
    """``halo_debugging``'s listing (icebergs_framework.F90:1828-1838):
    one 'A id pe halo_berg i j' line per alive berg with its bond count,
    to read replication before and after a halo exchange, line for line
    ``icebergs_tpu.diag.dump_halo_state``'s.

    ``st`` is a state or a tiled state (a list of the tiles' states, ``pe``
    the tile's place in it); ``device`` >= 0 lists that tile only.  Reads
    the card on the host."""
    out = file or sys.stderr
    tiles = list(st) if isinstance(st, (list, tuple)) else [st]
    if label:
        print(f"halo_debugging [{label}]", file=out)
    for d, s in enumerate(tiles):
        if device >= 0 and d != device:
            continue
        f = {k: getattr(s, k).detach().cpu().numpy() for k in (
            "alive", "id_cnt", "id_ij", "halo_berg", "ine", "jne",
            "n_bonds")}
        for k in np.nonzero(f["alive"])[0]:
            print(f"A {int(f['id_cnt'][k])}:{int(f['id_ij'][k])} pe={d} "
                  f"halo={int(f['halo_berg'][k])} i={int(f['ine'][k])} "
                  f"j={int(f['jne'][k])} bonds={int(f['n_bonds'][k])}",
                  file=out)


class Budgets(NamedTuple):
    nbergs: torch.Tensor
    mass: torch.Tensor            # berg kg (with mass_scaling)
    mass_of_bits: torch.Tensor    # all bits kg (bergy + fl + fl bergy)
    heat: torch.Tensor            # J
    stored_ice: torch.Tensor      # kg in the calving buckets
    stored_heat: torch.Tensor
    # the category split (sum_mass justbergs / justbits / justflbits,
    # icebergs_framework.F90:6606-6680)
    bergy_mass: Optional[torch.Tensor] = None
    fl_bits_mass: Optional[torch.Tensor] = None


def compute_budgets(st, calv=None) -> Budgets:
    """Global stocks for the budget tables (sum_mass / sum_heat,
    icebergs_framework.F90:6606-6680), as 0-dim tensors."""
    own = st.alive & (st.halo_berg < 0.5)
    sc = st.mass_scaling
    mass = torch.where(own, st.mass * sc, 0.).sum()
    bergy = torch.where(own, st.mass_of_bits * sc, 0.).sum()
    flb = torch.where(own, (st.mass_of_fl_bits + st.mass_of_fl_bergy_bits)
                      * sc, 0.).sum()
    # the floating heat covers the bergs and all their bits
    heat = torch.where(own, (st.mass + st.mass_of_bits + st.mass_of_fl_bits
                             + st.mass_of_fl_bergy_bits) * sc
                       * st.heat_density, 0.).sum()
    z = torch.zeros((), dtype=st.dtype, device=st.device)
    return Budgets(
        nbergs=own.sum(dtype=torch.int32), mass=mass,
        mass_of_bits=bergy + flb, heat=heat,
        stored_ice=calv.stored_ice.sum() if calv is not None else z,
        stored_heat=calv.stored_heat.sum() if calv is not None else z,
        bergy_mass=bergy, fl_bits_mass=flb)


def report_budget(tag: str, b0: Budgets, b1: Budgets, dt_total: float,
                  melt_kg=0.0, calving_in_kg=0.0):
    """Print a budget-closure table in the manner of ``report_budget``
    (icebergs.F90:5890-5995); returns the closure error in kg.  Host
    side."""
    dm = float(b1.mass + b1.stored_ice - b0.mass - b0.stored_ice)
    rhs = float(calving_in_kg) - float(melt_kg)
    err = dm - rhs
    denom = max(abs(float(b1.mass)), 1.0)

    def row(name, v0, v1, unit):
        print(f"budget | {name:<14} | {float(v0):14.7e} | "
              f"{float(v1):14.7e} | {float(v1) - float(v0):+12.5e} {unit}")

    print(f"budget [{tag}] over {dt_total:.0f} s (start | end | delta):")
    row("bergs", b0.nbergs, b1.nbergs, "#")
    row("berg mass", b0.mass, b1.mass, "kg")
    row("bits mass", b0.mass_of_bits, b1.mass_of_bits, "kg")
    row("stored ice", b0.stored_ice, b1.stored_ice, "kg")
    row("stored heat", b0.stored_heat, b1.stored_heat, "J")
    row("heat content", b0.heat, b1.heat, "J")
    print(f"budget | in-out={rhs:+.5e} kg  dM={dm:+.5e} kg  "
          f"err={err:+.3e} kg (rel {err / denom:+.3e})")
    return err


class IntervalBudget:
    """Interval source and sink accumulators of the category budget
    tables (the reference's ``lbudget`` block, icebergs.F90:5700-5860):
    feed each step's ``StepDiags`` / ``RunOutputs`` to :meth:`add_step`,
    print with :func:`report_full_budget`, then :meth:`reset`.  The sums
    are float64 0-dim tensors on the diagnostics' device (Python 0.0
    until a step adds to them): ``add_step`` reads nothing on the host,
    the report does."""

    SCALARS = (
        "nbergs_calved", "nbergs_calved_fl", "nbergs_melted",
        "nspeeding_tickets", "net_calving_used",
        "net_incoming_calving_heat_used", "net_calving_to_bergs",
        "net_heat_to_bergs", "net_melt", "berg_melt", "bergy_src",
        "bergy_melt", "fl_bits_src", "fl_bits_melt", "fl_to_berg_kg",
        "flb_to_bergy_kg", "net_heat_to_ocean")

    def __init__(self):
        self.reset()

    def reset(self):
        for k in self.SCALARS:
            setattr(self, k, 0.0)

    @staticmethod
    def _field_kg(field, grid, dt):
        """A (nx+2, ny+2) kg/m2/s rate field as kg over ``dt``."""
        if field is None:
            return 0.0
        return (field * grid.area).sum().double() * dt

    def add_step(self, d, grid, dt):
        """Accumulate one step's diagnostics (missing ones count as 0).
        The mass sinks are the strict per-category scalars of the
        thermodynamics (the gridded melt fields lump the footloose bits'
        internal erosion in, as the reference's do)."""
        def sc(name):
            v = getattr(d, name, None)
            if v is None:
                return 0.0
            return v.double() if torch.is_tensor(v) else float(v)

        self.nbergs_calved += sc("nbergs_calved")
        self.nbergs_calved_fl += sc("nbergs_calved_fl")
        self.nbergs_melted += sc("nbergs_melted") + sc("nbergs_deleted_fl")
        self.nspeeding_tickets += sc("tickets")
        self.net_calving_used += sc("net_calving_used")
        self.net_incoming_calving_heat_used += sc("heat_used")
        self.net_calving_to_bergs += sc("calving_to_bergs")
        self.net_heat_to_bergs += sc("heat_to_bergs")
        self.net_heat_to_ocean += sc("net_melt_heat")
        self.net_melt += sc("net_melt_kg")
        self.berg_melt += sc("berg_melt_kg")
        self.bergy_src += sc("bergy_src_kg")
        self.bergy_melt += sc("bergy_melt_kg")
        # footloose outflow: the bits' loss less what erodes into their
        # own bergy bits, plus those bergy bits' melt
        self.fl_bits_melt += (sc("fl_bits_melt_kg")
                              - sc("flb_internal_eros_kg")
                              + sc("flb_bergy_melt_kg"))
        # shed mass enters through the rate field, net of the promoted
        # mass, which the two promotion scalars route to bergs and bits
        self.fl_bits_src += self._field_kg(getattr(d, "fl_bits_src", None),
                                           grid, dt)
        self.fl_to_berg_kg += sc("fl_to_berg_kg")
        self.flb_to_bergy_kg += sc("flb_to_bergy_kg")


def report_full_budget(tag: str, b0: Budgets, b1: Budgets,
                       acc: IntervalBudget, file=None):
    """The reference's category budget tables (report_state /
    report_istate / report_ibudget / report_budget,
    icebergs.F90:5780-5860) over one interval, rows in its order, each
    budget row with its normalised closure error.  Returns
    ``{row title: error}``.  Host side."""
    out = file or sys.stdout
    errs = {}

    def p(line):
        print(f"icebergs: {line}", file=out)

    def f(v):
        return f"{float(v):14.7e}"

    def state(title, v0, v1, unit, nbergs=None):
        tail = (f", # of bergs={int(nbergs):8d}"
                if nbergs is not None else "")
        p(f"{title + ' state:':<22}start={f(v0)} {unit}, end={f(v1)} "
          f"{unit}, Delta={f(float(v1) - float(v0))} {unit}{tail}")

    def istate(title, v0, v1):
        p(f"{title + ' state:':<22}start={int(v0):14d}, "
          f"end={int(v1):14d}, Delta={int(v1) - int(v0):14d}")

    def budget(title, unit, in_s, inv, out_s, outv, v0, v1):
        d_state = float(v1) - float(v0)
        d_flux = float(inv) - float(outv)
        err = (d_state - d_flux) / max(1e-30, max(abs(d_state),
                                                  abs(d_flux)))
        errs[title] = err
        p(f"{title + ' budget:':<22}{in_s} in={f(inv)} {unit}, "
          f"{out_s} out={f(outv)} {unit}, Delta={f(d_flux)} {unit}, "
          f"error={err:10.3e} nd")

    def ibudget(title, in1_s, in1, in2_s, in2, out_s, outv, v0, v1):
        d = int(in1) + int(in2) - int(outv)
        err = (int(v1) - int(v0)) - d
        errs[title] = err
        p(f"{title + ' budget:':<22}{in1_s} in={int(in1):10d}, "
          f"{in2_s} in={int(in2):10d}, {out_s} out={int(outv):10d}, "
          f"Delta={d:10d}, error={err:10d}")

    floating0 = float(b0.mass) + float(b0.mass_of_bits)
    floating1 = float(b1.mass) + float(b1.mass_of_bits)
    p(f"budget tables [{tag}]")
    state("stored ice", b0.stored_ice, b1.stored_ice, "kg")
    state("floating", floating0, floating1, "kg", nbergs=b1.nbergs)
    state("icebergs", b0.mass, b1.mass, "kg")
    state("bits", b0.bergy_mass, b1.bergy_mass, "kg")
    state("fl_bits", b0.fl_bits_mass, b1.fl_bits_mass, "kg")
    istate("berg #", b0.nbergs, b1.nbergs)
    ibudget("berg #", "calved", acc.nbergs_calved,
            "FL calved", acc.nbergs_calved_fl,
            "melted", acc.nbergs_melted, b0.nbergs, b1.nbergs)
    budget("stored mass", "kg", "calving used", acc.net_calving_used,
           "bergs", acc.net_calving_to_bergs,
           b0.stored_ice, b1.stored_ice)
    budget("floating mass", "kg", "calving used",
           acc.net_calving_to_bergs, "melt", acc.net_melt,
           floating0, floating1)
    budget("berg mass", "kg", "calving+promo",
           acc.net_calving_to_bergs + acc.fl_to_berg_kg,
           "melt+eros+fl", acc.berg_melt + acc.fl_bits_src
           + acc.fl_to_berg_kg, b0.mass, b1.mass)
    budget("bits mass", "kg", "eros used",
           acc.bergy_src + acc.flb_to_bergy_kg,
           "bergs", acc.bergy_melt, b0.bergy_mass, b1.bergy_mass)
    budget("fl bits mass", "kg", "fl calving", acc.fl_bits_src,
           "fl melt+eros", acc.fl_bits_melt + acc.flb_to_bergy_kg,
           b0.fl_bits_mass, b1.fl_bits_mass)
    state("stored heat", b0.stored_heat, b1.stored_heat, "J")
    state("floating heat", b0.heat, b1.heat, "J")
    budget("stored heat", "J", "calving used",
           acc.net_incoming_calving_heat_used, "bergs",
           acc.net_heat_to_bergs, b0.stored_heat, b1.stored_heat)
    budget("flting heat", "J", "calved", acc.net_heat_to_bergs,
           "melt", acc.net_heat_to_ocean, b0.heat, b1.heat)
    if acc.nspeeding_tickets > 0:
        p(f"speeding tickets issued = {int(acc.nspeeding_tickets):4d}")
    return errs


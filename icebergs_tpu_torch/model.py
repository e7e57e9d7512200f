"""The coupling step: the production fast lane on a persistent sorted
slab, the per-step path, and the MTS/DEM step of bonded conglomerates.

Counterpart of ``icebergs_tpu/model.py``'s ``StepDiags``,
``interp_to_bergs`` and ``step_dynamics`` (``model.py:90-107``),
``make_step`` (``model.py:110-406``),
``make_persistent_multi_step`` (``model.py:413-612``) and
``make_multi_step`` (``model.py:615-695``).  One fast-lane step:

1. table interpolation of the forcing (one K1 read per berg), with
   ``interp_mode="kernel"`` the sorted-frame interpolation (K6), else
   (``"xla"``, coastal or tidal drift) :func:`.ops.interp.interp_flds`;
2. the contact search over the presorted slab — fused3 (K2, with
   ``contact_epilogue`` its pair epilogue), or ``"fused"`` (K5) — and
   the Verlet or RK4 step with the land-bounce walk;
3. one (cell, id) re-sort of the whole state (K1, or the transport the
   config's knobs pick), which serves the thermodynamics, the spreading
   and the next step's search;
4. thermodynamics, its melt columns deferred to the K3 pass, or summed
   by their own scatters for the other slot-sum methods and hexagons;
5. the spreading segment sums (K3, or the slot sums of
   ``slot_sum_method`` / the plain scatter of ``parallel_reprod=False``;
   hexagonal elements take the slot sums, as in the JAX package) and the
   coupler fields.

One per-step (``make_step``) step keeps the slot order: the table
interpolation where the JAX ``make_step`` takes it, else
``interp_flds``; the contact search on a sorted view — ``"fused3"`` (K2
plus K1 transports), ``"fused"`` (K5) or the ``"buckets"`` tables with
their pair evaluation through K7; Verlet or RK4; footloose calving
(its children's interactivity over the bucket tables); thermodynamics; K3
spreading behind a payload sort (K1) with all 14 deferred melt fields,
or the method's slot sums, or the plain scatters.  ``neighbor_mode=
"sorted"`` first re-sorts the whole state by (cell, id) (K1) and searches
the sorted strips (K7 evaluates the pairs); its state comes back in that
order.  An MTS step replaces
the dynamics with
:func:`.mts.evolve_icebergs_mts` (the Part-1 search through K2 with the
conglomerate filter or the candidate tables through K7, the
force-convergence loop, the substep loop in K4 or as the scan) and
reads the ocean depth through the quadratic stencil.

The JAX ``lax.scan`` becomes a Python loop over ``n_inner`` steps that
keeps the same coupler-field accumulator.  A non-MTS step makes no host
syncs; an MTS step makes one per force-convergence iteration (Part 1's
and the implicit inner substeps').
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import IcebergsConfig, check_ported
from .dynamics import evolve_icebergs
from .footloose import (adjust_fl_berg_interactivity,
                        delete_fully_fl_calved, footloose_calving)
from .grid import Grid
from .mts import drive_mts, evolve_icebergs_mts_sequence
from .ops import forces as _forces
from .ops import spread as _spread
from .ops import thermo as _thermo
from .ops.fused_contact import (FusedContactStats, make_ia_fn_fused,
                                make_ia_fn_fused2, make_ia_fn_fused3)
from .ops.interp import interp_to_bergs, use_interp_table
from .ops.interp_sorted import interp_to_bergs_sorted
from .ops.interp_table import interp_to_bergs_table
from .ops.segment_spread import cell_tables
from .ops.sorted import (sort_kw, sort_state_by_cell, strip_neighbor_tables,
                         uniform_state_fields)


class StepDiags(NamedTuple):
    nbergs: torch.Tensor
    tickets: torch.Tensor
    bounced: torch.Tensor
    total_mass: torch.Tensor          # sum alive mass*mass_scaling (kg)
    contact_overflow: Optional[torch.Tensor] = None  # fused-search drops
    contact_fallback: Optional[torch.Tensor] = None  # exact-fallback bergs
    p1_overflow: Optional[torch.Tensor] = None  # MTS Part-1 fallback drops
    # not in the JAX StepDiags: the MTS step's Part-1 fallback rows, newly
    # broken bonds, force-convergence iterations, the pair list's skin
    # drops and the implicit inner substeps' iterations (MtsDiags)
    p1_fallback: Optional[torch.Tensor] = None
    broken_bonds: Optional[torch.Tensor] = None
    conv_iters: Optional[int] = None
    skin_dropped: Optional[torch.Tensor] = None
    inner_conv_iters: Optional[int] = None
    floating_melt: Optional[torch.Tensor] = None   # (nx+2, ny+2) kg/m2/s
    calving_hflx: Optional[torch.Tensor] = None
    berg_melt: Optional[torch.Tensor] = None
    spread_mass: Optional[torch.Tensor] = None
    spread_area: Optional[torch.Tensor] = None
    spread_uvel: Optional[torch.Tensor] = None
    spread_vvel: Optional[torch.Tensor] = None
    ustar_iceberg: Optional[torch.Tensor] = None
    mass_on_ocean: Optional[torch.Tensor] = None
    u_iceberg: Optional[torch.Tensor] = None
    v_iceberg: Optional[torch.Tensor] = None
    melt_by_class: Optional[torch.Tensor] = None  # (nx+2, ny+2, classes)
    # the extended gridded diagnostics (diagnostics.CATALOG's): the rest
    # of the 14 melt fields (thermo.MELT_FIELDS) and of the spreading's
    mass: Optional[torch.Tensor] = None
    virtual_area: Optional[torch.Tensor] = None
    bergy_mass: Optional[torch.Tensor] = None
    fl_bits_mass: Optional[torch.Tensor] = None
    fl_bergy_bits_mass: Optional[torch.Tensor] = None
    bergy_src: Optional[torch.Tensor] = None
    bergy_melt: Optional[torch.Tensor] = None
    fl_bits_melt: Optional[torch.Tensor] = None
    melt_buoy: Optional[torch.Tensor] = None
    melt_eros: Optional[torch.Tensor] = None
    melt_conv: Optional[torch.Tensor] = None
    fl_parent_melt: Optional[torch.Tensor] = None
    fl_child_melt: Optional[torch.Tensor] = None
    melt_buoy_fl: Optional[torch.Tensor] = None
    melt_eros_fl: Optional[torch.Tensor] = None
    melt_conv_fl: Optional[torch.Tensor] = None
    # footloose (FootlooseDiags) and the interval-budget scalars (kg this
    # step; diag.IntervalBudget reads them)
    nbergs_calved_fl: Optional[torch.Tensor] = None
    fl_spawn_overflow: Optional[torch.Tensor] = None
    nbergs_deleted_fl: Optional[torch.Tensor] = None
    fl_bits_src: Optional[torch.Tensor] = None     # (nx+2, ny+2) kg/m2/s
    fl_to_berg_kg: Optional[torch.Tensor] = None
    flb_to_bergy_kg: Optional[torch.Tensor] = None
    nbergs_melted: Optional[torch.Tensor] = None
    net_melt_kg: Optional[torch.Tensor] = None
    berg_melt_kg: Optional[torch.Tensor] = None
    bergy_src_kg: Optional[torch.Tensor] = None
    bergy_melt_kg: Optional[torch.Tensor] = None
    fl_bits_melt_kg: Optional[torch.Tensor] = None
    flb_bergy_melt_kg: Optional[torch.Tensor] = None
    flb_internal_eros_kg: Optional[torch.Tensor] = None
    net_melt_heat: Optional[torch.Tensor] = None


def run_sequence(seq):
    """Drive a step generator (``make_step``'s ``sequence``,
    :func:`.api.coupling_sequence`) to its end on one tile: every state
    it yields goes back as it is.  Returns the generator's value."""
    try:
        st = next(seq)
        while True:
            st = seq.send(st)
    except StopIteration as done:
        return done.value


def step_dynamics(st, grid: Grid, frc, cfg: IcebergsConfig, ia_fn=None):
    """Interpolation and evolve only, the minimum end-to-end slice
    (``icebergs_tpu.model.step_dynamics``): :func:`interp_to_bergs` then
    :func:`.dynamics.evolve_icebergs`; returns its ``EvolveOut``."""
    st = interp_to_bergs(st, grid, frc, cfg)
    return evolve_icebergs(st, grid, frc, cfg, ia_fn=ia_fn)


def _zero_spread(st, grid):
    """The with_spread=False probe's coupler fields: zeros."""
    z = torch.zeros(grid.nx + 2, grid.ny + 2, dtype=st.dtype,
                    device=st.device)
    return _spread.SpreadDiags(*([z] * 6 + [None] * 7))


def make_step(grid: Grid, cfg: IcebergsConfig, *, with_thermo: bool = True,
              with_interactions: Optional[bool] = None,
              with_spread: bool = True, with_calving: bool = False,
              with_class_melt: bool = False,
              max_per_cell: int = 16, neighbor_mode: Optional[str] = None,
              neighbor_window: str = "full",
              contact_cap: Optional[int] = None,
              mts_pair_cap: Optional[int] = None,
              mts_neighbor_mode: Optional[str] = None,
              mts_substep_kernel: str = "scan", mts_vmem_deltas=None,
              mts_vmem_block_n: int = 512, mts_lockstep: bool = False,
              fused_block_n: int = 128,
              fused_window: Optional[int] = None,
              fused_fallback_cap: Optional[int] = None,
              fused_fallback_strip_width: int = 64):
    """The per-step coupling path: returns ``step(state, forcing, *,
    fl_uniforms=None, current_year=0, current_yearday=0.) -> (state,
    StepDiags)``, the state in slot order
    (in (cell, id) order with ``neighbor_mode="sorted"``).

    Non-MTS: ``neighbor_mode`` ``"fused3"`` (the default of an
    interactive legacy config), ``"fused"``, ``"buckets"`` (with
    ``max_per_cell``, ``neighbor_window`` and ``contact_cap``) or
    ``"sorted"`` (strips of ``max_per_cell`` x (2r+1) slots); the bucket
    and strip tables' pair evaluation always goes through K7, whose
    wrapper takes the plain version for CPU tensors; ``with_interactions``
    / ``with_thermo`` / ``with_spread`` = False drop a phase;
    ``with_class_melt`` adds ``StepDiags.melt_by_class``.  Footloose
    children take their places from ``fl_uniforms`` (``(stream, state)
    -> (N,)``), by default :func:`.footloose.id_hash_uniforms` of
    (0, 0).  ``with_calving`` only routes
    :func:`make_multi_step`, as in the JAX package: the step does not
    calve (:class:`.api.IcebergsModel` does).  MTS: Part 1's collision
    group from the fused search (``mts_neighbor_mode`` None or
    ``"fused"``) or the candidate tables (any other mode, with
    ``max_per_cell`` and ``contact_cap``); ``mts_substep_kernel="vmem"``
    with ``mts_vmem_deltas`` from
    :func:`.ops.dem_substeps.analyze_bond_deltas` on a
    :func:`~.ops.dem_substeps.pack_conglomerates_blocked` state runs the
    substeps in K4, otherwise they run as the scan, with the frozen pair
    list of ``mts_pair_cap`` pairs where it applies (its overflow is
    ``StepDiags.contact_overflow``).  ``mts_lockstep``: the step's
    ``sequence`` also yields the MTS cycle's events
    (:class:`.mts.MtsEvent`, a sync at every substep's top), which the
    tiled MTS step answers for all its tiles at once."""
    check_ported(cfg)
    table = use_interp_table(cfg)
    # the pallas spread kernel pins the sort key's pre-thermodynamics
    # aliveness; the other reproducing methods (and hexagons) share one
    # (cell, id) sort
    spread_kernel = _spread.uses_spread_kernel(cfg)
    interactive = (cfg.interactive_icebergs_on if with_interactions is None
                   else with_interactions)
    if neighbor_mode is None:
        neighbor_mode = (cfg.resolved_contact_mode() if interactive
                         else "buckets")
    if neighbor_mode not in ("fused", "fused3", "buckets", "sorted"):
        raise ValueError(f"neighbor_mode={neighbor_mode!r}")
    window = cfg.fused_window if fused_window is None else fused_window
    cap = (cfg.fused_fallback_cap if fused_fallback_cap is None
           else fused_fallback_cap)
    radius = _forces.neighbor_radius(grid, cfg) if interactive else 1
    # the MTS search radius, read off the grid once here (a host read)
    mts_radius = _forces.neighbor_radius(grid, cfg) if cfg.mts else None
    cell_table = cell_tables(grid) if with_spread else None
    sorted_mode = interactive and neighbor_mode == "sorted"

    def contacts(st, cell_starts):
        """(ia_fn, FusedContactStats or None, contact_cap overflow)."""
        if neighbor_mode in ("fused", "fused3"):
            mk = make_ia_fn_fused3 if neighbor_mode == "fused3" \
                else make_ia_fn_fused2
            kw = dict(presorted=False) if neighbor_mode == "fused3" else {}
            ia_fn, fstats = mk(st, grid, cfg, block_n=fused_block_n,
                               window=window, fallback_cap=cap,
                               fallback_strip_width=fused_fallback_strip_width,
                               **kw)
            return ia_fn, fstats, None
        if neighbor_mode == "sorted":
            nbr = strip_neighbor_tables(
                st, grid, cfg, cell_starts,
                strip_width=max_per_cell * (2 * radius + 1),
                ncells_radius=radius)
        else:
            nbr = _forces.build_neighbor_tables(st, grid, cfg,
                                                max_per_cell=max_per_cell,
                                                ncells_radius=radius,
                                                window=neighbor_window)
        ia_fn = _forces.make_ia_fn(st, nbr, cfg, contact_cap=contact_cap)
        return ia_fn, None, ia_fn.overflow

    def step(st, frc, **kw):
        return run_sequence(sequence(st, frc, **kw))

    def sequence(st, frc, *, fl_uniforms=None, current_year=0,
                 current_yearday=0.):
        """The step as a generator returning ``(state, StepDiags)``; with
        footloose and contacts on it yields the state after the children
        are born, before their interactivity reads their neighbours, and
        goes on with the state sent back (a tiled step refreshes the halo
        copies there)."""
        zero = torch.zeros((), dtype=torch.int32, device=st.device)
        cell_starts = None
        if sorted_mode:
            st, cell_starts = sort_state_by_cell(st, grid, **sort_kw(cfg))
        # the per-step slab keeps the slots' order, random in cell; the
        # MTS slab is packed by conglomerate, local in cell (PERF.md)
        m25_pre = None
        if table:
            st, m25_pre = interp_to_bergs_table(
                st, grid, frc, cfg, via_rows=not (cfg.mts or sorted_mode))
        else:
            st = interp_to_bergs(st, grid, frc, cfg)
        fstats = mts_d = cap_ov = None
        if cfg.mts:
            mseq = evolve_icebergs_mts_sequence(
                st, grid, frc, cfg, pair_cap=mts_pair_cap,
                contact_cap=contact_cap, max_per_cell=max_per_cell,
                ncells_radius=mts_radius, sync=mts_lockstep,
                neighbor_mode=mts_neighbor_mode or "fused",
                fused_kw={"fallback_cap": cap,
                          "fallback_strip_width": fused_fallback_strip_width},
                substep_kernel=mts_substep_kernel,
                vmem_deltas=mts_vmem_deltas, vmem_block_n=mts_vmem_block_n)
            if mts_lockstep:
                st, mts_d = yield from mseq
            else:
                st, mts_d = drive_mts(mseq)
            tickets = bounced = zero
            cap_ov = mts_d.pair_overflow
        else:
            ia_fn = None
            if interactive:
                ia_fn, fstats, cap_ov = contacts(st, cell_starts)
            out = evolve_icebergs(st, grid, frc, cfg, ia_fn=ia_fn,
                                  m25_pre=m25_pre)
            st, tickets, bounced = out.state, out.tickets, out.bounced
        fl_d = fl_deleted = None
        if cfg.footloose:
            # footloose calving, then the deletion of fully calved edge
            # elements and the children's interactivity (icebergs.F90:
            # 5453-5488)
            st, fl_d = footloose_calving(
                st, grid, cfg, uniforms=fl_uniforms,
                current_year=current_year,
                current_yearday=current_yearday)
            st, fl_deleted = delete_fully_fl_calved(st)
            if interactive:
                st = yield st
                nbr2 = _forces.build_neighbor_tables(
                    st, grid, cfg, ncells_radius=radius,
                    max_per_cell=max_per_cell)
                st = adjust_fl_berg_interactivity(st, nbr2, cfg)
        # the spreading's sort keys on the pre-thermodynamics aliveness:
        # rows that die in thermodynamics keep their cell, so their
        # deferred melt still lands
        sort_ctx = key_alive = None
        if spread_kernel:
            key_alive = st.alive
        elif cfg.parallel_reprod:
            sort_ctx = _spread.make_sort_ctx(st, grid)
        melt = None
        if with_thermo:
            st, melt = _thermo.thermodynamics(
                st, grid, frc, cfg, defer_cell_cols=cfg.parallel_reprod,
                sort_ctx=sort_ctx, with_class_melt=with_class_melt)
        deferred = melt.deferred_cols if melt is not None else None
        melt_fields = ([None] * len(_thermo.MELT_FIELDS)
                       if melt is None or deferred is not None
                       else [getattr(melt, f) for f in _thermo.MELT_FIELDS])
        if not with_spread:
            sp = _zero_spread(st, grid)
        else:
            sp = _spread.create_gridded_icebergs_fields(
                st, grid, frc, cfg, key_alive=key_alive, cell_starts=None,
                extra_cell_cols=deferred, cell_table=cell_table,
                sort_ctx=sort_ctx)
            if deferred is not None:
                sp, melt_fields = sp
        diags = StepDiags(
            nbergs=st.count(), tickets=tickets, bounced=bounced,
            total_mass=torch.where(st.alive, st.mass * st.mass_scaling,
                                   0.).sum(),
            contact_overflow=(fstats.overflow if fstats is not None
                              else cap_ov),
            contact_fallback=(fstats.n_fallback if fstats is not None
                              else None),
            **dict(zip(_thermo.MELT_FIELDS, melt_fields)),
            **sp._asdict(),
            melt_by_class=(melt.melt_by_class if melt is not None
                           else None))
        if fl_d is not None:
            diags = diags._replace(
                nbergs_calved_fl=fl_d.nbergs_calved_fl,
                fl_spawn_overflow=fl_d.spawn_overflow,
                nbergs_deleted_fl=fl_deleted, fl_bits_src=fl_d.fl_bits_src,
                fl_to_berg_kg=fl_d.fl_to_berg_kg,
                flb_to_bergy_kg=fl_d.flb_to_bergy_kg)
        if melt is not None:
            diags = diags._replace(
                nbergs_melted=melt.nbergs_melted,
                net_melt_heat=melt.net_heat,
                **{f: getattr(melt, f) for f in (
                    "net_melt_kg", "berg_melt_kg", "bergy_src_kg",
                    "bergy_melt_kg", "fl_bits_melt_kg", "flb_bergy_melt_kg",
                    "flb_internal_eros_kg")})
        if mts_d is not None:
            diags = diags._replace(
                p1_overflow=mts_d.p1_overflow, p1_fallback=mts_d.p1_fallback,
                broken_bonds=mts_d.broken_bonds, conv_iters=mts_d.conv_iters,
                skin_dropped=mts_d.skin_dropped,
                inner_conv_iters=mts_d.inner_conv_iters)
        return st, diags

    step.sequence = sequence
    return step


def make_persistent_multi_step(grid: Grid, cfg: IcebergsConfig,
                               n_inner: int, with_stats: bool = False, *,
                               with_thermo: bool = True,
                               with_interp: bool = True,
                               with_ia: bool = True,
                               with_spread: bool = True,
                               neighbor_mode: Optional[str] = None,
                               contact_cap: int = 65536,
                               fused_block_n: int = 128,
                               fused_window: Optional[int] = None,
                               fused_fallback_cap: Optional[int] = None,
                               fused_fallback_strip_width: int = 64):
    """Persistent-sorted-layout coupling step run ``n_inner`` times.

    Returns ``multi(st, frc)`` giving the cell-sorted final state, or with
    ``with_stats`` ``(state, max_contact_overflow, max_contact_fallback,
    coupler_accumulator)``.  ``neighbor_mode`` is ``"fused3"`` (K2, the
    default) or ``"fused"`` (K5); ``cfg.interp_mode == "kernel"`` reads
    the environment through K6.  ``with_interp`` / ``with_ia`` /
    ``with_spread`` / ``with_thermo`` = False are measurement probes that
    drop a phase (``contact_cap`` is accepted for API parity; the fused
    searches are cap-free)."""
    if not cfg.interactive_icebergs_on or cfg.mts:
        raise ValueError("the persistent step needs interactive_icebergs_on "
                         "and no MTS")
    check_ported(cfg)
    if neighbor_mode is None:
        neighbor_mode = cfg.resolved_contact_mode()
        if neighbor_mode not in ("fused", "fused3"):
            neighbor_mode = "fused3"
    if neighbor_mode not in ("fused", "fused3"):
        raise ValueError(f"neighbor_mode={neighbor_mode!r}: the persistent "
                         "step runs the fused searches only")
    window = cfg.fused_window if fused_window is None else fused_window
    cap = (cfg.fused_fallback_cap if fused_fallback_cap is None
           else fused_fallback_cap)
    uniform = uniform_state_fields(cfg)
    skw = sort_kw(cfg)
    # the JAX lane's interpolation routing (model.py:470-476): K6 on
    # regular grids, the table, or (interp_mode "xla", coastal or tidal
    # drift, "kernel" on a curvilinear grid) interp_flds
    interp_ok = cfg.coastal_drift == 0. and cfg.tidal_drift == 0.
    if cfg.interp_mode == "kernel" and interp_ok and cfg.grid_is_regular:
        interp = interp_to_bergs_sorted
    elif cfg.interp_mode == "table" and interp_ok:
        interp = interp_to_bergs_table
    else:
        def interp(st, grid, frc, cfg):
            return interp_to_bergs(st, grid, frc, cfg), None
    # K3 and the deferred melt columns, or (other slot-sum methods,
    # hexagons) the slot sums on the presorted slab
    spread_kernel = _spread.uses_spread_kernel(cfg)
    nx, ny = grid.nx, grid.ny
    cell_table = cell_tables(grid) if with_spread else None

    def step(st, cell_starts, frc):
        m25_pre = None
        if with_interp:
            st, m25_pre = interp(st, grid, frc, cfg)
        if not with_ia:
            zero = torch.zeros((), dtype=torch.int32, device=st.device)
            ia_fn, fstats = None, FusedContactStats(zero, zero)
        elif neighbor_mode == "fused3":
            ia_fn, fstats = make_ia_fn_fused3(
                st, grid, cfg, block_n=fused_block_n, window=window,
                fallback_cap=cap,
                fallback_strip_width=fused_fallback_strip_width,
                presorted=True, cell_starts=cell_starts)
        else:
            ia_fn, fstats = make_ia_fn_fused(
                st, cell_starts, grid, cfg, block_n=fused_block_n,
                window=window, fallback_cap=cap,
                fallback_strip_width=fused_fallback_strip_width)
        out = evolve_icebergs(st, grid, frc, cfg, ia_fn=ia_fn,
                              m25_pre=m25_pre)
        st, cell_starts = sort_state_by_cell(out.state, grid,
                                             static_fields=uniform, **skw)
        # the slab is the (cell, id) frame: the reproducing sums need no
        # order; key_alive / the keys are pre-thermodynamics
        key_alive = st.alive
        sort_ctx = None
        if cfg.parallel_reprod and not spread_kernel:
            key_s = torch.where(st.alive, st.jne * nx + st.ine,
                                nx * ny).to(torch.int32)
            sort_ctx = (None, key_s, _spread.sorted_ranks(key_s, nx * ny))
        melt = None
        if with_thermo:
            st, melt = _thermo.thermodynamics(
                st, grid, frc, cfg, defer_cell_cols=spread_kernel,
                sort_ctx=sort_ctx)
        melt_fields = [None] * 3
        if melt is not None and melt.deferred_cols is None:
            melt_fields = [melt.floating_melt, None, melt.berg_melt]
        if not with_spread:
            sp = _zero_spread(st, grid)
        elif spread_kernel:
            # only floating_melt, calving_hflx and berg_melt of the 14
            # deferred melt columns are consumed by this step
            extra = melt.deferred_cols[:3] if melt is not None else None
            sp = _spread.create_gridded_icebergs_fields(
                st, grid, frc, cfg, key_alive=key_alive,
                cell_starts=cell_starts, extra_cell_cols=extra,
                cell_table=cell_table)
            if extra is not None:
                sp, melt_fields = sp
        else:
            sp = _spread.create_gridded_icebergs_fields(
                st, grid, frc, cfg, sort_ctx=sort_ctx)
        diags = StepDiags(
            nbergs=st.count(), tickets=out.tickets, bounced=out.bounced,
            total_mass=torch.where(st.alive, st.mass * st.mass_scaling,
                                   0.).sum(),
            contact_overflow=fstats.overflow,
            contact_fallback=fstats.n_fallback,
            floating_melt=melt_fields[0], berg_melt=melt_fields[2],
            spread_mass=sp.spread_mass, spread_area=sp.spread_area,
            spread_uvel=sp.spread_uvel, spread_vvel=sp.spread_vvel,
            ustar_iceberg=sp.ustar_iceberg, mass_on_ocean=sp.mass_on_ocean)
        return st, cell_starts, diags

    def multi(st, frc):
        if st.capacity >= 1 << 23:
            raise ValueError("capacity >= 2^23: sorted slots no longer "
                             "round-trip through float32")
        zero = torch.zeros((), dtype=torch.int32, device=st.device)
        ov, fb = zero, zero
        acc = torch.zeros(nx + 2, ny + 2, dtype=st.dtype, device=st.device)
        # the slab's first order is random: K1's row route (PERF.md)
        st, cs = sort_state_by_cell(st, grid, via_rows=True, **skw)
        for _ in range(n_inner):
            st, cs, d = step(st, cs, frc)
            ov = torch.maximum(ov, d.contact_overflow)
            fb = torch.maximum(fb, d.contact_fallback)
            # keep the coupler outputs, as the JAX scan carries them
            for f in (d.spread_mass, d.spread_area, d.ustar_iceberg,
                      d.mass_on_ocean, d.floating_melt):
                if f is not None:
                    acc = acc + f
        return (st, ov, fb, acc) if with_stats else st

    return multi


_PERSISTENT_KW = ("with_thermo", "with_spread", "neighbor_mode",
                  "contact_cap", "fused_block_n", "fused_window",
                  "fused_fallback_cap", "fused_fallback_strip_width")


def make_multi_step(grid: Grid, cfg: IcebergsConfig, n_inner: int,
                    with_stats: bool = False,
                    persistent: Optional[bool] = None, **kw):
    """``n_inner`` coupling steps with fixed forcing.  Routes eligible
    configurations (interactive, non-MTS, non-footloose, fused search,
    full thermodynamics and spreading, no calving) to
    :func:`make_persistent_multi_step` exactly as the JAX package does,
    and the rest, or any with ``persistent=False``, through
    :func:`make_step` (``kw``).

    ``with_stats=True`` returns ``(state, max overflow, max fallback,
    coupler accumulator)``; on the per-step path the overflow includes
    the MTS Part-1 drops and the accumulator sums the 8 coupler fields
    of ``model.py:686-690``.  The per-step path also keeps the last
    call's ``StepDiags`` in ``multi.step_diags``."""
    if persistent is None:
        nm = kw.get("neighbor_mode")
        nm = nm if nm is not None else (
            cfg.resolved_contact_mode()
            if cfg.interactive_icebergs_on else "buckets")
        persistent = (
            cfg.interactive_icebergs_on and not cfg.mts
            and not cfg.footloose
            and nm in ("fused", "fused3")
            and kw.get("with_thermo", True)
            and kw.get("with_spread", True)
            and not kw.get("with_calving", False)
            and kw.get("with_interactions") in (None, True)
            and all(k in _PERSISTENT_KW for k in kw))
    if persistent:
        return make_persistent_multi_step(
            grid, cfg, n_inner, with_stats,
            **{k: v for k, v in kw.items() if k in _PERSISTENT_KW})
    step = make_step(grid, cfg, **kw)
    nx, ny = grid.nx, grid.ny

    def multi(st, frc):
        zero = torch.zeros((), dtype=torch.int32, device=st.device)
        ov, fb = zero, zero
        acc = torch.zeros(nx + 2, ny + 2, dtype=st.dtype, device=st.device)
        multi.step_diags = []
        for _ in range(n_inner):
            st, d = step(st, frc)
            for o in (d.contact_overflow, d.p1_overflow):
                if o is not None:
                    ov = torch.maximum(ov, o)
            if d.contact_fallback is not None:
                fb = torch.maximum(fb, d.contact_fallback)
            # keep the coupler outputs, as the JAX scan carries them
            for f in (d.spread_mass, d.spread_area, d.ustar_iceberg,
                      d.mass_on_ocean, d.floating_melt, d.calving_hflx,
                      d.u_iceberg, d.v_iceberg):
                if f is not None:
                    acc = acc + f
            multi.step_diags.append(d)
        return (st, ov, fb, acc) if with_stats else st

    multi.step_diags = []
    return multi

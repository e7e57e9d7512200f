"""The coupled entry point: ``icebergs_init`` / ``icebergs_run`` /
``icebergs_stock_pe`` / ``icebergs_incr_mass`` (``src/icebergs.F90:65-66``).

Counterpart of ``icebergs_tpu/api.py`` (``ModelState``, ``RunOutputs``,
``prepare_forcing``, ``run_coupling_sequence``, ``IcebergsModel``); the
sequence is also a generator (:func:`coupling_sequence`) that the tiled
run drives tile by tile.
:class:`IcebergsModel` holds the grid, the config and what depends only
on them; the state (bergs, calving buckets, seed, step count and clock)
flows through :meth:`IcebergsModel.run`, one coupling step of the
reference's sequence (icebergs_run, icebergs.F90:5074-5889):

1. the interface (:func:`prepare_forcing`, called by the host model);
2. the calving buckets, then the spawn from full buckets;
3. the interpolation onto the bergs (``interp_flds``, with tidal drift);
4. evolve (Verlet or RK4 with the contact search of the config, or the
   MTS outer step);
5. footloose calving and its children's interactivity;
6. thermodynamics;
7. the gridded fields (K3 behind a payload sort);
8. the coupler returns and the budgets.

Randomness: the tidal drift's uniforms come from a ``torch.Generator``
on the state's device seeded from (seed, step), the footloose uniforms
from :func:`.footloose.id_hash_uniforms` of (seed, step); both plug in
per call.  An MTS configuration evolves by
:func:`.mts.evolve_icebergs_mts` as the JAX entry calls it: Part 1 on the
candidate tables (K7), the scan substeps; its diagnostics come back in
``RunOutputs.mts``.  :meth:`IcebergsModel.save_restart` writes the
restart triplet and :meth:`IcebergsModel.end` the trajectories
(:mod:`.io`).  A step makes no host sync but the MTS force-convergence
reads (one a Part-1 iteration).  On a CUDA device :meth:`IcebergsModel.run`
replays the step from CUDA graphs where it can (:mod:`.graphs`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from . import constants as C
from . import trace
from .calving import (CalvingState, accumulate_calving, calve_icebergs,
                      class_grids, get_running_mean_calving,
                      init_calving_state)
from .config import IcebergsConfig, check_ported
from .diag import Budgets, compute_budgets
from .dynamics import EvolveOut, evolve_icebergs
from .footloose import (adjust_fl_berg_interactivity,
                        delete_fully_fl_calved, footloose_calving,
                        id_hash_uniforms)
from .forcing import Forcing
from .graphs import StepGraphs
from .grid import Grid
from .model import run_sequence
from .mts import MtsDiags, evolve_icebergs_mts
from .ops import forces as _forces
from .ops import spread as _spread
from .ops import thermo as _thermo
from .ops.accel import divc
from .ops.fused_contact import make_ia_fn_fused2, make_ia_fn_fused3
from .ops.interp import interp_to_bergs
from .ops.segment_spread import cell_tables
from .ops.sorted import sort_kw, sort_state_by_cell, strip_neighbor_tables
from .state import BergState


@dataclasses.dataclass(frozen=True)
class ModelState:
    bergs: BergState
    calving: CalvingState
    seed: int                         # the run's random seed (host)
    step: int                         # coupling steps taken (host)
    current_year: torch.Tensor        # 0-dim int32
    current_yearday: torch.Tensor     # 0-dim float
    spread_mass_old: torch.Tensor     # the previous step's spread mass

    def replace(self, **kw) -> "ModelState":
        return dataclasses.replace(self, **kw)


class RunOutputs(NamedTuple):
    """The coupler return fields (icebergs_run's out arguments,
    icebergs.F90:5652-5679), halo-padded center fields, and the step's
    counters and interval-budget scalars (0-dim tensors)."""
    calving: torch.Tensor          # residual calving + melt, kg/s/m2
    calving_hflx: torch.Tensor     # W/m2
    floating_melt: torch.Tensor    # kg/m2/s
    berg_melt: torch.Tensor
    spread_mass: torch.Tensor
    spread_area: torch.Tensor
    spread_uvel: torch.Tensor
    spread_vvel: torch.Tensor
    ustar_iceberg: torch.Tensor
    mass_on_ocean: torch.Tensor
    nbergs: torch.Tensor
    budgets: Budgets
    # the fused searches' drops past the fallback cap and their fallback
    # rows (0 on the other neighbour modes)
    contact_overflow: Optional[torch.Tensor] = None
    contact_fallback: Optional[torch.Tensor] = None
    # bucket spawns and footloose children that found no dead slot (the
    # caller grows the slab between steps: state.grow_capacity)
    spawn_overflow: Optional[torch.Tensor] = None
    fl_spawn_overflow: Optional[torch.Tensor] = None
    tickets: Optional[torch.Tensor] = None
    nbergs_calved: Optional[torch.Tensor] = None
    nbergs_calved_fl: Optional[torch.Tensor] = None
    nbergs_melted: Optional[torch.Tensor] = None
    nbergs_deleted_fl: Optional[torch.Tensor] = None
    net_calving_used: Optional[torch.Tensor] = None    # kg into buckets
    heat_used: Optional[torch.Tensor] = None           # J into stored heat
    calving_to_bergs: Optional[torch.Tensor] = None    # kg to new bergs
    heat_to_bergs: Optional[torch.Tensor] = None       # J to new bergs
    net_melt_heat: Optional[torch.Tensor] = None       # J to the ocean
    net_melt_kg: Optional[torch.Tensor] = None
    berg_melt_kg: Optional[torch.Tensor] = None
    bergy_src_kg: Optional[torch.Tensor] = None
    bergy_melt_kg: Optional[torch.Tensor] = None
    fl_bits_melt_kg: Optional[torch.Tensor] = None
    flb_bergy_melt_kg: Optional[torch.Tensor] = None
    flb_internal_eros_kg: Optional[torch.Tensor] = None
    fl_bits_src: Optional[torch.Tensor] = None         # kg/m2/s
    fl_to_berg_kg: Optional[torch.Tensor] = None
    flb_to_bergy_kg: Optional[torch.Tensor] = None
    # the MTS outer step's diagnostics (not in the JAX RunOutputs)
    mts: Optional[MtsDiags] = None


def _edge_pad(u, d0: int, d1: int):
    """``jnp.pad(u, ((d0, d0), (d1, d1)), mode="edge")`` for d0, d1 in
    {0, 1}."""
    if d0:
        u = torch.cat([u[:1], u, u[-1:]], dim=0)
    if d1:
        u = torch.cat([u[:, :1], u, u[:, -1:]], dim=1)
    return u


def prepare_forcing(grid: Grid, cfg: IcebergsConfig, frc: Forcing, *,
                    vel_stagger: str = "B",
                    stress_stagger: str = "B") -> Forcing:
    """The interface (icebergs.F90:5236-5383): velocities from the "B"
    corners, "C" faces (u on east faces (nx+1, ny), v on north faces
    (nx, ny+1)) or "A" centers ((nx, ny) or halo-padded) onto the
    corners; the wind stress inverted to a wind speed unless
    ``tau_is_velocity``; a Kelvin SST detected and converted; NaNs
    scrubbed."""
    corners = (grid.nx + 1, grid.ny + 1)

    def a_to_corners(u):
        if tuple(u.shape) == corners:
            return u
        up = _edge_pad(u, 1, 1) if tuple(u.shape) == (grid.nx, grid.ny) \
            else u
        return 0.25 * (up[:-1, :-1] + up[1:, :-1] + up[:-1, 1:] + up[1:, 1:])

    def c_to_corners(u, component):
        if component == "u":                  # average along y
            up = _edge_pad(u, 0, 1)
            return 0.5 * (up[:, :-1] + up[:, 1:])
        up = _edge_pad(u, 1, 0)
        return 0.5 * (up[:-1, :] + up[1:, :])

    def vel(u, v, stagger):
        if stagger == "B":
            return u, v
        if stagger == "C":
            return c_to_corners(u, "u"), c_to_corners(v, "v")
        return a_to_corners(u), a_to_corners(v)

    uo, vo = vel(frc.uo, frc.vo, vel_stagger)
    ui, vi = vel(frc.ui, frc.vi, vel_stagger)
    ua, va = vel(frc.ua, frc.va, stress_stagger)
    if not cfg.tau_is_velocity:
        # invert_tau_for_du (icebergs.F90:8271-8296): |du| =
        # sqrt(|tau|/cd), cd 0.0015, no air density
        mag = torch.sqrt(ua * ua + va * va)
        cddvmod = torch.sqrt(0.0015 * mag)
        pos = cddvmod > 0.
        den = torch.where(pos, cddvmod, 1.)
        ua = torch.where(pos, ua / den, 0.)
        va = torch.where(pos, va / den, 0.)
    sst = torch.where(frc.sst.max() > 120.0, frc.sst - 273.15, frc.sst)

    def scrub(a):
        return torch.where(torch.isnan(a), 0., a)

    return Forcing(uo=scrub(uo), vo=scrub(vo), ui=scrub(ui), vi=scrub(vi),
                   ua=scrub(ua), va=scrub(va), ssh=scrub(frc.ssh),
                   sst=scrub(sst), sss=scrub(frc.sss), cn=scrub(frc.cn),
                   hi=scrub(frc.hi))


def tidal_generator_uniforms(seed: int, step: int, shape, *, dtype,
                             device):
    """The default tidal-drift uniforms on [-1, 1): a ``torch.Generator``
    on ``device`` seeded from (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + step) & 0x7FFFFFFFFFFFFFFF)
    return torch.rand(shape, generator=g, dtype=dtype, device=device) \
        * 2. - 1.


def run_coupling_sequence(cfg: IcebergsConfig, grid: Grid,
                          state: ModelState, frc: Forcing, calving,
                          calving_hflx, **kw):
    """One coupling step (icebergs.F90:5389-5679): buckets -> spawn ->
    interpolation -> evolve -> footloose -> thermodynamics -> gridded
    fields -> coupler returns.  Returns ``(state, RunOutputs)``; the
    keywords are :func:`coupling_sequence`'s."""
    return run_sequence(coupling_sequence(cfg, grid, state, frc, calving,
                                          calving_hflx, **kw))


def coupling_sequence(cfg: IcebergsConfig, grid: Grid, state: ModelState,
                      frc: Forcing, calving, calving_hflx, *,
                      nbr_radius: int, max_per_cell: int = 16,
                      neighbor_mode: Optional[str] = None,
                      fused_kw: Optional[dict] = None, tables=None,
                      cell_table=None, tidal_uniforms=None,
                      fl_uniforms: Optional[Callable] = None):
    """:func:`run_coupling_sequence` as a generator that returns ``(state,
    RunOutputs)``.  With contacts on it yields the berg state where bergs
    were just born and their neighbours are read next (after the bucket
    spawn; after the footloose children, before their interactivity) and
    takes back the state to go on with: a tiled run refreshes the halo
    copies there, so that a berg near a tile edge meets the neighbour
    tile's newborns as the untiled run does; one tile sends it back as
    it is.

    ``tables`` (:func:`.calving.class_grids`) and ``cell_table``
    (:func:`.ops.segment_spread.cell_tables`) depend on the grid and
    config alone (built here when not given); ``tidal_uniforms`` a (2, N)
    tensor on [-1, 1) and ``fl_uniforms`` a ``(stream, state) -> (N,)``
    callable replace the default random sources."""
    st, calv = state.bergs, state.calving
    if neighbor_mode is None:
        neighbor_mode = (cfg.resolved_contact_mode()
                         if cfg.interactive_icebergs_on else "buckets")
    year, yday = state.current_year, state.current_yearday

    # each phase is a span (:mod:`.trace`), closed before every yield
    # 2-3. the buckets, then the spawn from full buckets
    with trace.span("kid.calving"):
        calv, calving, calving_hflx = get_running_mean_calving(
            calv, calving, calving_hflx, cfg)
        calv, calving_res, hflx_res, used_kg, used_J = accumulate_calving(
            calv, grid, calving, calving_hflx, cfg, tables=tables)
        st, calv, calv_diag = calve_icebergs(
            st, calv, grid, frc, cfg, current_year=year,
            current_yearday=yday, tables=tables)
    if cfg.interactive_icebergs_on:
        st = yield st

    # 4. the environment on the bergs, with the tidal drift's uniforms
    with trace.span("kid.interp"):
        if cfg.tidal_drift > 0.:
            r = tidal_uniforms
            if r is None:
                r = tidal_generator_uniforms(
                    state.seed, state.step, (2, st.capacity),
                    dtype=st.dtype, device=st.device)
            st = interp_to_bergs(st, grid, frc, cfg, rx=r[0], ry=r[1])
        else:
            st = interp_to_bergs(st, grid, frc, cfg)

    # 5. evolve
    with trace.span("kid.contacts"):
        zi = torch.zeros((), dtype=torch.int32, device=st.device)
        fstats = mts_d = None
        ia_fn = None
        if cfg.interactive_icebergs_on and not cfg.mts:
            if neighbor_mode in ("fused", "fused3"):
                kw = dict(block_n=128, window=cfg.fused_window,
                          fallback_cap=cfg.fused_fallback_cap,
                          fallback_strip_width=64)
                kw.update(fused_kw or {})
                if neighbor_mode == "fused3":
                    ia_fn, fstats = make_ia_fn_fused3(st, grid, cfg,
                                                      presorted=False, **kw)
                else:
                    ia_fn, fstats = make_ia_fn_fused2(st, grid, cfg, **kw)
            else:
                if neighbor_mode == "sorted":
                    # a (cell, id)-sorted slab: layout-invariant pair sums
                    st, cs = sort_state_by_cell(st, grid, **sort_kw(cfg))
                    nbr = strip_neighbor_tables(st, grid, cfg, cs,
                                                ncells_radius=nbr_radius)
                else:
                    nbr = _forces.build_neighbor_tables(
                        st, grid, cfg, ncells_radius=nbr_radius,
                        max_per_cell=max_per_cell)
                ia_fn = _forces.make_ia_fn(st, nbr, cfg)
    with trace.span("kid.evolve"):
        if cfg.mts:
            st, mts_d = evolve_icebergs_mts(st, grid, frc, cfg,
                                            ncells_radius=nbr_radius)
            out = EvolveOut(st, zi, zi)
        else:
            out = evolve_icebergs(st, grid, frc, cfg, ia_fn=ia_fn)
    st = out.state

    # 6. footloose calving and the children's interactivity
    fl_diag = fl_deleted = None
    if cfg.footloose:
        with trace.span("kid.footloose"):
            if fl_uniforms is None:
                fl_uniforms = id_hash_uniforms(state.seed, state.step)
            st, fl_diag = footloose_calving(
                st, grid, cfg, uniforms=fl_uniforms, current_year=year,
                current_yearday=yday)
            st, fl_deleted = delete_fully_fl_calved(st)
        if cfg.interactive_icebergs_on:
            st = yield st
            with trace.span("kid.footloose"):
                if neighbor_mode in ("sorted", "fused", "fused3"):
                    # the fused modes too: the walk needs a candidate
                    # table, and the sorted strips are layout-invariant
                    st, cs2 = sort_state_by_cell(st, grid, **sort_kw(cfg))
                    nbr2 = strip_neighbor_tables(st, grid, cfg, cs2,
                                                 ncells_radius=nbr_radius)
                else:
                    nbr2 = _forces.build_neighbor_tables(
                        st, grid, cfg, ncells_radius=nbr_radius,
                        max_per_cell=max_per_cell)
                st = adjust_fl_berg_interactivity(st, nbr2, cfg)

    # 7. thermodynamics
    with trace.span("kid.thermo"):
        st, melt = _thermo.thermodynamics(st, grid, frc, cfg,
                                          defer_cell_cols=False)

    # 8. the gridded fields
    with trace.span("kid.spread"):
        sp = _spread.create_gridded_icebergs_fields(st, grid, frc, cfg,
                                                    cell_table=cell_table)
    with trace.span("kid.returns"):
        floating_melt, hflx_melt = melt.floating_melt, melt.calving_hflx
        if cfg.find_melt_using_spread_mass:
            # find_melt_using_spread_mass (icebergs.F90:3424-3440)
            floating_melt = torch.where(
                grid.area > 0., divc(state.spread_mass_old - sp.spread_mass,
                                     cfg.dt).clamp(min=0.), 0.)
            hflx_melt = floating_melt * C.HLF
        if (cfg.apply_thickness_cutoff_to_gridded_melt
                and cfg.melt_cutoff >= 0.):
            # apply_thickness_cutoff_to_gridded_melt (icebergs.F90:3471-3483)
            ave_thick = sp.spread_mass / (sp.spread_area
                                          * cfg.rho_bergs).clamp(min=1e-30)
            ave_draft = ave_thick * (cfg.rho_bergs / C.RHO_SEAWATER)
            thin = (sp.spread_area > 0.) & (
                (grid.ocean_depth - ave_draft) < cfg.melt_cutoff)
            floating_melt = torch.where(thin, 0., floating_melt)
            hflx_melt = torch.where(thin, 0., hflx_melt)

        # 9. the coupler returns: residual calving and the melt
        calving_out = calving_res + floating_melt * (grid.msk > 0.)
        hflx_out = hflx_res + hflx_melt
        outputs = RunOutputs(
            calving=calving_out, calving_hflx=hflx_out,
            floating_melt=floating_melt, berg_melt=melt.berg_melt,
            spread_mass=sp.spread_mass, spread_area=sp.spread_area,
            spread_uvel=sp.spread_uvel, spread_vvel=sp.spread_vvel,
            ustar_iceberg=sp.ustar_iceberg, mass_on_ocean=sp.mass_on_ocean,
            nbergs=st.count(), budgets=compute_budgets(st, calv),
            contact_overflow=fstats.overflow if fstats is not None else zi,
            contact_fallback=fstats.n_fallback if fstats is not None else zi,
            spawn_overflow=calv_diag["spawn_overflow"],
            fl_spawn_overflow=(fl_diag.spawn_overflow if fl_diag is not None
                               else zi),
            tickets=out.tickets, nbergs_calved=calv_diag["nbergs_calved"],
            nbergs_calved_fl=(fl_diag.nbergs_calved_fl if fl_diag is not None
                              else None),
            nbergs_melted=melt.nbergs_melted, nbergs_deleted_fl=fl_deleted,
            net_calving_used=used_kg, heat_used=used_J,
            calving_to_bergs=calv_diag["calving_to_bergs"],
            heat_to_bergs=calv_diag["heat_to_bergs"],
            net_melt_heat=melt.net_heat, net_melt_kg=melt.net_melt_kg,
            berg_melt_kg=melt.berg_melt_kg, bergy_src_kg=melt.bergy_src_kg,
            bergy_melt_kg=melt.bergy_melt_kg,
            fl_bits_melt_kg=melt.fl_bits_melt_kg,
            flb_bergy_melt_kg=melt.flb_bergy_melt_kg,
            flb_internal_eros_kg=melt.flb_internal_eros_kg,
            fl_bits_src=fl_diag.fl_bits_src if fl_diag is not None else None,
            fl_to_berg_kg=(fl_diag.fl_to_berg_kg if fl_diag is not None
                           else None),
            flb_to_bergy_kg=(fl_diag.flb_to_bergy_kg if fl_diag is not None
                             else None), mts=mts_d)
        state = state.replace(bergs=st, calving=calv, step=state.step + 1,
                              current_yearday=yday + cfg.dt / 86400.,
                              spread_mass_old=sp.spread_mass)
        return state, outputs


class IcebergsModel:
    """icebergs_init: the grid and the config bound, with what depends on
    them alone (the contact radius, the calving class tables, the
    spreading's cell table).  Runs on ``device`` (CUDA by default; pass a
    CPU device to run the plain versions of the kernels)."""

    def __init__(self, grid: Grid, cfg: IcebergsConfig, *,
                 max_per_cell: int = 16,
                 neighbor_mode: Optional[str] = None,
                 fused_kw: Optional[dict] = None, device=None):
        check_ported(cfg)
        self.device = torch.device("cuda" if device is None else device)
        self.cfg = cfg
        self.max_per_cell = max_per_cell
        self.neighbor_mode = neighbor_mode
        self.fused_kw = fused_kw
        with trace.span("kid.model_init"):
            self.grid = grid.to(self.device)
            self._nbr_radius = _forces.neighbor_radius(self.grid, cfg)
            self._tables = class_grids(self.grid, cfg)
            self._cell_table = cell_tables(self.grid)
        self._graphs = StepGraphs(self)

    # -- lifecycle ---------------------------------------------------------

    def init_state(self, bergs: BergState, seed: int = 0, year: int = 0,
                   yearday: float = 0.) -> ModelState:
        dev = self.device
        with trace.span("kid.init_state"):
            bergs = bergs.to(dev)
            return ModelState(
                bergs=bergs,
                calving=init_calving_state(self.grid, bergs.dtype),
                seed=int(seed), step=0,
                current_year=torch.full((), year, dtype=torch.int32,
                                        device=dev),
                current_yearday=torch.full((), yearday, dtype=bergs.dtype,
                                           device=dev),
                spread_mass_old=torch.zeros(
                    self.grid.nx + 2, self.grid.ny + 2, dtype=bergs.dtype,
                    device=dev))

    def run(self, state: ModelState, frc: Forcing, calving=None,
            calving_hflx=None, *, tidal_uniforms=None, fl_uniforms=None):
        """One coupling step; returns ``(state, RunOutputs)``.
        ``calving`` (kg/s per cell) and ``calving_hflx`` (W/m2) are
        halo-padded center fields, zeros when not given.  The step is the
        span ``kid.run``, its phases the spans inside it (:mod:`.trace`).
        On a CUDA device the step replays from captured graphs where
        nothing it reads on the host changes from step to step
        (:mod:`.graphs`); the results are the eager step's bits."""
        with trace.span("kid.run", step=True):
            return self._graphs.run(state, frc, calving, calving_hflx,
                                    tidal_uniforms, fl_uniforms)

    def _sequence(self, state, frc, calving, calving_hflx, tidal_uniforms,
                  fl_uniforms):
        """The eager step: what :mod:`.graphs` captures."""
        shape = (self.grid.nx + 2, self.grid.ny + 2)
        dt, dev = state.bergs.dtype, state.bergs.device
        if calving is None:
            calving = torch.zeros(shape, dtype=dt, device=dev)
        if calving_hflx is None:
            calving_hflx = torch.zeros(shape, dtype=dt, device=dev)
        return run_coupling_sequence(
            self.cfg, self.grid, state, frc, calving, calving_hflx,
            nbr_radius=self._nbr_radius, max_per_cell=self.max_per_cell,
            neighbor_mode=self.neighbor_mode, fused_kw=self.fused_kw,
            tables=self._tables, cell_table=self._cell_table,
            tidal_uniforms=tidal_uniforms, fl_uniforms=fl_uniforms)

    # -- coupler queries ---------------------------------------------------

    def stock_pe(self, state: ModelState):
        """Water and heat stocks (icebergs_stock_pe,
        icebergs.F90:8102-8133), 0-dim tensors."""
        b = compute_budgets(state.bergs, state.calving)
        water = b.mass + b.mass_of_bits + b.stored_ice
        return water, -(water * C.HLF)   # frozen water: negative latent heat

    def incr_mass(self, state: ModelState, mass_field, frc: Forcing):
        """Add the spread berg weight to an ocean mass field
        (icebergs_incr_mass, icebergs.F90:6046-6075)."""
        if self.cfg.passive_mode or not self.cfg.add_weight_to_ocean:
            return mass_field
        sp = _spread.create_gridded_icebergs_fields(
            state.bergs, self.grid, frc, self.cfg,
            cell_table=self._cell_table)
        return mass_field + sp.spread_mass

    def save_restart(self, state: ModelState, directory: str = "."):
        """Write the restart triplet (icebergs_save_restart):
        icebergs.res.nc, bonds_iceberg.res.nc with bonds on, and
        calving.res.nc, into ``directory``."""
        import os
        from .io import restart as rio
        os.makedirs(directory, exist_ok=True)
        rio.write_restart_bergs(os.path.join(directory, "icebergs.res.nc"),
                                state.bergs, self.cfg)
        if self.cfg.iceberg_bonds_on:
            rio.write_restart_bonds(
                os.path.join(directory, "bonds_iceberg.res.nc"),
                state.bergs, self.cfg)
        rio.write_restart_calving(
            os.path.join(directory, "calving.res.nc"), state.calving,
            self.grid)

    def end(self, state: ModelState, directory: str = ".",
            traj_buffer=None):
        """icebergs_end: drain ``traj_buffer`` (an
        :class:`.io.trajectory.TrajBuffer`) to the trajectory file in
        ``directory`` unless ``ignore_traj``, and return the final
        budgets."""
        if traj_buffer is not None and not self.cfg.ignore_traj:
            import os
            from .io import trajectory as tio
            tio.write_trajectories(
                os.path.join(directory, self.cfg.traj_name), traj_buffer,
                self.cfg)
        return compute_budgets(state.bergs, state.calving)

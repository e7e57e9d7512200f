"""Run-time configuration mirroring the reference namelist ``icebergs_nml``.

A copy of ``icebergs_tpu/config.py`` with the same field names and
defaults (``icebergs_tpu.config`` cannot be imported without jax), so a
JAX config carries across as ``IcebergsConfig(**dataclasses.asdict(c))``
(:func:`icebergs_tpu_torch.convert.config_from_dict`).

:func:`check_ported` rejects the values of the string settings that name
no backend; every setting of the JAX package is served.  The step
factories call it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

NCLASSES = 10  # number of calving classes (icebergs_framework.F90:55)

# Gladstone et al 2001 Southern-hemisphere calving class tables
# (icebergs_framework.F90:787-796)
_INITIAL_MASS_S = (8.8e7, 4.1e8, 3.3e9, 1.8e10, 3.8e10, 7.5e10, 1.2e11,
                   2.2e11, 3.9e11, 7.4e11)
_DISTRIBUTION_S = (0.24, 0.12, 0.15, 0.18, 0.12, 0.07, 0.03, 0.03, 0.03, 0.02)
_MASS_SCALING_S = (2000., 200., 50., 20., 10., 5., 2., 1., 1., 1.)
_INITIAL_THICKNESS_S = (40., 67., 133., 175., 250., 250., 250., 250., 250., 250.)
# Bigg et al 1997 Northern-hemisphere tables (icebergs_framework.F90:798-803)
_INITIAL_MASS_N = (4.58e8, 3.61e9, 1.22e10, 2.91e10, 5.09e10, 7.34e10,
                   1.15e11, 1.65e11, 2.94e11, 5.59e11)
_DISTRIBUTION_N = (0.14, 0.15, 0.20, 0.15, 0.08, 0.07, 0.05, 0.05, 0.05, 0.05)
_MASS_SCALING_N = (200., 50., 25., 13., 8., 5., 2., 1., 1., 1.)
_INITIAL_THICKNESS_N = (80.4, 159.5, 240., 320., 360., 360., 360., 360., 360., 360.)


@dataclasses.dataclass(frozen=True)
class IcebergsConfig:
    """All ``icebergs_nml`` parameters (reference names & defaults)."""

    # --- core numerics -----------------------------------------------------
    dt: float = 3600.0                 # coupling time step (s) - init argument
    halo: int = 4
    rho_bergs: float = 850.0
    Rearth: float = 6360000.0
    Lx: float = 360.0                  # x-periodicity length (360 for latlon)
    grid_is_latlon: bool = True
    grid_is_regular: bool = True
    lat_ref: float = 0.0
    use_f_plane: bool = False

    # --- time stepping ------------------------------------------------------
    Runge_not_Verlet: bool = True
    use_new_predictive_corrective: bool = False
    speed_limit: float = 0.0
    static_icebergs: bool = False      # "Static_icebergs" in namelist
    override_iceberg_velocities: bool = False
    u_override: float = 0.0
    v_override: float = 0.0

    # --- interactions / bonds ----------------------------------------------
    interactive_icebergs_on: bool = False
    iceberg_bonds_on: bool = False
    max_bonds: int = 6
    spring_coef: float = 1.0e-8
    contact_spring_coef: float = 0.0   # 0 -> defaults to spring_coef at init
    bond_coef: float = 1.0e-8
    radial_damping_coef: float = 1.0e-4
    tangental_damping_coef: float = 2.0e-5
    critical_interaction_damping_on: bool = True
    tang_crit_int_damp_on: bool = True
    scale_damping_by_pmag: bool = True
    only_interactive_forces: bool = False
    hexagonal_icebergs: bool = False
    contact_distance: float = 0.0
    constant_interaction_LW: bool = False
    constant_length: float = 0.0
    constant_width: float = 0.0
    internal_bergs_for_drag: bool = False
    manually_initialize_bonds: bool = False
    length_for_manually_initialize_bonds: float = 1000.0
    manually_initialize_bonds_from_radii: bool = False

    # --- MTS (multiple time stepping, Huth et al 2022b) ----------------------
    mts: bool = False
    mts_sub_steps: int = -1            # -1 -> auto: ceil(dt / mts_fast_dt)
    force_convergence: bool = False
    convergence_tolerance: float = 1.0e-8
    explicit_inner_mts: bool = False
    skip_first_outer_mts_step: bool = False
    short_step_mts_grounding: bool = False
    remove_unused_bergs: bool = True
    ewsame: bool = False
    # TPU-framework knob (no reference namelist equivalent): velocity
    # factor of the frozen substep-pair-list skin prefilter
    # (mts.compact_conglom_pairs); <= 0 disables the prefilter and keeps
    # every same-conglomerate candidate pair
    mts_pair_skin: float = 4.0

    # --- DEM (bonded-particle model, Huth et al 2022b) -----------------------
    dem: bool = False
    poisson: float = 0.3
    dem_spring_coef: float = 0.0
    dem_damping_coef: float = 0.1
    fracture_criterion: str = 'none'   # 'stress' or 'none'
    frac_thres_n: float = 0.0
    frac_thres_t: float = 0.0
    frac_thres_scaling: float = 1.0
    ignore_tangential_force: bool = False
    use_broken_bonds_for_substep_contact: bool = False
    orig_dem_moment_of_inertia: bool = False
    break_bonds_on_sub_steps: bool = False
    no_frac_first_ts: bool = False
    use_grounding_torque: bool = False
    radius_based_drag: bool = False
    dem_beam_test: int = 0             # 1=simply-supported, 2=cantilever
    print_fracture: bool = True
    save_bond_forces: bool = True

    # --- grounding ------------------------------------------------------------
    cdrag_grounding: float = 0.0
    h_to_init_grounding: float = 100.0
    grounding_fraction: float = 0.0
    read_ocean_depth_from_file: bool = False

    # --- thermodynamics -------------------------------------------------------
    use_operator_splitting: bool = True
    bergy_bit_erosion_fraction: float = 0.0
    sicn_shift: float = 0.0
    LoW_ratio: float = 1.5
    melt_icebergs_as_ice_shelf: bool = False
    Use_three_equation_model: bool = True
    use_mixed_melting: bool = False
    use_mixed_layer_salinity_for_thermo: bool = False
    const_gamma: bool = True
    Gamma_T_3EQ: float = 0.022
    cdrag_icebergs: float = 1.5e-3
    utide_icebergs: float = 0.0
    ustar_icebergs_bg: float = 0.001
    melt_cutoff: float = -1.0
    apply_thickness_cutoff_to_gridded_melt: bool = False
    apply_thickness_cutoff_to_bergs_melt: bool = False
    set_melt_rates_to_zero: bool = False
    Iceberg_melt_without_decay: bool = False
    find_melt_using_spread_mass: bool = False
    allow_bergs_to_roll: bool = True
    use_updated_rolling_scheme: bool = False
    tip_parameter: float = 0.0

    # --- mass spreading / coupling ---------------------------------------------
    add_weight_to_ocean: bool = True
    passive_mode: bool = False
    time_average_weight: bool = False
    use_old_spreading: bool = True
    rotate_icebergs_for_mass_spreading: bool = True
    initial_orientation: float = 0.0
    add_iceberg_thickness_to_SSH: bool = False
    pass_fields_to_ocean_model: bool = False
    tau_is_velocity: bool = False
    ocean_drag_scale: float = 1.0
    clipping_depth: float = 0.0

    # --- calving -----------------------------------------------------------------
    initial_mass: Tuple[float, ...] = _INITIAL_MASS_S
    distribution: Tuple[float, ...] = _DISTRIBUTION_S
    mass_scaling: Tuple[float, ...] = _MASS_SCALING_S
    initial_thickness: Tuple[float, ...] = _INITIAL_THICKNESS_S
    separate_distrib_for_n_hemisphere: bool = False
    initial_mass_n: Tuple[float, ...] = _INITIAL_MASS_N
    distribution_n: Tuple[float, ...] = _DISTRIBUTION_N
    mass_scaling_n: Tuple[float, ...] = _MASS_SCALING_N
    initial_thickness_n: Tuple[float, ...] = _INITIAL_THICKNESS_N
    input_freq_distribution: bool = False
    tau_calving: float = 0.0
    make_calving_reproduce: bool = False

    # --- footloose calving (Huth et al 2022a) --------------------------------------
    footloose: bool = False
    fl_youngs: float = 1.0e7
    fl_strength: float = 250.0
    fl_style: str = 'new_bergs'        # 'new_bergs' | 'fl_bits' | 'bergy_bits' | 'mean_size'
    displace_fl_bergs: bool = True
    fl_bits_erosion_to_bergy_bits: bool = True
    new_berg_from_fl_bits_mass_thres: float = 1.0e12
    fl_init_child_xy_by_pe: bool = False

    # --- drift parameterizations ------------------------------------------------------
    coastal_drift: float = 0.0
    tidal_drift: float = 0.0

    # --- trajectories / diagnostics -----------------------------------------------------
    traj_sample_hrs: float = 24.0
    traj_write_hrs: float = 480.0
    verbose_hrs: float = 24.0
    traj_area_thres: float = 0.0
    traj_area_thres_fl: float = 1.0e9
    # class-filtered trajectory saving (framework:763-766, 688;
    # used in record_posn framework:5370-5388)
    save_all_traj_year: float = 1.0e30   # huge(0.0) default
    save_nonfl_traj_by_class: bool = False
    save_traj_by_class_start_mass_thres_n: float = 0.0
    save_traj_by_class_start_mass_thres_s: float = 0.0
    traj_area_thres_sntbc: float = 0.0
    save_short_traj: bool = True
    save_fl_traj: bool = True
    save_bond_traj: bool = False
    ignore_traj: bool = False
    debug_write: bool = False
    traj_name: str = 'iceberg_trajectories.nc'
    bond_traj_name: str = 'bond_trajectories.nc'
    # every PE writes trajectories (io-tile gather bypass); our tiled
    # writer emits one file per device tile either way
    force_all_pes_traj: bool = False
    # legacy pre-fms2 restart format switch (accepted for config parity;
    # the old single-file format itself is not implemented)
    read_old_restarts: bool = False

    # --- bug-compat switches (must be honored for chksum parity) -----------------------------
    old_bug_bilin: bool = True             # icebergs_framework.F90:38
    old_bug_rotated_weights: bool = False
    use_old_spreading_flag_unused: bool = False
    use_roundoff_fix: bool = True
    old_interp_flds_order: bool = False
    rev_mind: bool = False
    parallel_reprod: bool = True
    # static per-cell slot count for the fixed-tree reproducing scatters
    # (ops/spread.scatter9_slots); cells denser than this still sum
    # exactly but through a per-program-deterministic overflow pass
    reprod_max_per_cell: int = 16
    use_slow_find: bool = True

    # --- restart ---------------------------------------------------------------------------------
    restart_input_dir: str = 'INPUT/'
    require_restart: bool = False
    ignore_missing_restart_bergs: bool = False
    ignore_ij_restart: bool = False
    fix_restart_dates: bool = True
    generate_test_icebergs: bool = False
    orig_read: bool = False

    # --- TPU fast-lane backends (framework knobs; NOT reference namelist) ----
    # Production defaults = the round-4 winning "p3tabk" bench
    # configuration, promoted to the model/driver default (round-5,
    # VERDICT r4 #3).  Every switch selects among BITWISE-equivalent
    # implementations of the same reduction trees — changing them never
    # changes results, only speed.  This package serves the production
    # values (and every value of the bitwise-twin window feeds
    # extract_impl / spread_impl); check_ported rejects the rest.
    contact_mode: str = "auto"       # auto|fused3|fused|sorted|buckets:
    #   "auto" -> the fused3 extraction-kernel search when the config is
    #   eligible (legacy contact dispatch, interactions on, not MTS),
    #   else the bucket-table search
    sort_packed_permute: bool = True  # re-sort transport: key-only
    #   4-operand sort + packed u32 row gathers (vs ~50-operand
    #   variadic payload sort)
    pack_kernel: bool = True         # block-transpose pack/unpack
    #   around packed row gathers (the port's K1 moves the columns in
    #   one pass; False: a stacked row gather and per-row inverse
    #   gathers, the same bits)
    interp_mode: str = "table"       # table|kernel|xla: "table" = ONE
    #   packed (N, <=128-lane) row gather of a per-cell slot table +
    #   identical per-berg math (regular grids; falls back to "xla"
    #   when the config is ineligible)
    interp_gathered: bool = False    # "kernel" sub-switch (gathered
    #   window materialization)
    slot_sum_method: str = "pallas"  # spreading/melt slot-sum backend:
    #   pallas|scatter|scatter_t|gather|gather_raw|gather_mm ("pallas" =
    #   payload sort + MXU segment-sum kernel; non-eligible configs use
    #   "scatter")
    extract_impl: str = "gathered"   # contact extraction kernel window
    #   feed: gathered|manual|pipelined
    spread_impl: str = "manual"      # pallas spread kernel window feed:
    #   manual|gathered|pipelined
    starts_via_scatter: bool = False  # cell_starts: searchsorted vs
    #   scatter-min + reverse cummin (the same values)
    contact_epilogue: bool = False   # run the velocity-independent pair
    #   precompute (geometry/spring/projections) INSIDE the extraction
    #   kernel instead of the XLA chain.  Engagement is then decided by
    #   the kernel's own f32 rounding (~1 ulp from the XLA chain at the
    #   r == crit boundary), so flipping this regenerates goldens;
    #   cross-layout invariance is preserved (same kernel, any layout)
    fused_window: int = 160          # extraction-kernel window rows
    fused_fallback_cap: int = 1024   # exact-fallback compaction cap
    #   (growable: driver/bench grow on overflow evidence and re-run)

    # --- debugging -----------------------------------------------------------------------------------
    debug: bool = False
    really_debug: bool = False
    verbose: bool = False
    budget: bool = True
    do_unit_tests: bool = False
    halo_debugging: bool = False
    debug_iceberg_with_id: int = -1
    A68_test: bool = False
    A68_xdisp: float = 0.0
    A68_ydisp: float = 0.0

    # ------------------------------------------------------------------ derived
    @property
    def contact_spring_coef_eff(self) -> float:
        """contact_spring_coef defaults to spring_coef (framework init)."""
        return self.contact_spring_coef if self.contact_spring_coef != 0.0 else self.spring_coef

    @property
    def mts_fast_dt(self) -> float:
        """MTS inner step: 0.3/sqrt(spring_coef) (icebergs_framework.F90:1297)."""
        k = self.dem_spring_coef if (self.dem and self.dem_spring_coef > 0.) else self.spring_coef
        return 0.3 / math.sqrt(k)

    @property
    def n_sub_steps(self) -> int:
        """Number of MTS substeps (auto-sized unless mts_sub_steps >= 0)."""
        if self.mts_sub_steps >= 0:
            return self.mts_sub_steps
        return int(math.ceil(self.dt / self.mts_fast_dt))

    @property
    def radial_damping_eff(self) -> float:
        if self.critical_interaction_damping_on:
            return 2.0 * math.sqrt(self.spring_coef)
        return self.radial_damping_coef

    @property
    def tangental_damping_eff(self) -> float:
        if self.critical_interaction_damping_on and self.tang_crit_int_damp_on:
            return 2.0 * math.sqrt(self.spring_coef) / 4.0
        return self.tangental_damping_coef

    @property
    def n_max_bonds_shape(self) -> float:
        """Max bonds by packing shape: 6 hexagonal, 4 square."""
        return 6.0 if self.hexagonal_icebergs else 4.0

    @property
    def legacy_contact_dispatch(self) -> bool:
        """True when the contact force uses the legacy all-pairs spring
        (no MTS / contact_distance / separate contact spring) — the
        regime the fused extraction-kernel search covers."""
        return not (self.mts or self.contact_distance > 0.0
                    or self.contact_spring_coef_eff != self.spring_coef)

    @property
    def slot_sum_method_eff(self) -> str:
        """slot_sum_method with "pallas" mapped to its non-kernel
        fallback for call sites below the kernel dispatch level."""
        m = self.slot_sum_method
        return "scatter" if m == "pallas" else m

    def resolved_contact_mode(self) -> str:
        """Map ``contact_mode="auto"`` to a concrete neighbor mode."""
        if self.contact_mode != "auto":
            return self.contact_mode
        if self.interactive_icebergs_on and self.legacy_contact_dispatch:
            return "fused3"
        return "buckets"

    def replace(self, **kw) -> "IcebergsConfig":
        return dataclasses.replace(self, **kw)

    def normalized(self, warn: bool = True) -> "IcebergsConfig":
        """Apply the reference's init-time coercions
        (icebergs_framework.F90:1290-1440): MTS forces Verlet stepping;
        DEM forces explicit inner substeps; DEM requires bonds+interactions.
        """
        import warnings
        cfg = self
        if cfg.mts and cfg.Runge_not_Verlet:
            if warn:
                warnings.warn("MTS does not work with Runge-Kutta; "
                              "switching to Verlet (reference behavior)")
            cfg = cfg.replace(Runge_not_Verlet=False)
        if cfg.dem and not cfg.explicit_inner_mts:
            cfg = cfg.replace(explicit_inner_mts=True)
        if cfg.dem and not (cfg.iceberg_bonds_on
                            and cfg.interactive_icebergs_on):
            if warn:
                warnings.warn("DEM requires iceberg_bonds_on and "
                              "interactive_icebergs_on; enabling both")
            cfg = cfg.replace(iceberg_bonds_on=True,
                              interactive_icebergs_on=True)
        if cfg.use_broken_bonds_for_substep_contact and not (
                cfg.dem and cfg.iceberg_bonds_on):
            raise ValueError("use_broken_bonds_for_substep_contact requires "
                             "dem and iceberg_bonds_on (reference FATAL)")
        return cfg


_SLOT_SUM_METHODS = ("pallas", "scatter", "scatter_t", "gather",
                     "gather_raw", "gather_mm")


def check_ported(cfg: IcebergsConfig) -> None:
    """Raise ``ValueError`` for a string setting whose value names no
    backend (every setting of the JAX package is served)."""
    if cfg.interp_mode not in ("table", "kernel", "xla"):
        raise ValueError(f"interp_mode={cfg.interp_mode!r}")
    if cfg.slot_sum_method not in _SLOT_SUM_METHODS:
        raise ValueError(f"slot_sum_method={cfg.slot_sum_method!r}")
    if cfg.extract_impl not in ("gathered", "manual", "pipelined"):
        raise ValueError(f"extract_impl={cfg.extract_impl!r}")
    if cfg.spread_impl not in ("gathered", "manual", "pipelined"):
        raise ValueError(f"spread_impl={cfg.spread_impl!r}")

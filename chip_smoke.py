#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``icebergs_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--profile-out DIR]

Phases, one line each:

1. environment: a CUDA device must be present (exit 1 otherwise); prints
   the card's name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from ``icebergs_tpu_torch/csrc``
   and prints each kernel's registers and spills;
3. kernels: K1 at every shape a path gives it (the first sort, the
   persistent re-sort, the table gather by sorted, unsorted and DEM keys,
   the sorted views' moves and their inverses, the spread's row sort,
   the DEM refresh) through both routes (the column list, the row route)
   beside ``index_select``, with the kernels' registers, spills and CTAs
   per SM, K2 (contact extraction; the generic instantiation timed
   beside the compiled one, with each one's registers, spills and CTAs
   per SM), K3 (spread segment sums at 3 and 14 payload columns, in the
   sequential association and, at a forced 128-row window, the slot
   tree; the window_bad count and the association the headline slab
   takes), K5 (the prepass search, its bad flags too; K3's and K5's
   instantiations timed against the generic ones, with their registers,
   spills, shared memory and CTAs per SM), K6 (the sorted-frame
   interpolation), K2's pair-epilogue instantiation (every row but the
   spring sums bitwise, the spring sums bitwise on rows with at most two
   exact pairs, the others counted; two calls bitwise), K3's pass-through
   at the slot scatter spreading's 43 columns (slot tree and sequential)
   and the melt's 14 (slot tree), bitwise, one launch a call, beside
   ``torch.segment_reduce``, and K7
   (the pair evaluation over the bucket tables, max_per_cell 24; both pmag instantiations, bitwise on the rows with
   at most two active pairs and from run to run, with their registers,
   spills, shared memory and CTAs per SM) at the shapes the headline
   world gives them, and K2 with the conglomerate filter (radius 2,
   block 256, window 512) and K4 (the DEM substep loop, 60 substeps;
   the compiled ``dem`` instantiation and the generic one bitwise and
   timed in turns, the generic one also with constant_interaction_LW
   off, with each instantiation's registers, spills, shared memory, CTAs
   per SM and SASS instructions a slot and an element, and the
   issue-limited time they give) at the shapes of the 1M-element DEM
   world, each against its plain PyTorch version on the card.  Each
   kernel's ``ms`` is the device time of one wrapper call with the
   host's enqueueing hidden (``device_ms``), the call's time with the
   host in its note; plain and library times are CUDA-event means; the
   bound is computed from the inputs;
4. cross-check: a 50k-berg world runs 2 steps on the card and, with the
   plain versions, on a CPU copy; integer outputs must match exactly,
   floats within a stated tolerance;
4c. the same cross-check for the per-step ``buckets`` path with K7 and
   the persistent ``fused`` lane with the kernel interpolation;
4b. DEM cross-check: 20 conglomerates of 22x22 elements, 2.5-3.5 km
   apart, run one MTS outer step on the card and on a CPU copy; ids,
   cells, bond tables and the MTS counters must match exactly, floats
   within a stated tolerance;
5. the slice: the headline world of ``bench.py`` (1M bergs, 512x512 grid
   of 2 km cells, contacts, melt, rolling, reproducible spreading, swirl
   forcing) through ``make_multi_step`` for 8 steps after a warm-up,
   timed over 3 windows, with every kernel's launch count;
6. the DEM slice: the world of ``tools/bench_dem_1m.py`` (2066
   conglomerates of 22x22 bonded elements, 999,944 in all, 512x512 grid
   of 7 km cells, dt 600 s, 60 substeps) packed one conglomerate per
   512-slot block, through ``make_multi_step`` with the substep kernel,
   2 outer steps per window after a warm-up, timed over 3 windows, and
   the window_bad count and association K3 takes on its final state;
7. the per-step slice: the headline world through
   ``make_multi_step(persistent=False)`` with the ``fused3``, ``fused``
   and ``buckets`` (max_per_cell 24, K7) neighbour modes, 8 steps per
   window, 3 windows each; the largest cell occupancy must stay within
   max_per_cell before the first step, before the last and after it;
8. the persistent lane with ``neighbor_mode="fused"`` and
   ``interp_mode="kernel"`` (K5, K6) on the headline world, timed as in 5;
9. the options of ROADMAP item 15 on the headline world, each timed as in
   5 after a card-against-CPU cross-check of its configuration on the
   phase-4 world: 9a the fast lane with RK4 and K2's pair epilogue; 9b
   the fast lane with the three transport knobs and the slot scatter
   spreading (its state after 8 steps must equal phase 5's bit for bit,
   its coupler fields within a stated tolerance); 9c the per-step fused3
   path with the XLA interpolation, ``parallel_reprod=False`` and the
   class melt;
10. ROADMAP item 9: 10a the coupled entry ``IcebergsModel.run`` (calving
   buckets and spawning, footloose children, the budgets) on the headline
   world in a 2^20-slot slab with a calving ring, primed buckets and
   primed tabular bergs: bucket and footloose spawns in every window,
   every overflow counter 0, 0 host syncs per ``run``, the budgets
   closed; 10b the per-step ``sorted`` neighbour mode (K1, K7) with the
   largest cell within ``max_per_cell``; 10c the legacy bonded springs
   outside MTS on phase 6's 999,944-element world (per-step fused3 with
   the bond group through K7 at M = max_bonds, dt 60 s), every float
   finite.  Each first runs card against CPU on a 50k-berg world, then is
   timed as phase 5 is;
11. ROADMAP item 16, the MTS scan substep path on phase 6's world, each
   timed as phase 6 is with a profiled outer step: 11a the scan on K4's
   flag set (fused Part 1: K1, grouped K2; K3 spreading), beside the
   scan against K4 after one outer step field by field; 11b the
   reference's substep contact (no per-substep fracture, the frozen pair
   list sized by ``auto_pair_cap`` and doubled while it overflows); 11c
   ``IcebergsModel.run`` with MTS (Part 1 on the candidate tables: K7
   at M = 400), budgets closed, on K4's flags and on the reference's
   defaults (11c dense: the substep contact over the (N, 400)
   candidates, as the entry passes no pair cap; windows of one run);
   then K7 at M = 400 on the same conglomerates packed 2.5 km apart,
   and K1 at the Part-1 refresh's shape; 11d card against CPU on phase
   4b's world (11a-11c, the pair list itself, its contact sums bit for
   bit from run to run, one substep's forces within 1e-5, the scan
   against K4 within 5e-6 of scale) and on the input_MTS_KID.nml world
   (substeps without DEM, explicit and implicit; one host sync per
   convergence iteration);
12. ROADMAP item 11, lat-lon and curvilinear grids at full width, each
   timed as its Cartesian counterpart with a profiled window: 12a the
   fast lane (K2 lat-lon) and the persistent ``fused`` lane with K6 (K5
   lat-lon) on a 0.25-degree lat-lon grid of 1440 x 160 cells with 1M
   bergs; 12b ``IcebergsModel.run`` on the 1440 x 1080 tripolar grid
   (OM4's), every live berg inside its cell after the last window; 12c
   phase 6's world on a lat-lon grid through K4's lat-lon form (``dem_ll``,
   timed in turns with the generic instantiation; grouped K2 lat-lon in
   Part 1) and one outer step of the scan against K4; the
   lat-lon forms of K2, K5 and K4 each against its plain version (bit
   for bit); 12d card against CPU on small worlds of each (the tripolar
   and DEM ones on one-ulp yardsticks, cells flipped only across an
   edge between the two positions);
13. ROADMAP items 21 and 12, the stand-alone driver (``driver.run``) end
   to end, its input files written and its output files read back by the
   port's I/O in a directory of the checkout (``_chip_work/``, removed
   after): 13a phase 5's world (1M bergs, uniform forcing) for 24 steps
   through K1-K3 at capacity 2^20 (seconds a step, the output writing
   apart, file sizes, peak memory, launches, host reads a step, 0 host
   syncs in a step, overflow 0, every berg kept, the restart bit for bit
   the state) and 13a', 12 steps + restart + 12 steps against the 24
   field by field; 13b phase 6's world through the driver (K4 picked by
   it, 2 outer steps, the bond tables through write and read bit for
   bit, the world's bonds formed once by the native library); 13c the
   A68 transient branch (synthetic files of tools/run_a68.py's schema,
   half-hour steps, MTS+DEM on the curvilinear grid) and 13d the driver
   on tests/test_driver.py's two namelists, card against CPU: integers
   exact, floats within phase 4's tolerance (the DEM worlds on phase
   4b's one-ulp yardstick), in the final state and in every file;
14. ROADMAP item 22, hexagonal elements: 14c card against CPU (phase 4's
   world with hexagons, 20 hexagonally packed units as 4b's with the
   radius-based faces, and the driver on input_MTS_KID.nml's flags with
   two bonded hexagonal rafts in the converging jet), then 14a the
   headline world with ``hexagonal_icebergs`` through the persistent
   fused3 lane (the spreading through K3's pass-through; K3 must launch
   no time), timed as phase 5 is, with the hexagon geometry's kernels
   and device time at 1M bergs, and 14b phase 6's world hexagonally
   packed (touching hexagons of apothem 1.5 km, six bonds an element)
   through K4's hexagonal form (``dem_hex``), timed as phase 6 is,
   K4's hexagonal row bitwise against its plain version on the world's
   first outer step and timed in turns with the generic instantiation,
   and the walk's final clamp counted at full width (elements at the
   clamp; elements clamped on one side only of the same outer step from
   every velocity one ulp faster).
15. ROADMAP item 13 slices 1-3, the tiled coupling step and run with
   every tile in one process on the card: 15d the small worlds of
   tests/test_parallel*.py (4 tiles, 2 x 2) card against CPU; 15a the
   headline world through the tiled per-step fused3 step on 4 tiles of
   128 columns and 15b on a 2 x 2 layout of 256 x 256 tiles, each timed
   as phase 7 is with a profiled window, its merged owned state's
   berg_chksum equal to the untiled per-step path's (phase 7's), every
   exchange counter 0 and no host sync in a step; 15c make_sharded_run
   on 4 tiles of phase 10a's world against one window of the untiled
   IcebergsModel.run: the owned bergs by id bitwise, the budgets within
   1e-6, bucket and footloose spawns, no overflow, no host sync.
16. ROADMAP item 13's last slices, every tile in one process on the card:
   16c the small worlds of tests/test_parallel_bonds.py and
   tests/test_parallel_fold.py (tests/torch_parallel_worlds.py's) card
   against CPU, integers and counters exact; 16a phase 6's DEM world in 4
   tiles of 128 columns through the tiled MTS step (the scan, the ring
   ghost refresh of 2 hops, Part 1 through K2 grouped) for 2 outer steps
   against the untiled scan from the same state: every counter 0 (the
   widths doubled on overflow), the owned elements by id bitwise, the
   convergence iterations and host syncs the untiled path's; wall and
   device time and kernels an outer step beside the untiled scan's, the
   ring bytes a substep; the tiled restart at io_layout 1 and 2 read back
   into one state bitwise, the tiled trajectory equal to the untiled
   one; 16b the headline world with a tripolar north edge, 2,000 of its
   bergs moved next to the edge heading north, the tiled per-step fused3 step on 2 x 2 and
   4 x 2 tiles for 8 steps: the layouts bitwise, the count kept, bergs
   across the fold, every counter 0 and no host sync in a step.

The last two lines are a JSON object with each kernel's numbers and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without them.  Imports nothing of JAX.

``--tiled`` runs phases 15 and 16 alone after the build.

``--ab DIR`` runs phase 3's K1, K2 (with its epilogue where the package
has one), K3 (its pass-through too), K5 and K7 cases and phase 12's two
K2 lat-lon cases (12a's and 12c's slabs) and K5 lat-lon case (12a's)
only, with the
package of a copy of another commit unpacked at DIR inside this checkout
(``git archive`` into a directory ``.gitignore`` lists), so that a parent
and a change are timed on one card in one call: parent, change, change,
parent.  It also times K1's form before the column list (the caller's
stack and the column kernel on the matrix).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
N_HEAD, NX_HEAD, DXY = 1_000_000, 512, 2000.0
N_CROSS, NX_CROSS = 50_000, 128
INNER = 8
# float tolerance of the card-vs-CPU cross-check: both sides round every
# multiply and add separately (the kernels are built with -fmad=false),
# so they differ only where the CPU and CUDA libraries round sin/cos/pow
# differently (~1 ulp), amplified at most ~100x over 2 steps by the
# contact springs
CROSS_RTOL, CROSS_ATOL_SCALE = 1e-5, 2e-5

# the DEM world of tools/bench_dem_1m.py:50-112
DEM_UNITS, DEM_SIDE, DEM_R, NX_DEM, DXY_DEM = 2066, 22, 1500.0, 512, 7000.0
DEM_BLOCK = 512             # one 484-element conglomerate per block
DEM_INNER = 2               # outer steps per timed window
DEM_CAP0 = 65536            # Part-1 fallback cap (bench_dem_1m.py:172-181)
DEM_CROSS_UNITS, NX_DEM_CROSS = 20, 128
# K4 is held bitwise to its plain version on the card: both round every
# operation separately (-fmad=false, IEEE sqrtf / sinf / division)
# the DEM cross-check, card against CPU, after one outer step: integers
# exact.  Floats cannot be held to a fixed bound: the 60 stiff substeps
# (dtf 10 s against the 11.7 s stability limit) turn one ulp in the
# initial velocities into percents of the velocities' and accelerations'
# scale, and the card and the CPU differ by a few ulps where their sin
# and their reduction orders differ.  So the same
# run measures that one-ulp response on the CPU and each float field of
# the card must lie within DEM_CROSS_ULP_FACTOR times it, or within
# DEM_CROSS_FLOOR of scale where the response is smaller
DEM_CROSS_ULP_FACTOR, DEM_CROSS_FLOOR = 10.0, 2e-5

# the card's published peaks (NVIDIA H100 SXM data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# K4's float operations, counted from csrc/dem_substeps.cu's loop body
# (sqrt, division and sin as one each): per bond slot per substep, and per
# element per substep (drift, assembly, kick, angular update)
K4_FLOPS_PER_SLOT, K4_FLOPS_PER_ELEMENT = 185, 40
# and on a lat-lon grid: the pair metric per slot (csrc/latlon.cuh's six)
# and the drift's metric per element (cos, two products, the division,
# the latitude's product)
K4_LL_FLOPS_PER_SLOT, K4_LL_FLOPS_PER_ELEMENT = 6, 5
K4_BOUND_NOTE = ("the bound counts each division, sqrt and sin as one "
                 "operation, and the 67 TFLOP/s peak counts an FMA as two, "
                 "while -fmad=false emits none: the card cannot reach it")
# K2 and K5: per candidate pair test (separation, crit, compares); K3:
# per row.  The bounds of K2 and K5 count the tests of the engaged pairs
# only: no exact search can skip those, and any other pair a search may
# cull
K2_FLOPS_PER_PAIR, K3_FLOPS_PER_ROW_BASE = 12, 110
# the lat-lon metric's operations per pair test (csrc/latlon.cuh: the
# mean latitude's sum and half, the angle, cos as one, the two factors'
# products), on top of K2_FLOPS_PER_PAIR
K2_LL_FLOPS_PER_PAIR = 6
# K2's pair epilogue, counted from csrc/extract_sorted.cu: per exact pair
# (sqrt, compare, mass ratio, spring product, the two projections and
# their sums) and per selected partner from the search's registers (r^2,
# three products and their divisions, mass ratio, compare)
K2_EPI_FLOPS_PER_EXACT, K2_EPI_FLOPS_PER_PARTNER = 14, 10
# K2's chunk of staged candidates per instantiation (csrc/extract_sorted.cu
# CH_OF), for the count of the pair tests its skip leaves
K2_CHUNK = {False: 16, True: 32}
# K6 per berg (8 bilinear interpolations, the stencil slopes, the
# rotations and the scrub), counted from csrc/interp_sorted.cu; K7 per
# pair with the pmag scaling (two pmag terms, D and the five sums)
K6_FLOPS_PER_BERG, K7_FLOPS_PER_PAIR = 150, 75
K6_SLOTS_READ = 53          # slot rows 0-52 of the (64, ncells) table
# the bucket tables of the per-step slice (M = 9 x 24 candidates)
MAX_PER_CELL = 24
# K7 against its plain version: the same per-pair arithmetic, but each
# row's sums are taken in ascending k from +0, not in torch.sum's order;
# at most a few of a row's M terms are nonzero, so the orders differ by an
# ulp of the few-term sums, and not at all on a row with at most two
# (required bitwise there)
K7_RTOL, K7_ATOL_SCALE = 1e-5, 1e-6
K7_SUMS = ("P11", "P12", "P22", "Pu_x", "Pu_y")


# phase 4c: the new paths' card-vs-CPU cross-checks
CROSS_PATHS = (
    ("per-step buckets", None,
     dict(persistent=False, neighbor_mode="buckets",
          max_per_cell=MAX_PER_CELL)),
    ("persistent fused kernel-interp",
     dict(interp_mode="kernel", fused_fallback_cap=32768),
     dict(neighbor_mode="fused")))
# phase 7: each per-step neighbour mode and the kernels it must launch
# (K1's row route: the per-step paths' table gather and the persistent
# lanes' first sort; the column gather everywhere else)
K1_ROWS = ("pack_rows_u32", "gather_rows_u32")
PERSTEP_PATHS = (
    ("fused3", K1_ROWS + ("extract_sorted", "segment_spread_sums")),
    ("fused", K1_ROWS + ("contact_prepass_sorted", "segment_spread_sums")),
    ("buckets", K1_ROWS + ("eval_pair_ia_kernel", "segment_spread_sums")))
# phase 9: the options of ROADMAP item 15 on the headline world, each with
# its configuration, make_multi_step's arguments and the kernels it must
# launch (9a RK4 with K2's pair epilogue on the fast lane; 9b the fast
# lane's transport knobs with the slot scatter spreading, whose per-cell
# sums run in K3's pass-through entry; 9c the per-step fused3 path with
# the XLA interpolation, the plain scatters and the class melt)
ITEM15_PATHS = (
    ("9a", "fast_lane_rk4_epilogue",
     dict(Runge_not_Verlet=True, contact_epilogue=True), {},
     K1_ROWS + ("permute_cols_u32", "extract_sorted/epilogue",
                "segment_spread_sums")),
    ("9b", "fast_lane_knobs_scatter",
     dict(sort_packed_permute=False, pack_kernel=False,
          starts_via_scatter=True, slot_sum_method="scatter"), {},
     ("permute_cols_u32", "extract_sorted", "segment_spread_sums/assoc")),
    ("9c", "perstep_fused3_xla_noreprod",
     dict(interp_mode="xla", parallel_reprod=False),
     dict(persistent=False, neighbor_mode="fused3", with_class_melt=True),
     ("permute_cols_u32", "extract_sorted")))
# 9b changes only the spreading's association against phase 5 (the slot
# tree against K3's sequential sums, and the slot K-1 tail in dense
# cells): the coupler accumulator of the first window within this
# tolerance of phase 5's (rtol, and of its largest magnitude)
ITEM15_ACC_RTOL, ITEM15_ACC_ATOL_SCALE = 1e-5, 1e-6
# phase 10: ROADMAP item 9.  10a the coupled entry IcebergsModel.run on the
# headline world in a 2^20-slot slab, with the footloose settings of
# tests/test_footloose_pipeline.py:54-62 (dt stays the headline's 600 s),
# a steady calving flux into each cell of the outermost interior ring,
# buckets primed at random fractions of their thresholds, every 50th berg
# a 600 x 400 x 100 m tabular berg with its foot primed past two foot
# areas and every 997th berg holding footloose bits past the promotion
# threshold: each window (which starts from the same state) calves from
# the buckets and sheds footloose children
COUPLED_CAP = 1 << 20
COUPLED_FL = dict(footloose=True, fl_style="new_bergs", fl_youngs=1.e8,
                  fl_strength=250., allow_bergs_to_roll=False)
COUPLED_FLUX = 2e7                 # kg/s into each ring cell
COUPLED_TABULAR_EVERY, COUPLED_PROMOTE_EVERY = 50, 997
# the budget closure (berg mass + bits + stored ice against the start
# plus the calving used less the melt, over one window): float32 sums of
# ~1e15 kg over 1M bergs
COUPLED_BUDGET_RTOL = 1e-4
# card against CPU on the coupled cross world: the state within the
# cross-check tolerance; the melt fields of the coupler within 2e-4 of
# scale (a berg's footloose-bits melt is the float32 difference of two
# nearly equal masses, so an ulp of the bits' size moves it by ~1e-4)
COUPLED_MELT_ATOL_SCALE = 2e-4
# 10b: the per-step sorted mode, strips of max_per_cell x 3 slots (M 216)
SORTED_KW = dict(persistent=False, neighbor_mode="sorted",
                 max_per_cell=MAX_PER_CELL)
# 10c: the legacy KID bonds outside MTS on phase 6's world: per-step
# fused3 with the bond group, dt 60 s (tests/test_interactions.py:75-82:
# the spring is unstable at coupling dt); the cross-check world is 100
# such conglomerates (48,400 elements) on a 128 x 128 grid
BONDED_CFG = dict(iceberg_bonds_on=True, max_bonds=6, dt=60.,
                  lat_ref=-55.0, allow_bergs_to_roll=False)
BONDED_KW = dict(persistent=False, neighbor_mode="fused3")
BONDED_CROSS_UNITS = 100
# phase 11: ROADMAP item 16, the MTS scan substep path.  11a the scan on
# K4's flag set; 11b the reference's substep-contact regime (no
# per-substep fracture, the same-conglomerate candidates frozen into a
# pair list sized by auto_pair_cap and doubled while it overflows, as
# icebergs_tpu/driver.py:259-271 and :381-416 size it); 11c the coupled
# entry with MTS (Part 1 on the candidate tables, K7 at M = 400); 11d card
# against CPU on phase 4b's world and the input_MTS_KID.nml flag set
SCAN_KW = dict(mts_substep_kernel="scan")
PAIR_REGIME = dict(use_broken_bonds_for_substep_contact=False,
                   break_bonds_on_sub_steps=False, fracture_criterion="none")
# the scan against K4 after one outer step from one state:
# tests/test_dem_vmem.py:92-109's fields, within 5e-6 of scale
SCAN_FIELDS = ("lon", "lat", "uvel", "vvel", "ang_vel", "ang_accel", "rot",
               "axn_fast", "ayn_fast", "uvel_old", "vvel_old",
               "bond_length", "bond_tangd1", "bond_tangd2",
               "bond_rel_rotation", "bond_nstress", "bond_sstress",
               "bond_broken", "n_bonds")
SCAN_K4_TOL = 5e-6
# one substep's forces, card against CPU: the CPU tests' bound against
# the JAX package (tests/test_torch_mts_scan.py), widened to 1e-5
# relative for the card's library sin (the bonds' rotation term)
SUBSTEP_RTOL, SUBSTEP_ATOL_SCALE = 1e-5, 2e-6
MTS_MAX_PER_CELL = 16        # the JAX entry's candidate tables
# tests/test_mts_collision.py's input_MTS_KID.nml values, square elements
KID_CFG = dict(
    grid_is_latlon=False, Lx=20000., use_f_plane=True, lat_ref=0.,
    dt=3600.0, Runge_not_Verlet=False, mts=True, mts_sub_steps=60,
    explicit_inner_mts=True, force_convergence=True,
    convergence_tolerance=1e-8, contact_distance=1.75e3,
    contact_spring_coef=1.e-7, hexagonal_icebergs=False,
    interactive_icebergs_on=True, iceberg_bonds_on=True, spring_coef=1.e-5,
    critical_interaction_damping_on=True, allow_bergs_to_roll=False,
    set_melt_rates_to_zero=True, max_bonds=6)


# phase 12: ROADMAP item 11, lat-lon, curvilinear and tripolar grids at
# full width.  12a the fast lanes on a regular 0.25-degree lat-lon grid of
# 1440 x 160 cells, 80 S - 40 S, periodic in longitude (the headline
# flags with Coriolis by latitude, 1M bergs, ~4.3 a cell, the swirl on
# the index grid); 12b the coupled entry on GFDL OM4's nominal
# 0.25-degree tripolar grid (1440 x 1080 cells, Adcroft et al. 2019,
# JAMES) from 80 S, land south of 70 S and on the cap's polar cells,
# calving into the ocean cells along the Antarctic coast, 1M bergs in
# 2^20 slots over the ocean from 70 S to 50 S, phase 10a's footloose
# settings; 12c phase 6's DEM world on a lat-lon grid of 512 x 512 cells
# of 0.125 x 0.0625 degrees (0-64 E, 76 S - 44 S: ~7 km cells near 60 S,
# as phase 6's); 12d card against CPU on small worlds of each
LL_NX, LL_NY, LL_DEG, LL_LAT0 = 1440, 160, 0.25, -80.
LL_CROSS_NX, LL_CROSS_NY = 360, 40
LL_K = 3.141592653589793 / 180. * 6360000.   # metres a degree (Rearth)
TRI_NX, TRI_NY, TRI_LAT0, TRI_LAND, TRI_SEED = 1440, 1080, -80., -70., -50.
TRI_CROSS_NX, TRI_CROSS_NY, TRI_CROSS_CAP, TRI_CROSS_N = 180, 120, 1 << 16, \
    12000
LLDEM_LON0, LLDEM_LAT0, LLDEM_DLON, LLDEM_DLAT = 0., -76., 0.125, 0.0625
LL_CFG = dict(grid_is_latlon=True, Lx=360., use_f_plane=False)


class _Counter:
    """A wrapper's second launch count (``attr``) with the ``launches``
    interface the paths read and reset."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


class _ByM:
    """K7's launches at one M (``launches_by_m``: the m400 row splits
    the candidate tables' M = 400 from the bond table's M = max_bonds),
    with the ``launches`` interface the paths read and reset."""

    def __init__(self, fn, m):
        self.fn, self.m = fn, m

    @property
    def launches(self):
        return self.fn.launches_by_m.get(self.m, 0)

    @launches.setter
    def launches(self, n):
        self.fn.launches_by_m[self.m] = n


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the fp32 peak."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def require(cond, msg: str):
    if not cond:
        fail(msg)


def headline_world(ibp, torch, n, nx, device, seed=0):
    """The world of bench.py:43-72 at n bergs on an nx x nx grid."""
    cfg = ibp.IcebergsConfig(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=45.0,
        dt=600.0, Runge_not_Verlet=False, interactive_icebergs_on=True,
        use_new_predictive_corrective=True, allow_bergs_to_roll=True,
        fused_fallback_cap=2048)
    grid = ibp.make_uniform_grid(nx, nx, 0., 0., DXY, DXY,
                                 grid_is_latlon=False, device=device)
    frc = ibp.swirl_forcing(nx, nx, DXY, uo=0.3, ua=5.0, sst=4.0, sss=33.0,
                            device=device)
    import numpy as np
    rng = np.random.RandomState(seed)
    lon = rng.uniform(2 * DXY, (nx - 2) * DXY, n)
    lat = rng.uniform(2 * DXY, (nx - 2) * DXY, n)
    st = ibp.create_bergs(n, lon=lon, lat=lat,
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.0,
                          device=device)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    return cfg, grid, frc, st.replace(ine=i, jne=j, xi=xi, yj=yj)


def dem_config(ibp, **kw):
    """The iKID flag set of tools/bench_dem_1m.py:27-47."""
    base = dict(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=-55.0,
        dt=600.0, Runge_not_Verlet=False, mts=True, mts_sub_steps=60,
        explicit_inner_mts=True, dem=True, dem_spring_coef=5.e6,
        dem_damping_coef=1.0, poisson=0.3, interactive_icebergs_on=True,
        iceberg_bonds_on=True, spring_coef=0.00065359477124183,
        contact_spring_coef=1.e-7, contact_distance=4.e3,
        force_convergence=True, convergence_tolerance=1e-4,
        use_broken_bonds_for_substep_contact=True,
        break_bonds_on_sub_steps=True, fracture_criterion="stress",
        frac_thres_scaling=1., frac_thres_n=18.e3, frac_thres_t=100.e3,
        constant_interaction_LW=True, constant_length=3000.,
        constant_width=3000., manually_initialize_bonds=True,
        manually_initialize_bonds_from_radii=True,
        allow_bergs_to_roll=False, max_bonds=6, hexagonal_icebergs=False,
        fused_fallback_cap=DEM_CAP0)
    base.update(kw)
    return ibp.IcebergsConfig(**base).normalized(warn=False)


def dem_world(ibp, torch, cfg, n_units, nx, device, *, gaps=None,
              cols=None, jitter=0.0, vel_spread=0.0, seed=0, latlon=False,
              hexagonal=False):
    """tools/bench_dem_1m.py:50-112 made with the port's numpy functions:
    square 22x22 conglomerates at 2r spacing, bonded once as a prototype
    and replicated with slot offsets, then packed one conglomerate per
    ``DEM_BLOCK`` slots.  ``gaps=(gx, gy)`` packs the units edge to edge
    at those gaps, ``cols`` to a row, instead of spreading them over the
    grid in a square array; ``jitter``
    (m) moves each element and ``vel_spread`` (m/s) gives each unit its
    own velocity, from ``seed``.  ``latlon`` builds the world on phase
    12c's lat-lon grid instead (:func:`ll_dem_place`).  ``hexagonal``
    packs each unit hexagonally (tests/test_torch_cuda.py's
    ``hex_units``: columns r sqrt(3) apart, rows 2r apart, odd columns
    offset by r) with elements of side ``HEX_SIDE`` (hexagons of apothem
    r: neighbours touch), bonded by ``cfg``'s hexagonal radii.  Returns
    (grid, frc, state, deltas, n)."""
    import numpy as np
    from icebergs_tpu_torch.ops import forces
    from icebergs_tpu_torch.ops.dem_substeps import (
        analyze_bond_deltas, pack_conglomerates_blocked)

    side, r = DEM_SIDE, DEM_R
    per = side * side
    n = n_units * per
    cap = 1 << int(np.ceil(np.log2(n + 1)))
    ix, iy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    ix, iy = ix.ravel(), iy.ravel()
    if hexagonal:
        px, py = ix * r * np.sqrt(3.), iy * 2 * r + (ix % 2) * r
    else:
        px, py = ix * 2 * r, iy * 2 * r
    uside = cols or int(np.ceil(np.sqrt(n_units)))
    if gaps is None:
        pitch_x = pitch_y = (nx * DXY_DEM - 4 * DXY_DEM - side * 2 * r) / uside
    else:
        pitch_x, pitch_y = px.max() + gaps[0], py.max() + gaps[1]
    u = np.arange(n_units)
    rng = np.random.RandomState(seed)
    if latlon:
        ux, uy = ll_dem_units(n_units, nx, gaps, uside, pitch_x, pitch_y)
    else:
        ux = 2 * DXY_DEM + (u % uside) * pitch_x
        uy = 2 * DXY_DEM + (u // uside) * pitch_y
    lon = (px[None] + ux[:, None]).ravel()
    lat = (py[None] + uy[:, None]).ravel()
    lon = lon + rng.uniform(-jitter, jitter, n)
    lat = lat + rng.uniform(-jitter, jitter, n)
    if latlon:
        lon, lat = ll_dem_place(lon, lat, np.repeat(ux, per),
                                np.repeat(uy, per))
    uvel = np.repeat(0.22 + rng.uniform(-vel_spread, vel_spread, n_units),
                     per)
    vvel = np.repeat(rng.uniform(-vel_spread, vel_spread, n_units), per)

    if latlon:
        grid = ibp.make_uniform_grid(nx, nx, LLDEM_LON0, LLDEM_LAT0,
                                     LLDEM_DLON, LLDEM_DLAT,
                                     grid_is_latlon=True, device=device)
    else:
        grid = ibp.make_uniform_grid(nx, nx, 0., 0., DXY_DEM, DXY_DEM,
                                     grid_is_latlon=False, device=device)
    frc = ibp.uniform_forcing(nx, nx, uo=0.25, vo=0.05, ua=5.0, sst=-2.0,
                              sss=34.0, device=device)
    w = HEX_SIDE if hexagonal else 2 * r
    st = ibp.create_bergs(cap, lon=lon, lat=lat, uvel=uvel, vvel=vvel,
                          mass=850. * 200. * w * w, thickness=200.,
                          width=w, length=w, mass_scaling=1.0,
                          id_cnt=np.arange(n) + 1, max_bonds=6,
                          device=device)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat,
                                   360. if latlon else -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)

    proto = ibp.create_bergs(1 << int(np.ceil(np.log2(per + 1))), lon=px,
                             lat=py, mass=1., thickness=200., width=w,
                             length=w, mass_scaling=1., max_bonds=6,
                             device=torch.device("cpu"))
    # the prototype's positions are metres whatever the world's grid
    proto = forces.initialize_bonds_host(proto, cfg.replace(
        grid_is_latlon=False))
    pbond = proto.bond_idx.numpy()[:per]
    pblen = proto.bond_length.numpy()[:per]
    bond_idx = np.full((cap, 6), -1, np.int32)
    bond_len = np.zeros((cap, 6), np.float32)
    cong = np.zeros(cap, np.int32)
    offs = (u * per)[:, None, None]
    bond_idx[:n] = np.where(pbond[None] >= 0, pbond[None] + offs,
                            -1).reshape(n, 6)
    bond_len[:n] = np.broadcast_to(pblen[None], (n_units, per, 6)
                                   ).reshape(n, 6)
    cong[:n] = np.repeat(u + 1, per)
    st = forces.count_bonds(st.replace(
        bond_idx=torch.as_tensor(bond_idx, device=device),
        bond_length=torch.as_tensor(bond_len, device=device),
        conglom_id=torch.as_tensor(cong, device=device)))
    st = pack_conglomerates_blocked(st, DEM_BLOCK)
    deltas = analyze_bond_deltas(st.bond_idx, DEM_BLOCK)
    require(deltas, "the DEM world is not block-closed")
    return grid, frc, st, deltas, n


def ll_dem_units(n_units, nx, gaps, uside, pitch_x, pitch_y):
    """Phase 12c's unit origins, in metres east and north of the lat-lon
    DEM grid's corner 2 cells in from its south-west one (the zonal
    metres at each unit's latitude, :func:`ll_dem_place`).  With
    ``gaps`` the units sit ``uside`` to a row at those pitches, as phase
    4b's; else rows at phase 6's pitch fill each latitude band as far as
    its zonal width in metres allows, the pitch cut by 0.5% steps until
    all ``n_units`` fit."""
    import numpy as np
    u = np.arange(n_units)
    if gaps is not None:
        return (u % uside) * pitch_x, (u // uside) * pitch_y
    ext = 2 * DEM_R * (DEM_SIDE - 1)
    width = (nx - 4) * LLDEM_DLON
    top = (nx - 4) * LLDEM_DLAT * LL_K
    lat_s = LLDEM_LAT0 + 2 * LLDEM_DLAT
    pitch = pitch_x
    while True:
        ox, oy = [], []
        y = 0.
        while y + ext <= top and len(ox) < n_units:
            room = width * LL_K * np.cos(np.radians(lat_s + y / LL_K))
            k = int((room - ext) // pitch) + 1
            ox += list(np.arange(k) * pitch)
            oy += [y] * k
            y += pitch
        if len(ox) >= n_units:
            return np.array(ox[:n_units]), np.array(oy[:n_units])
        pitch *= 0.995


def ll_dem_place(x, y, ux, uy):
    """Metres (``x``, ``y``; each element's unit origin ``ux``, ``uy``)
    to degrees on phase 12c's grid: latitude by PI_180 Rearth; a unit's
    centre column east of the western margin through the metric at the
    unit's centre latitude, each element's offset from that column
    through the metric at its own latitude, so that every bond along a
    latitude keeps its length and the bonds across one shear by at most
    ~25 m at the unit's edge (float64 on the host)."""
    import numpy as np
    ext = 2 * DEM_R * (DEM_SIDE - 1)
    lat_s = LLDEM_LAT0 + 2 * LLDEM_DLAT
    lat = lat_s + y / LL_K
    latc = lat_s + (uy + 0.5 * ext) / LL_K
    lon0 = LLDEM_LON0 + 2 * LLDEM_DLON
    lonc = lon0 + (ux + 0.5 * ext) / (LL_K * np.cos(np.radians(latc)))
    lon = lonc + (x - ux - 0.5 * ext) / (LL_K * np.cos(np.radians(lat)))
    return lon, lat


def cuda_ms(torch, fn, reps=20):
    """Mean device time of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(torch, fn, reps=20):
    """Device time per fn() call with the host's enqueueing hidden: a spin
    kernel holds the card while the host enqueues the ``reps`` calls, so
    the CUDA events bracket their device work back to back.  This is the
    wrapper's whole call on the card (its small PyTorch operations too),
    and every kernel row's ``ms`` is this one measure."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if "hz" not in _SPIN:
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        torch.cuda.synchronize()
        _SPIN["hz"] = 1e7 / (a.elapsed_time(b) / 1e3)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin = 2 * reps * (time.perf_counter() - t0) + 0.005
    for _ in range(3):
        torch.cuda._sleep(int(_SPIN["hz"] * spin))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue < spin:
            return a.elapsed_time(b) / reps
        spin *= 4
    fail(f"the host took {enqueue:.3f} s to enqueue {reps} calls, longer "
         "than the spin that hides it")


_SPIN = {}


def host_us(torch, fn, reps=20):
    """Host time per fn() call (µs), the card left to catch up after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def max_abs_err(torch, x, y):
    if x.dtype == torch.int32:
        return float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
    return float((x.to(torch.float64) - y.to(torch.float64)).abs().max())


def state_columns(torch, pack, st, skip):
    """Every state column outside ``skip`` as K1's re-sort hands it over:
    1-D leaves whole, 2-D leaves column by column, as int32 bits."""
    cols = []
    for f in dataclasses.fields(st):
        if f.name in skip:
            continue
        leaf = getattr(st, f.name)
        subs = [leaf] if leaf.dim() == 1 else list(leaf.T)
        cols += [pack.to_bits(c) for c in subs]
    return cols


def k1_case(torch, pack, name, cols, idx, table=False, parent_form=False):
    """K1 at one caller's shape, from the caller's columns (``None`` for
    a column of zeros): the column-list entry and the row route, each held
    bitwise to ``R[:, idx]`` of the stacked matrix (for a table with the
    dead key's zero column), ``index_select`` on that matrix, the bound
    (the columns that are not zeros, idx and the output at the HBM rate)
    and the column list's host time per call.  ``parent_form`` (``--ab``)
    also times the parent's form: the caller's stack and the column
    kernel on the matrix.  Times are ``device_ms``, the host hidden."""
    nsrc = next(c for c in cols if c is not None).shape[0]
    zero = idx.new_zeros(nsrc)
    full = [zero if c is None else c for c in cols]

    def stack():
        M = torch.stack(full)
        return torch.cat([M, M.new_zeros(M.shape[0], 1)], 1) if table else M
    M = stack()
    il = idx.long()
    ref = M[:, il]
    require(torch.equal(pack.permute_cols_u32(M, idx), ref),
            f"K1 differs from R[:, idx] ({name})")
    r = dict(name=name, C=len(cols), n=idx.numel(), nsrc=nsrc,
             zero_cols=sum(c is None for c in cols),
             index_select_ms=device_ms(torch, lambda: torch.index_select(
                 M, 1, il)),
             bound_ms=bound(nbytes(*(c for c in cols if c is not None),
                                   idx, ref), 0.)[0])
    if parent_form:
        r.update(parent_ms=device_ms(torch, lambda: pack.permute_cols_u32(
                     stack(), idx)),
                 parent_host_us=host_us(torch, lambda: pack.permute_cols_u32(
                     stack(), idx)),
                 copy_ms=device_ms(torch, stack),
                 kernel_on_matrix_ms=device_ms(
                     torch, lambda: pack.permute_cols_u32(M, idx)))
    for form, kw in (("columns", {}), ("rows", {"via_rows": True})):
        require(torch.equal(pack.permute_cols_u32(cols, idx, **kw), ref),
                f"K1 {form} differs ({name})")
        r[f"{form}_ms"] = device_ms(
            torch, lambda: pack.permute_cols_u32(cols, idx, **kw))
    r["columns_host_us"] = host_us(
        torch, lambda: pack.permute_cols_u32(cols, idx))
    return r


def k1_resources(pack):
    """K1's kernels' registers and spills (the build's -Xptxas -v report)
    and resident CTAs per SM, as one line."""
    return "; ".join(
        f"{k}: {r.get('registers')} registers, spill stores/loads "
        f"{r.get('spill_stores')}/{r.get('spill_loads')} B, {r['ctas']} "
        f"CTAs/SM at {r['threads']} threads ({r['smem']} B shared at "
        f"C={r['C']})" for k, r in pack.kernel_resources().items())


def k2_resources(extract, block_n, radius, group, variant=None,
                 latlon=False, epilogue=False):
    """The K2 instantiation a launch takes, its registers and spills and
    resident CTAs per SM, as one line."""
    v, smem, ctas = extract.kernel_config(
        block_n, radius, group, variant,
        **(dict(epilogue=True) if epilogue else {}),
        **(dict(latlon=True) if latlon else {}))
    r = extract.kernel_resources().get(v, {})
    return (f"instantiation {v}: {r.get('registers')} registers, spill "
            f"stores/loads {r.get('spill_stores')}/{r.get('spill_loads')} B,"
            f" {smem} B shared, {ctas} CTAs/SM at {block_n} threads")


def partner_slots(torch, extract, out):
    """The distinct slots K2's output ``out`` names as the min or max
    partner of an engaged row: the slots whose partner rows the function
    must read."""
    e = out[extract.EX_CNT] > 0
    return int(torch.unique(torch.cat([out[extract.EX_VMIN][e],
                                       out[extract.EX_VMAX][e]])).numel())


def k2_case(torch, extract, PT, key_s, cs, grid, cfg, ab, **kw):
    """K2 on a sorted slab (``kw``: the wrapper's block_n, window, radius,
    exclude_same_group), held bitwise to its plain version (the features
    of the good blocks); its row of the kernels line.  Outside ``--ab``
    the generic instantiation is timed on the same inputs, alternating
    with the compiled one.  A lat-lon ``cfg`` takes the lat-lon
    instantiations, and its bound counts the metric's operations too.
    Returns (row, plain output, bad_block)."""
    bn, win = kw["block_n"], kw["window"]
    rad, group = kw.get("radius", 1), kw.get("exclude_same_group", False)
    cd = float(cfg.contact_distance)
    ll = bool(cfg.grid_is_latlon)
    rearth = float(cfg.Rearth) if ll else None
    # (only on a lat-lon grid: a parent package under --ab has no metric)
    metric_kw = dict(rearth=rearth) if ll else {}
    flops_pair = K2_FLOPS_PER_PAIR + (K2_LL_FLOPS_PER_PAIR if ll else 0)
    N = PT.shape[1]

    def k2(**v):
        return extract.extract_sorted(PT, key_s, cs, grid, cfg, **kw, **v)
    out, bad_block = k2()
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, bn,
                                           win, radius=rad)
    require(torch.equal(bad_block, bad[:, None].expand(-1, bn).reshape(-1)[
        :N]), f"K2 (BN {bn}) bad flags differ from block_tables'")

    def k2p():
        return extract.extract_sorted_plain(PT, cs, c_lo, c_hi, bad, bn, cd,
                                            exclude_same_group=group,
                                            **metric_kw)
    outp = k2p()
    ints = [extract.EX_CNT, extract.EX_VMIN, extract.EX_VMAX]
    require(torch.equal(out[ints], outp[ints]),
            f"K2 (BN {bn}) count / min / max slot differ from the plain "
            "version")
    require(torch.equal(out[:, ~bad_block], outp[:, ~bad_block]),
            f"K2 (BN {bn}) features differ from the plain version")
    cnt = outp[extract.EX_CNT]
    engaged = float(cnt.double().sum())
    # the function reads the rows of the tests for every berg, feature
    # rows 2-7 only at the engaged rows' partners (each distinct slot
    # once), each block's first and last key and the cell starts, and
    # writes 24 rows and the bad flags
    rows = [extract.PT_LON, extract.PT_LAT, extract.PT_RAD, extract.PT_ALIVE,
            extract.PT_KEY, extract.PT_FLK] + ([extract.PT_GRP] if group
                                              else [])
    partners = partner_slots(torch, extract, outp)
    need = (4 * len(rows) * N + 4 * (8 - 2) * partners + 8 * bad.numel()
            + nbytes(cs, out, bad_block))
    csl = cs.long()
    start = csl[c_lo.long()]
    length = torch.where(bad[:, None], 0, (csl[(c_hi + 1).long()]
                                           - start).clamp(min=0))
    tested, cos_tests = tested_pairs(torch, extract, PT, c_lo, c_hi, start,
                                     length, bn, K2_CHUNK[group], cd, rearth,
                                     group)
    t_ops = flops_pair * engaged / FP32_FLOPS_PER_S * 1e3
    t_bytes = need / HBM_BYTES_PER_S * 1e3
    ms = device_ms(torch, k2)
    ops = torch_ops(torch, k2)
    gen = ""
    if not ab:
        g = k2(variant="generic")
        require(torch.equal(g[0], out), f"generic K2 (BN {bn}) differs")
        t = [device_ms(torch, lambda: k2(variant="generic")),
             device_ms(torch, lambda: k2(variant="generic")),
             device_ms(torch, k2)]
        ms = statistics.median([ms, t[2]])
        gen = (f"; generic instantiation on these inputs {t[0]:.4f}, "
               f"{t[1]:.4f} ms against {ms:.4f} (compiled, median of 2; "
               f"order compiled, generic, generic, compiled), bitwise; "
               f"{k2_resources(extract, bn, rad, group, 'generic', ll)}")
    row = dict(
        err=max_abs_err(torch, out, outp), ms=ms,
        plain_ms=None if ab else cuda_ms(torch, k2p, reps=2),
        library_ms=None,
        bound=bound(need, flops_pair * engaged),
        note=(f"N={PT.shape[1]} radius {rad} BN {bn} window {win} "
              f"bad_blocks={int(bad.sum())}/{bad.numel()} engaged_pairs="
              f"{engaged:.0f} engaged_rows={int((cnt > 0).sum())} "
              f"partner_slots={partners} "
              f"rows_3plus={int((cnt > 2).sum())}; "
              f"{tests_note(tested, cos_tests)} (bound: the engaged "
              f"pairs' tests {t_ops:.4f} ms, the bytes {t_bytes:.4f} ms); "
              f"with the host {cuda_ms(torch, k2):.3f} ms; "
              f"{ops_note(ops)}; "
              f"{k2_resources(extract, bn, rad, group, latlon=ll)}{gen}"))
    return row, outp, bad_block


def k2_epi_case(torch, extract, PT, key_s, cs, grid, cfg):
    """K2's pair-epilogue instantiation (``contact_epilogue``, BN 128, the
    config's window) on the sorted slab against its plain version: every
    row but the spring sums bitwise, the spring sums bitwise on the rows
    with at most two exact pairs (the others are counted: the consumer
    masks them as fallback rows), and two calls bitwise.  Its row of the
    kernels line, or None for a package without the epilogue (``--ab`` on
    an older commit)."""
    if not hasattr(extract, "EX_IAX"):
        return None
    bn, win = 128, cfg.fused_window
    cd, spring = float(cfg.contact_distance), float(
        cfg.contact_spring_coef_eff)

    def k2e():
        return extract.extract_sorted(PT, key_s, cs, grid, cfg, block_n=bn,
                                      window=win, epilogue=True)
    out, bad_block = k2e()
    require(torch.equal(out, k2e()[0]), "K2 epilogue: two calls differ")
    N = PT.shape[1]
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, bn,
                                           win)
    require(torch.equal(bad_block, bad[:, None].expand(-1, bn).reshape(-1)[
        :N]), "K2 epilogue: bad flags differ from block_tables'")

    def k2p(counts=False):
        return extract.extract_sorted_plain(
            PT, cs, c_lo, c_hi, bad, bn, cd, epilogue=True, spring=spring,
            exact_counts=counts)
    outp, nexact = k2p(True)
    sums = [extract.EX_IAX, extract.EX_IAY]
    rest = [r for r in range(extract.EX_NOUT) if r not in sums]
    require(torch.equal(out[rest], outp[rest]), "K2 epilogue: count, "
            "slots, exactness or partner rows differ from the plain version")
    few = nexact <= 2
    require(torch.equal(out[sums][:, few], outp[sums][:, few]),
            "K2 epilogue: spring sums differ from the plain version on rows "
            "with at most two exact pairs")
    cnt = outp[extract.EX_CNT]
    engaged = float(cnt.double().sum())
    exact = float(nexact.double().sum())
    partners = float((cnt > 0).double().sum()) * 2
    # the rows the search and the epilogue read for every berg (lon, lat,
    # mass, rad, alive, key, fl_k), u and v only at the engaged rows'
    # partners (each distinct slot once), each block's first and last
    # key, the cell starts, and the 24 rows and the bad flags written
    need = (4 * 7 * N + 4 * 2 * partner_slots(torch, extract, outp)
            + 8 * bad.numel() + nbytes(cs, out, bad_block))
    flops = (K2_FLOPS_PER_PAIR * engaged + K2_EPI_FLOPS_PER_EXACT * exact
             + K2_EPI_FLOPS_PER_PARTNER * partners)
    return dict(
        err=max_abs_err(torch, out, outp), ms=device_ms(torch, k2e),
        plain_ms=cuda_ms(torch, k2p, reps=2), library_ms=None,
        bound=bound(need, flops),
        note=(f"N={N} BN {bn} window {win} engaged_pairs={engaged:.0f} "
              f"exact_pairs={exact:.0f} rows_3plus_exact="
              f"{int((~few).sum())} (bad rows, masked by the consumer; "
              f"their spring sums within "
              f"{max_abs_err(torch, out[sums][:, ~few], outp[sums][:, ~few]) if bool((~few).any()) else 0.0} "
              f"of the plain version); with the host "
              f"{cuda_ms(torch, k2e):.3f} ms; "
              f"{ops_note(torch_ops(torch, k2e))}; "
              f"{k2_resources(extract, bn, 1, False, epilogue=True)}"))


def k3_assoc_case(torch, ss, cols, melt_cols, cs, K, ab=False):
    """K3's pass-through (``segment_sums``) at the shapes its callers give
    it on the sorted headline slab: the slot scatter spreading's (the 36
    weighted products and 7 cell columns, 43 separate columns) in the slot
    tree and sequentially, and the melt's (``scatter_cell_deterministic``:
    the thermodynamics' 14 columns) in the slot tree, each bitwise to the
    plain version, the launches a call counted, beside
    ``torch.segment_reduce`` over the same columns and cells, all timed
    with ``device_ms``.  Its row of the kernels line, at the 43 columns
    (``ab``: no plain time); the 14 columns' times in its note."""
    n0 = ss.segment_sums.launches
    S = ss.segment_sums(cols, cs, K, tree=True)
    per_call = ss.segment_sums.launches - n0
    M = torch.stack(cols)
    Sp = ss._sums_plain(M, cs, K, True)
    require(torch.equal(S, Sp), "K3 pass-through tree sums differ from the "
            "plain version")
    Sq = ss.segment_sums(cols, cs, K, tree=False)
    require(torch.equal(Sq, ss._sums_plain(M, cs, K, False)),
            "K3 pass-through sequential sums differ from the plain version")
    S14 = ss.segment_sums(melt_cols, cs, K, tree=True)
    require(torch.equal(S14, ss._sums_plain(torch.stack(melt_cols), cs, K,
                                            True)),
            "K3 pass-through tree sums of the melt's columns differ from the "
            "plain version")
    rows_in = int(cs[-1] - cs[0])
    occ = cs[1:] - cs[:-1]
    lengths = occ.to(torch.int64)

    # the library's segment sums of the same columns over the same cells:
    # torch.segment_reduce on the (rows, F) slab, one call (a yardstick;
    # the port never calls it).  Its input is transposed before the
    # timing, and the timed calls skip the lengths' checks (host syncs)
    # that the first call makes
    def library(cs_cols):
        data = torch.stack(cs_cols)[:, int(cs[0]):int(cs[-1])].T.contiguous()
        seg = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
        require(tuple(seg.shape) == (occ.shape[0], len(cs_cols)),
                f"segment_reduce gave {tuple(seg.shape)}")
        return lambda: torch.segment_reduce(data, "sum", lengths=lengths,
                                            axis=0, unsafe=True)
    lib, lib14 = library(cols), library(melt_cols)

    def tree():
        return ss.segment_sums(cols, cs, K, True)

    def seq():
        return ss.segment_sums(cols, cs, K, False)

    def tree14():
        return ss.segment_sums(melt_cols, cs, K, True)
    # in turns: kernel, library, library, kernel (each association and
    # width)
    t = [device_ms(torch, f) for f in (tree, lib, seq, lib, tree, seq,
                                       tree14, lib14, lib14, tree14)]
    from icebergs_tpu_torch import cuda_build
    regs = "; ".join(
        f"{'tree' if 'ILb1E' in k else 'sequential'}: {r.get('registers')} "
        f"registers, spill stores/loads {r.get('spill_stores')}/"
        f"{r.get('spill_loads')} B"
        for k, r in cuda_build.resource_report().items()
        if "segment_sums_kernel" in k)
    b14 = bound(4 * rows_in * len(melt_cols) + nbytes(cs, S14),
                len(melt_cols) * rows_in)
    return dict(
        err=max_abs_err(torch, S, Sp), ms=statistics.median([t[0], t[4]]),
        plain_ms=None if ab else cuda_ms(
            torch, lambda: ss._sums_plain(M, cs, K, True), reps=2),
        library_ms=statistics.median([t[1], t[3]]),
        bound=bound(4 * rows_in * len(cols) + nbytes(cs, S),
                    len(cols) * rows_in),
        note=(f"{len(cols)} columns, rows={rows_in} K={K} cells over K="
              f"{int((occ > K).sum())} largest cell {int(occ.max())}; "
              f"launches a call {per_call}; tree {t[0]:.4f}, {t[4]:.4f} ms, "
              f"sequential {t[2]:.4f}, {t[5]:.4f} ms, segment_reduce "
              f"{t[1]:.4f}, {t[3]:.4f} ms (order tree, library, sequential, "
              f"library, tree, sequential), both associations bitwise; "
              f"the melt's {len(melt_cols)} columns, tree: {t[6]:.4f}, "
              f"{t[9]:.4f} ms, segment_reduce {t[7]:.4f}, {t[8]:.4f} ms, "
              f"bound {b14[0]:.4f} ms ({b14[1]}), bitwise"
              f"{'; ' + regs if regs else ''}"))


def torch_ops(torch, fn):
    """The torch operations one fn() call dispatches beside its kernels'
    launches, views and allocations left out: each launches at least one
    kernel of its own on the card (K2's wrapper spent 28 on its block
    tables before the kernel built them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and not func.__name__.startswith("empty"):
                ops.append(func.__name__)
            return func(*args, **(kwargs or {}))
    with Record():
        fn()
    torch.cuda.synchronize()
    return ops


def ops_note(ops):
    return (f"torch operations around the kernel a call {len(ops)}"
            + (f" ({', '.join(sorted(set(ops)))})" if ops else ""))


def tests_note(tested, cos_tests):
    """A search row's note on the pair tests of ``tested_pairs``."""
    return (f"pair tests the kernel's chunk skip leaves "
            f"{'(not modeled)' if tested is None else tested}"
            + ("" if cos_tests is None else
               f"; of them, tests that take a cosine after the candidate "
               f"skip {cos_tests}"))


def tested_pairs(torch, extract, PT, c_lo, c_hi, start_all, length_all,
                 block_n, ch, cd, rearth=None, group=False):
    """Pair tests a contact search makes on these inputs, as K2
    (csrc/extract_sorted.cu) and K5 (csrc/prepass_sorted.cu) make them, in
    float32: ``(chunk, cosine)``.  ``PT``: the feature rows by K2's row
    index (the slab, or K5's columns in a dict); ``c_lo``, ``c_hi``: the
    strips' cell ranges and ``start_all``, ``length_all`` the slots each
    strip scans (nblocks, 2r+1), none in K2's bad blocks.  ``chunk``:
    each warp's 32 lanes test all ``ch`` slots of every chunk of staged
    candidates that its box test keeps (the design before the candidate
    skip: every such test took a cosine on a lat-lon grid).  ``cosine``,
    on a lat-lon grid (``rearth``): the tests of the candidates of kept
    chunks for which some lane's bound (csrc/latlon.cuh, with the chunk's
    kx; not at the lane's own coordinates; with ``group``, outside the
    lane's conglomerate) may engage, each of which takes the metric's
    cosine in all 32 lanes; else None.  Both are None on a lat-lon grid
    for a package without the bound's plain mirror (a parent commit
    under ``--ab``)."""
    from icebergs_tpu_torch.ops.extract import _SLACK
    per_cand = rearth is not None
    if per_cand and not hasattr(extract, "latlon_kx"):
        return None, None
    N = PT[extract.PT_LON].shape[0]
    nb, ns = start_all.shape
    dev = start_all.device
    W = -(-max(int(length_all.max()), 1) // ch) * ch
    nw, nc = block_n // 32, W // ch
    inf = float("inf")
    zero = torch.zeros((), device=dev)
    k = torch.arange(W, device=dev)
    cdt = torch.tensor(abs(cd), dtype=torch.float32, device=dev)
    cds = torch.tensor(cd, dtype=torch.float32, device=dev)
    pad = nb * block_n - N

    def lanes_all(r):
        return torch.nn.functional.pad(PT[r], (0, pad)).view(nb, nw, 32)
    chunk_tests = cos_tests = 0
    step = max(1, (1 << 24) // (nw * ns * W * (32 if per_cand else 1)))
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        b = b1 - b0
        start, length = start_all[b0:b1], length_all[b0:b1]
        lo, hi = c_lo[b0:b1, :, None], c_hi[b0:b1, :, None]
        slot = (start[:, :, None] + k).clamp(max=N - 1)    # (b, ns, W)

        def cand(r):
            return PT[r][slot]
        lon = cand(extract.PT_LON)
        inc = ((k < length[:, :, None]) & (cand(extract.PT_KEY) >= lo)
               & (cand(extract.PT_KEY) <= hi)
               & (cand(extract.PT_ALIVE) > 0.5)
               & (cand(extract.PT_FLK) != -1.) & ~torch.isnan(lon))
        lat = cand(extract.PT_LAT)

        def chunks(x, fill, hi):
            x = torch.where(inc, x, fill).view(b, ns, nc, ch)
            return x.amax(3) if hi else x.amin(3)
        clo_x, chi_x = chunks(lon, inf, False), chunks(lon, -inf, True)
        clo_y, chi_y = chunks(lat, inf, False), chunks(lat, -inf, True)
        crm = chunks(cand(extract.PT_RAD).abs(), 0., True)
        nch = (length + ch - 1) // ch
        exists = torch.arange(nc, device=dev) < nch[:, :, None]

        # each warp's box over its lanes that can engage: (b, nw, 1, 1)
        def lanes(r):
            return lanes_all(r)[b0:b1]
        wx, wy = lanes(extract.PT_LON), lanes(extract.PT_LAT)
        can = ((lanes(extract.PT_ALIVE) > 0.5)
               & (lanes(extract.PT_FLK) != -1.) & ~torch.isnan(wx))
        wlo_x = torch.where(can, wx, inf).amin(2)[:, :, None, None]
        whi_x = torch.where(can, wx, -inf).amax(2)[:, :, None, None]
        wlo_y = torch.where(can, wy, inf).amin(2)[:, :, None, None]
        whi_y = torch.where(can, wy, -inf).amax(2)[:, :, None, None]
        wrm = torch.where(can, lanes(extract.PT_RAD).abs(), 0.).amax(2)[
            :, :, None, None]
        gx = torch.maximum(torch.maximum(clo_x[:, None] - whi_x,
                                         wlo_x - chi_x[:, None]), zero)
        gy = torch.maximum(torch.maximum(clo_y[:, None] - whi_y,
                                         wlo_y - chi_y[:, None]), zero)
        cb = torch.maximum(wrm + crm[:, None], cdt)
        if rearth is None:
            d2 = gx * gx + gy * gy
        else:
            kx = extract.latlon_kx(
                torch.maximum(wlo_y.abs(), whi_y.abs()),
                torch.maximum(clo_y.abs(), chi_y.abs())[:, None], rearth)
            d2 = extract.gap2_metric(gx, gy, kx, rearth)
        keep = ~(d2 > cb * cb * _SLACK)
        keep &= exists[:, None] & can.any(2)[:, :, None, None]
        chunk_tests += int(keep.sum()) * 32 * ch
        if per_cand:
            # (b, nw, 32 lanes, ns, nc, ch): each lane's bound against its
            # own crit; a lane that cannot engage has lon1 = NaN
            def c6(x):
                return x.view(b, 1, 1, ns, nc, ch)

            def l6(x):
                return x[:, :, :, None, None, None]
            lon1 = l6(torch.where(can, wx, float("nan")))
            dx = lon1 - c6(torch.where(inc, lon, float("nan")))
            dy = l6(wy) - c6(lat)
            lb = extract.gap2_metric(dx.abs(), dy.abs(),
                                     kx[:, :, None, :, :, None], rearth)
            crit = torch.maximum(l6(lanes(extract.PT_RAD))
                                 + c6(cand(extract.PT_RAD)), cds)
            # a pair at equal coordinates (the lane's own slot) has r2 = 0
            may = ((dx != 0.) | (dy != 0.)) & (lb <= crit * crit * _SLACK)
            if group:
                may &= l6(lanes(extract.PT_GRP)) != c6(cand(extract.PT_GRP))
            cos_tests += int((keep[..., None] & may.any(2)).sum()) * 32
            del lon1, dx, dy, lb, crit, may
    return chunk_tests, (cos_tests if per_cand else None)


def k1_rows(torch, pack, cases, cols_re, order1, trows, key):
    """The kernels-line rows of K1's three entries: the column gather at
    the persistent re-sort after one step (its note: the same kernel at a
    random order, the spread's row sort), and the row route's pack and
    row gather at the per-step paths' table gather (the unsorted keys),
    each held bitwise to its plain version."""
    re1 = next(c for c in cases if c["name"] == "re-sort after one step")
    sp = next(c for c in cases if c["name"] == "spread row sort")
    got = pack.permute_cols_u32(cols_re, order1)
    ref = pack.permute_cols_u32_plain(cols_re, order1)
    require(torch.equal(got, ref), "K1 columns differ from the plain version")
    T = pack.pack_rows_u32(trows)
    Tp = pack.pack_rows_u32_plain(trows)
    require(torch.equal(T, Tp), "K1 pack differs from the plain version")
    g = pack.gather_rows_u32(T, key)
    gp = pack.gather_rows_u32_plain(T, key)
    require(torch.equal(g, gp), "K1 row gather differs from the plain "
            "version")
    Mt = torch.stack(trows)
    Mt = torch.cat([Mt, Mt.new_zeros(Mt.shape[0], 1)], 1)
    kl = key.long()
    return {
        "permute_cols_u32": dict(
            err=max_abs_err(torch, got, ref), ms=re1["columns_ms"],
            plain_ms=cuda_ms(torch, lambda: pack.permute_cols_u32_plain(
                cols_re, order1), reps=5),
            library_ms=re1["index_select_ms"],
            bound=(re1["bound_ms"], "bytes"),
            note=(f"re-sort after one step, C={re1['C']} N={re1['n']}, "
                  f"the host {re1['columns_host_us']:.1f} us a call; at a "
                  f"random order (the spread's row sort, C={sp['C']}): "
                  f"{sp['columns_ms']:.4f} ms against a "
                  f"{sp['bound_ms']:.4f} ms bound (bytes)")),
        "pack_rows_u32": dict(
            err=max_abs_err(torch, T, Tp),
            ms=device_ms(torch, lambda: pack.pack_rows_u32(trows)),
            plain_ms=cuda_ms(torch, lambda: pack.pack_rows_u32_plain(trows),
                             reps=5),
            library_ms=device_ms(torch, lambda: torch.stack(trows,
                                                             dim=1)),
            bound=bound(nbytes(*trows, T), 0.),
            note=f"the cell table, C={len(trows)} ncells={T.shape[0]}"),
        "gather_rows_u32": dict(
            err=max_abs_err(torch, g, gp),
            ms=device_ms(torch, lambda: pack.gather_rows_u32(T, key)),
            plain_ms=cuda_ms(torch, lambda: pack.gather_rows_u32_plain(
                T, key), reps=5),
            library_ms=device_ms(torch, lambda: torch.index_select(
                Mt, 1, kl)),
            bound=bound(nbytes(T, key, g), 0.),
            note=(f"the table by the per-step slab's keys, C={len(trows)} "
                  f"N={key.numel()}"))}


def phase_kernels(ibp, torch, device, ab=False):
    """Each kernel against its plain version at headline shapes (``ab``:
    K1, K2, K3, K5 and K7 only, as a parent / change comparison runs
    them)."""
    from icebergs_tpu_torch.ops import pack, extract, segment_spread as ss
    from icebergs_tpu_torch.ops import sorted as srt, thermo
    from icebergs_tpu_torch.ops import fused_contact as fc
    from icebergs_tpu_torch.ops.interp_table import interp_cell_table

    cfg, grid, frc, st0 = headline_world(ibp, torch, N_HEAD, NX_HEAD,
                                         device)
    ncells = grid.nx * grid.ny
    case = functools.partial(k1_case, torch, pack, parent_form=ab)
    # K1 at each shape a headline path gives it.  The first sort (once
    # per persistent run) and the per-step paths' moves go by the (cell,
    # id) order of the unsorted slab, a random permutation
    key = torch.where(st0.alive, st0.jne * grid.nx + st0.ine,
                      ncells).to(torch.int32)
    order = srt.lex_cell_id_order(key, st0.id_cnt, st0.id_ij)
    skip = set(srt.uniform_state_fields(cfg)) | {"id_cnt", "id_ij",
                                                 "alive"}
    k1 = [case("first sort", state_columns(
        torch, pack, st0, skip), order)]

    # the persistent lane's every step: the re-sort after one step, a
    # near-identity order (the step keeps the slab sorted by the cells of
    # its start, so its state is the sorted world's slots and the new
    # order maps each berg's slot after the step to its slot before), and
    # the table gather by the sorted slab's cell keys
    st, cs = srt.sort_state_by_cell(st0, grid)
    s1 = ibp.make_multi_step(grid, cfg, 1)(st0, frc)
    ids = st.id_cnt.long()
    require(torch.equal(ids.sort().values,
                        torch.arange(st.capacity, device=device)),
            "K1 re-sort order: id_cnt is not a permutation of the slots")
    slot = torch.empty_like(ids)
    slot[ids] = torch.arange(st.capacity, device=device)
    order1 = slot[s1.id_cnt.long()].to(torch.int32)
    shift = int((order1.long() - torch.arange(st.capacity, device=device)
                 ).abs().max())
    key_st = torch.where(st.alive, st.jne * grid.nx + st.ine,
                         ncells).to(torch.int32)
    key_s1 = torch.where(s1.alive, s1.jne * grid.nx + s1.ine, ncells)
    changed = int((key_st[order1.long()] != key_s1).sum())
    k1.append(case("re-sort after one step", state_columns(
        torch, pack, st, skip), order1))
    k1[-1].update(changed_cell=changed, largest_shift=shift)
    del s1, key_s1
    tbl = interp_cell_table(grid, frc, cfg)
    trows = list(tbl.view(torch.int32))
    k1.append(case("table, sorted keys", trows, key_st,
                      table=True))
    # the per-step paths: the table gather by the unsorted keys, the
    # contact search's sorted view (the feature rows), its inverse move
    # (count, bad flag, 12 partner-feature rows) and the spread's row sort
    # (13 payload rows and the 14 melt columns)
    k1.append(case("table, unsorted keys", trows, key,
                      table=True))
    rows0, _ = fc.contact_features(st0, grid, cfg)
    k1.append(case("contact sort", [
        None if bool((r == 0).all()) else pack.to_bits(r) for r in rows0],
        order))
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(N_HEAD, dtype=order.dtype,
                                     device=device)
    PT_v = pack.from_bits(pack.permute_cols_u32(pack.to_bits(rows0), order),
                          rows0.dtype)
    out_v, _ = extract.extract_sorted(PT_v, key[order.long()],
                                      srt.starts_from_sorted_key(
                                          key[order.long()], ncells),
                                      grid, cfg, block_n=128,
                                      window=cfg.fused_window)
    lanes = [out_v[extract.EX_CNT].to(torch.int32),
             (out_v[extract.EX_CNT] > 2).to(torch.int32)]
    frows = [pack.to_bits(out_v[b + k]) for b in (extract.EX_F1,
                                                  extract.EX_F2)
             for k in range(extract.PT_NEVAL)]
    k1.append(case("inverse move", lanes + frows, inv))
    del PT_v, out_v, lanes, frows
    st_t0, melt0 = thermo.thermodynamics(st0, grid, frc, cfg)
    _, rows_sp = ss.build_rows(st_t0, grid, frc, cfg, melt0.deferred_cols,
                               key_alive=st0.alive)
    k1.append(case("spread row sort", [pack.to_bits(r) for r in rows_sp],
                   order))
    del st_t0, melt0, rows_sp
    res = k1_rows(torch, pack, k1, state_columns(torch, pack, st, skip),
                  order1, trows, key)
    res["permute_cols_u32"]["note"] += "; " + k1_resources(pack)

    # K2 on the sorted slab
    PT, key_s = fc.contact_features(st, grid, cfg)
    res["extract_sorted"] = k2_case(torch, extract, PT, key_s, cs, grid, cfg,
                                    ab, block_n=128,
                                    window=cfg.fused_window)[0]
    epi = k2_epi_case(torch, extract, PT, key_s, cs, grid, cfg)
    if epi is not None:
        res["extract_sorted/epilogue"] = epi

    # K3 on the sorted slab with the thermodynamics' melt columns: the
    # persistent lanes' width (3, the payload rows where they lie), the
    # per-step and DEM paths' (all 14) and the coupled entry's (none: its
    # thermodynamics sums its own melt; the generic instantiation)
    st_t, melt = thermo.thermodynamics(st, grid, frc, cfg)
    tblc = ss.cell_tables(grid)
    for ne in (3, 14, 0):
        _, rows = ss.build_rows(st_t, grid, frc, cfg,
                                melt.deferred_cols[:ne], key_alive=st.alive)
        res.update(k3_case(torch, ss, rows, cs, tblc, cfg, ne, ab))
    del st_t, rows
    from icebergs_tpu_torch.ops import spread as sp
    w9, vals = sp.spread_products(st, grid, frc, cfg)
    cols = [wk * v for wk in w9 for v in vals] + sp.cell_columns(
        st, grid, cfg)
    res["segment_spread_sums/assoc"] = k3_assoc_case(
        torch, ss, cols, list(melt.deferred_cols), cs,
        cfg.reprod_max_per_cell, ab)
    del w9, vals, cols, melt

    # K5 on the sorted slab, as the persistent fused lane runs it
    from icebergs_tpu_torch.ops import interp_sorted as k6, prepass
    from icebergs_tpu_torch.ops import forces, pairs
    P, key_p = prepass.prepass_features(st, grid, cfg)
    res["contact_prepass_sorted"] = k5_case(torch, prepass, P, key_p, cs,
                                            grid, cfg, ab)
    res["eval_pair_ia_kernel"] = k7_case(torch, forces, pairs, st0, grid,
                                         cfg, ab)
    if ab:
        return res, k1

    # K6 on the sorted slab with the slot table (bitwise: the same
    # expressions, each operation rounded once on both sides)
    key6 = key_p
    r6 = k6.interp_sorted(tbl[:, :ncells], key6, st.xi, st.yj, grid, cfg)
    r6p = k6.interp_sorted_plain(tbl[:, :ncells], key6, st.xi, st.yj, cfg)
    require(torch.equal(r6, r6p), "K6 rows differ from the plain version")
    t6 = tbl[:, :ncells].contiguous()
    # the kernel reads the 53 used slot rows of each occupied cell
    occupied = int(torch.bincount(key6.long(), minlength=ncells + 1)[
        :ncells].gt(0).sum())
    res["interp_sorted"] = dict(
        err=max_abs_err(torch, r6, r6p),
        ms=device_ms(torch, lambda: k6.interp_sorted(t6, key6, st.xi,
                                                      st.yj, grid, cfg)),
        plain_ms=cuda_ms(torch, lambda: k6.interp_sorted_plain(
            t6, key6, st.xi, st.yj, cfg), reps=5),
        library_ms=None,
        bound=bound(K6_SLOTS_READ * 4 * occupied
                    + nbytes(key6, st.xi, st.yj, r6),
                    K6_FLOPS_PER_BERG * N_HEAD),
        note=(f"N={N_HEAD} table {tuple(t6.shape)} occupied_cells="
              f"{occupied}"))
    del P, r6, r6p
    torch.cuda.empty_cache()
    return res, k1


def k7_case(torch, forces, pairs, st0, grid, cfg, ab, pd=None):
    """K7 on the bucket tables of the per-step slice (the unsorted slab,
    max_per_cell 24), or on the pair data ``pd`` of ``st0`` (phase 10c:
    the bond table), with the pmag scaling on (the default, the row) and
    off: within K7_RTOL + K7_ATOL_SCALE of scale of its plain version,
    bitwise on the rows with at most two active pairs and from run to
    run; outside ``--ab`` each instantiation's registers, spills, shared
    memory and CTAs per SM.  Its row of the kernels line."""
    if pd is None:
        nbr = forces.build_neighbor_tables(st0, grid, cfg,
                                           max_per_cell=MAX_PER_CELL)
        pd = forces.precompute_pair_data(st0, cfg, nbr.cand_idx,
                                         nbr.cand_valid, partner_st=st0)
        del nbr
    N, M = pd.P11.shape
    vel = (st0.uvel, st0.vvel, st0.uvel * 1.01 + 0.01, st0.vvel * 0.99)
    le2 = pd.active.sum(1) <= 2
    out = {}
    for pmag in (True, False):
        c = cfg.replace(scale_damping_by_pmag=pmag)
        got = pairs.eval_pair_ia_kernel(pd, c, *vel)
        again = pairs.eval_pair_ia_kernel(pd, c, *vel)
        ref = forces.eval_pair_ia(pd, c, *vel)
        require(torch.equal(got.IA_x, ref.IA_x)
                and torch.equal(got.IA_y, ref.IA_y),
                "K7 spring sums are not passed through")
        err, worst = 0.0, 0.0
        for f in K7_SUMS:
            a, b = getattr(got, f), getattr(ref, f)
            require(torch.equal(a, getattr(again, f)),
                    f"K7 {f} differs from run to run (pmag {pmag})")
            require(torch.equal(a[le2], b[le2]), f"K7 {f} is not bitwise on "
                    f"the rows with at most two active pairs (pmag {pmag})")
            a, b = a.double(), b.double()
            scale = max(float(b.abs().max()), 1e-30)
            require(bool(((a - b).abs() <= K7_RTOL * b.abs()
                          + K7_ATOL_SCALE * scale).all()),
                    f"K7 {f} beyond its tolerance (pmag {pmag})")
            err = max(err, float((a - b).abs().max()))
            worst = max(worst, float((a - b).abs().max()) / scale)
        out[pmag] = dict(err=err, worst=worst, ms=device_ms(
            torch, lambda: pairs.eval_pair_ia_kernel(pd, c, *vel)))
    on, off = out[True], out[False]
    # the function needs the mask, and of the four velocities and the
    # seven slabs only the 32-byte sectors (8 floats) that hold a row,
    # or a pair, that is active: an inactive pair adds exact zeros
    def n_sectors(flags):
        flags = torch.cat([flags, flags.new_zeros(-flags.numel() % 8)])
        return int(flags.reshape(-1, 8).any(1).sum())
    n_active = int(pd.active.sum())
    sectors = n_sectors(pd.active.reshape(-1))
    row_sectors = n_sectors(pd.active.any(1))
    mask_ms = cuda_ms(torch, lambda: pd.active.view(torch.uint8).amax())
    host_ms = cuda_ms(torch, lambda: pairs.eval_pair_ia_kernel(pd, cfg,
                                                               *vel))
    note = (f"N={N} M={M} active_pairs={n_active} active_sectors={sectors} "
            f"active_row_sectors={row_sectors} "
            f"rows_3plus={int((~le2).sum())} (within tolerance, worst "
            f"{on['worst']:.3e} of scale), rows_le2={int(le2.sum())} "
            f"bitwise, run to run bitwise; pmag off {off['ms']:.4f} ms "
            f"(worst {off['worst']:.3e}); a PyTorch read of the mask alone "
            f"(amax) {mask_ms:.4f} ms; with the host {host_ms:.3f} ms")
    if not ab:
        res_k = pairs.kernel_resources()
        for v, pmag in (("pmag", True), ("plain", False)):
            tr, smem, ctas = pairs.kernel_config(M, pmag)
            r = res_k.get(v, {})
            note += (f"; instantiation {v}: {r.get('registers')} registers, "
                     f"spill stores/loads {r.get('spill_stores')}/"
                     f"{r.get('spill_loads')} B, {smem} B shared, {ctas} "
                     f"CTAs/SM at 256 threads, {tr} rows a tile")
    res = dict(
        err=on["err"], ms=on["ms"],
        plain_ms=None if ab else cuda_ms(
            torch, lambda: forces.eval_pair_ia(pd, cfg, *vel), reps=3),
        library_ms=None,
        bound=bound(nbytes(pd.active) + 4 * 32 * row_sectors
                    + 7 * 32 * sectors + 5 * 4 * N,
                    K7_FLOPS_PER_PAIR * n_active),
        note=note)
    del pd
    torch.cuda.empty_cache()
    return res


def k3_case(torch, ss, rows, cs, tbl, cfg, n_extra, ab):
    """K3 on the sorted slab at one payload width, held bitwise to its
    plain version in the association its window flags take (the auto
    window: sequential) and, outside ``--ab``, in the slot tree at a forced
    128-row window; times the wrapper on the stacked payload (the call
    both commits take under ``--ab``), the row list (the persistent lane's
    call), the tree and the generic instantiation.  Its row of the
    kernels line."""
    name = "segment_spread_sums" + ("" if n_extra == 3 else
                                    f"/extra{n_extra}")
    M = torch.stack(rows)
    ncells, N = tbl.shape[1], M.shape[1]

    def k3(**kw):
        return ss.segment_spread_sums(M, cs, tbl, cfg, n_extra, **kw)
    S, bad = k3()
    nbad = int(bad.sum())
    assoc = "tree" if nbad else "sequential"
    require(nbad == 0, f"K3 {name}: {nbad} blocks overflow the auto "
            "window on the headline slab")
    Sp = ss.segment_spread_sums_plain(M, cs, tbl, cfg)
    require(torch.equal(S, Sp), f"K3 {name} sums differ from the plain "
            "version")
    rows_in = int(cs[-1] - cs[0])
    # the payload rows after the key, 10 table rows, the cell starts and
    # S, each once
    need = 4 * rows_in * (12 + n_extra) + nbytes(tbl[:10], cs, S)
    ms = device_ms(torch, k3)
    note = (f"window_bad={nbad} association={assoc} (headline slab, auto "
            f"window) ncells={ncells} rows={rows_in} n_extra={n_extra} "
            f"max_occupancy={int((cs[1:] - cs[:-1]).max())}; with the host "
            f"{cuda_ms(torch, k3):.3f} ms")
    if not ab:
        St, badt = k3(window=128)
        nt = int(badt.sum())
        require(nt > 0, "K3: no block overflows a 128-row window")
        Stp = ss.segment_spread_sums_plain(M, cs, tbl, cfg, tree=True)
        require(torch.equal(St, Stp), f"K3 {name} tree sums differ from "
                "the plain version")
        require(not torch.equal(St, S), f"K3 {name}: the tree equals the "
                "sequential sums")
        g = k3(variant="generic")[0]
        require(torch.equal(g, S), f"generic K3 {name} differs")
        t = [device_ms(torch, lambda: k3(variant="generic")),
             device_ms(torch, k3)]
        ms = statistics.median([ms, t[1]])
        K = cfg.reprod_max_per_cell
        v, smem, ctas = ss.kernel_config(n_extra, K)
        res_k = ss.kernel_resources()
        r = res_k.get(v, {})
        rf = res_k.get("window_flags", {})
        note += (f"; window 128: window_bad={nt} association=tree, bitwise "
                 f"to the plain tree (K={K}), "
                 f"{device_ms(torch, lambda: k3(window=128)):.4f} ms, plain "
                 f"{cuda_ms(torch, lambda: ss.segment_spread_sums_plain(M, cs, tbl, cfg, tree=True), reps=2):.3f} ms; "
                 f"the row list (no stack) "
                 f"{device_ms(torch, lambda: ss.segment_spread_sums(rows, cs, tbl, cfg, n_extra)):.4f}"
                 f" ms; generic instantiation {t[0]:.4f} ms against "
                 f"{ms:.4f} (compiled, median of 2), bitwise; instantiation "
                 f"{v}: {r.get('registers')} registers, spill stores/loads "
                 f"{r.get('spill_stores')}/{r.get('spill_loads')} B, {smem} B "
                 f"shared, {ctas} CTAs/SM at 256 threads; window flags "
                 f"kernel {rf.get('registers')} registers")
    return {name: dict(
        err=max_abs_err(torch, S, Sp), ms=ms,
        plain_ms=None if ab else cuda_ms(
            torch, lambda: ss.segment_spread_sums_plain(M, cs, tbl, cfg),
            reps=3),
        library_ms=None,
        bound=bound(need, (K3_FLOPS_PER_ROW_BASE + n_extra) * rows_in),
        note=note)}


def k5_case(torch, prepass, P, key_p, cs, grid, cfg, ab):
    """K5 on the sorted slab as the `fused` paths run it (BN 128, the
    config's window), held bitwise to its plain version (counts, partner
    slots and the bad flags of block_tables); outside ``--ab`` the generic
    instantiation is timed on the same inputs.  Its row of the kernels
    line."""
    win = cfg.fused_window
    N = P.shape[0]
    ll = bool(cfg.grid_is_latlon)
    # (only on a lat-lon grid: a parent package under --ab has no metric)
    metric_kw = dict(rearth=float(cfg.Rearth)) if ll else {}
    flops_pair = K2_FLOPS_PER_PAIR + (K2_LL_FLOPS_PER_PAIR if ll else 0)

    def k5(**kw):
        return prepass.contact_prepass_sorted(P, key_p, cs, grid, cfg,
                                              block_n=128, window=win, **kw)
    out = k5()
    p_lo, p_hi, pbad = prepass.block_tables(key_p, cs, grid.nx, grid.ny, 128,
                                            win)
    cd = float(cfg.contact_distance)

    def k5p():
        return prepass.prepass_sorted_plain(P, cs, p_lo, p_hi, 128, win, cd,
                                            **metric_kw)
    ref = k5p()
    require(all(torch.equal(a, b) for a, b in zip(out[:3], ref)),
            "K5 count / min / max slot differ from the plain version")
    require(torch.equal(out[3], pbad[:, None].expand(-1, 128).reshape(-1)[
        :N]), "K5 bad flags differ from block_tables'")
    engaged = float(ref[0].double().sum())
    tests = k5_pair_tests(torch, P, cs, p_lo, p_hi, 128, win)
    # the chunk skip's and (lat-lon) the candidate skip's tests, on K5's
    # columns by K2's row names and its strips' scan ranges (bad blocks
    # too); chunks of 16 (csrc/prepass_sorted.cu, no group filter)
    from icebergs_tpu_torch.ops import extract
    cols = {extract.PT_LON: prepass.F_LON, extract.PT_LAT: prepass.F_LAT,
            extract.PT_RAD: prepass.F_RAD, extract.PT_FLK: prepass.F_FLK,
            extract.PT_ALIVE: prepass.F_ALIVE, extract.PT_KEY: prepass.F_KEY,
            extract.PT_GRP: prepass.F_GRP}
    start, end = prepass.strip_ranges(cs, p_lo, p_hi, win, N)
    tested, cos_tests = tested_pairs(
        torch, extract, {r: P[:, c] for r, c in cols.items()}, p_lo, p_hi,
        start, (end - start).clamp(min=0), 128, K2_CHUNK[False], cd,
        metric_kw.get("rearth"))
    ms = device_ms(torch, k5)
    note = (f"N={N} BN 128 window {win} bad_blocks={int(pbad.sum())}/"
            f"{pbad.numel()} engaged_pairs={engaged:.0f} engaged_rows="
            f"{int((ref[0] > 0).sum())} rows_3plus={int((ref[0] > 2).sum())}"
            f"; pair tests in the strips {tests:.0f}; "
            f"{tests_note(tested, cos_tests)}; with the host "
            f"{cuda_ms(torch, k5):.3f} ms")
    if not ab:
        g = k5(variant="generic")
        require(all(torch.equal(a, b) for a, b in zip(g, out)),
                "generic K5 differs")
        t = [device_ms(torch, lambda: k5(variant="generic")),
             device_ms(torch, k5)]
        ms = statistics.median([ms, t[1]])
        v, smem, ctas = prepass.kernel_config(
            128, 1, False, **(dict(latlon=True) if ll else {}))
        r = prepass.kernel_resources().get(v, {})
        note += (f"; generic instantiation {t[0]:.4f} ms against {ms:.4f} "
                 f"(compiled, median of 2), bitwise; instantiation {v}: "
                 f"{r.get('registers')} registers, spill stores/loads "
                 f"{r.get('spill_stores')}/{r.get('spill_loads')} B, {smem} B "
                 f"shared, {ctas} CTAs/SM at 128 threads")
    return dict(
        err=max(max_abs_err(torch, a, b) for a, b in zip(out[:3], ref)),
        ms=ms,
        plain_ms=None if ab else cuda_ms(torch, k5p, reps=2),
        library_ms=None,
        # P, the cell starts and each block's first and last key read, the
        # outputs written
        bound=bound(nbytes(P, cs, *out) + 8 * pbad.numel(),
                    flops_pair * engaged),
        note=note)


def k5_pair_tests(torch, P, cs, c_lo, c_hi, block_n, window):
    """Candidate pair tests K5 makes on these inputs: for each block, its
    live rows times the slots its strips scan (bad blocks included)."""
    from icebergs_tpu_torch.ops.prepass import F_ALIVE, strip_ranges
    N = P.shape[0]
    start, end = strip_ranges(cs, c_lo, c_hi, window, N)
    cand = (end - start).clamp(min=0).sum(1)
    nb = c_lo.shape[0]
    live = torch.zeros(nb * block_n, device=P.device)
    live[:N] = (P[:, F_ALIVE] > 0.5).float()
    return float((cand.double() * live.view(nb, block_n).sum(1)).sum())


def k4_flops(torch, st, cfg):
    """K4's operations on these inputs: every bonded slot (intact or
    broken) of a moving element and every moving element, per substep."""
    mv = st.alive & (st.static_berg < 0.5)
    slots = int(((st.bond_idx >= 0) & mv[:, None]).sum())
    ll = cfg.grid_is_latlon
    return cfg.n_sub_steps * (
        (K4_FLOPS_PER_SLOT + (K4_LL_FLOPS_PER_SLOT if ll else 0)) * slots
        + (K4_FLOPS_PER_ELEMENT + (K4_LL_FLOPS_PER_ELEMENT if ll else 0))
        * int(mv.sum()))


def phase_kernels_dem(ibp, torch, device, cfg, world, ab=False):
    """K1 at the DEM path's shapes, K2 with the conglomerate filter and
    K4 at the DEM world's shapes, each against its plain version (``ab``:
    K1 and K2 only)."""
    from icebergs_tpu_torch.ops import dem_substeps as k4, extract, pack
    from icebergs_tpu_torch.ops import segment_spread as ss, sorted as srt
    from icebergs_tpu_torch.ops import thermo
    from icebergs_tpu_torch.ops.fused_contact import contact_features
    from icebergs_tpu_torch.ops.interp_table import interp_cell_table
    from icebergs_tpu_torch.ops.pack import (from_bits, permute_cols_u32,
                                             to_bits)

    grid, frc, st, deltas, n = world
    ncells = grid.nx * grid.ny
    case = functools.partial(k1_case, torch, pack, parent_form=ab)
    # K2 as Part 1 runs it: the unsorted slab's feature rows moved into
    # (cell, id) order, radius 2, block 256, window 512
    PT0, key = contact_features(st, grid, cfg, exclude_same_group=True)
    order = srt.lex_cell_id_order(key, st.id_cnt, st.id_ij)
    PT = from_bits(permute_cols_u32(to_bits(PT0), order), PT0.dtype)
    key_s = key[order.long()]
    # K1 at each shape of the DEM path, in the packed slab's (cell, id)
    # order: the table gather (89 rows with the quadratic depth), Part 1's
    # sorted view and inverse move (with the partner slots), the partner
    # velocities' refresh and the spread's row sort
    k1 = [case("dem table", list(interp_cell_table(
        grid, frc, cfg, with_quad_od=True).view(torch.int32)), key,
        table=True)]
    k1.append(case("dem contact sort", [
        None if bool((r == 0).all()) else to_bits(r) for r in PT0], order))
    cs = srt.starts_from_sorted_key(key_s, ncells)
    row, outp, bad_block = k2_case(torch, extract, PT, key_s, cs, grid, cfg,
                                   ab, block_n=256, window=512, radius=2,
                                   exclude_same_group=True)
    res = {"extract_sorted/grouped": row}
    cnt = outp[extract.EX_CNT]

    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(order.numel(), dtype=order.dtype,
                                     device=device)
    N = order.numel()
    i1 = order[outp[extract.EX_VMIN].clamp(0, N - 1).long()]
    i2 = order[outp[extract.EX_VMAX].clamp(0, N - 1).long()]
    lanes = [cnt.to(torch.int32), (bad_block | (cnt > 2)).to(torch.int32),
             torch.where(cnt >= 1, i1, 0), torch.where(cnt >= 2, i2, 0)]
    frows = [to_bits(outp[b + k]) for b in (extract.EX_F1, extract.EX_F2)
             for k in range(extract.PT_NEVAL)]
    k1.append(case("dem inverse move", lanes + frows, inv))
    other = permute_cols_u32(torch.stack(lanes[2:]), inv).reshape(-1)
    k1.append(case("dem refresh", [
        to_bits(st.uvel_old), to_bits(st.vvel_old)], other))
    del lanes, frows, other
    st_t, melt = thermo.thermodynamics(st, grid, frc, cfg)
    _, rows_sp = ss.build_rows(st_t, grid, frc, cfg, melt.deferred_cols,
                               key_alive=st.alive)
    k1.append(case("dem spread row sort",
                      [to_bits(r) for r in rows_sp], order))
    del st_t, melt, rows_sp
    if ab:
        return res, k1

    s4 = k4_state(torch, st, device)
    # the generic instantiation also with constant_interaction_LW off (its
    # elements' length and width are the constant ones)
    cfg_lw = dem_config(ibp, constant_interaction_LW=False)
    gen = k4_run(torch, k4, s4, cfg_lw, deltas, "generic")
    res["dem_substeps"] = k4_row(
        torch, k4, s4, cfg, deltas, "dem", "",
        f"generic with constant_interaction_LW off {gen[4]:.3f} ms "
        f"(nbroken {int(gen[1])}), bitwise")
    return res, k1


def k4_state(torch, st, device, latlon=False):
    """Phase 3's K4 input: the packed DEM world with each element moved by
    up to 8 m (in degrees on a lat-lon grid: through the metric at the
    element's latitude), so that some bonds fracture and broken-bond
    contact engages."""
    import numpy as np
    rng = np.random.RandomState(5)
    jit = [torch.as_tensor(rng.uniform(-8., 8., st.capacity)).to(
        device, st.dtype) * st.alive for _ in range(2)]
    if latlon:
        jit = [jit[0] / (LL_K * torch.cos(torch.deg2rad(st.lat))),
               jit[1] / LL_K]
    return st.replace(lon=st.lon + jit[0], lat=st.lat + jit[1],
                      lon_old=st.lon + jit[0], lat_old=st.lat + jit[1])


def k4_run(torch, k4, s, cfg, deltas, variant=None):
    """K4 on s in one instantiation (None: the one the configuration
    takes), held bitwise to its plain version on every field, then timed:
    (out, nbroken, max abs err, worst error of scale, ms)."""
    kw = {} if variant is None else {"variant": variant}

    def run():
        return k4.part3_substeps_vmem(s, cfg, deltas, DEM_BLOCK, **kw)
    out, nb = run()
    ref, nbp = k4.part3_substeps_plain(s, cfg, deltas, DEM_BLOCK)
    require(int(nb) == int(nbp), f"K4 nbroken {int(nb)} != plain "
            f"{int(nbp)}")
    for name in ("bond_broken", "n_bonds"):
        require(torch.equal(getattr(out, name), getattr(ref, name)),
                f"K4 {name} differs from the plain version")
    worst, err = 0.0, 0.0
    for name in k4._CAR_FIELDS + k4._BOND_FIELDS:
        a, b = getattr(out, name), getattr(ref, name)
        e = max_abs_err(torch, a, b)
        err = max(err, e)
        worst = max(worst, e / max(float(b.abs().max()), 1e-30))
        require(torch.equal(a, b), f"K4 {name} differs from the plain "
                f"version by {e} ({worst:.3e} of scale)")
    del ref
    return out, nb, err, worst, device_ms(torch, run, reps=5)


def k4_row(torch, k4, s4, cfg, deltas, variant, what, more=""):
    """K4's kernel row on the input ``s4``: the instantiation the
    configuration takes (required to be ``variant``) and the forced
    generic one, each held bitwise to the plain version (:func:`k4_run`),
    then timed in turns (generic, own, own, generic) on the same input;
    the note gives the turns, every instantiation's resources, and the
    issue-limited time beside the operation bound (:func:`k4_issue`).
    ``what`` opens the note, ``more`` closes it."""
    require(k4.instantiation(cfg, s4.max_bonds) == variant,
            f"K4 took {k4.instantiation(cfg, s4.max_bonds)!r}, not "
            f"{variant!r}, on this flag set")
    out4, nb4, err, worst, ms = k4_run(torch, k4, s4, cfg, deltas)
    k4_run(torch, k4, s4, cfg, deltas, "generic")
    runs = {v: functools.partial(k4.part3_substeps_vmem, s4, cfg, deltas,
                                 DEM_BLOCK, variant=v)
            for v in ("generic", variant)}
    turns = [(v, device_ms(torch, runs[v], reps=5))
             for v in ("generic", variant, variant, "generic")]
    mv = s4.alive & (s4.static_berg < 0.5)
    b = bound(nbytes(*(getattr(s4, f) for f in (
        "alive", "static_berg", "thickness", "mass", "od", "fl_k",
        "length", "width", "bond_idx", "bond_broken")
        + k4._CAR_FIELDS + k4._BOND_FIELDS))
        + nbytes(*(getattr(out4, f) for f in ("bond_broken",)
                   + k4._CAR_FIELDS + k4._BOND_FIELDS)),
        k4_flops(torch, s4, cfg))
    return dict(
        err=err, ms=ms,
        plain_ms=cuda_ms(torch, lambda: k4.part3_substeps_plain(
            s4, cfg, deltas, DEM_BLOCK), reps=1),
        library_ms=None, bound=b,
        note=(f"{what}N={s4.capacity} block {DEM_BLOCK} deltas {deltas} "
              f"substeps {cfg.n_sub_steps} moving={int(mv.sum())} "
              f"nbroken={int(nb4)} bitwise=True worst_scaled_err="
              f"{worst:.3e}; launched {variant}; in turns on this input "
              + ", ".join(f"{v} {t:.4f}" for v, t in turns)
              + f" ms, generic bitwise; "
              f"{k4_resources(k4, s4.max_bonds, DEM_BLOCK)}; "
              f"{k4_issue(torch, k4, s4, cfg, variant, b[0])}; "
              f"{K4_BOUND_NOTE}" + (f"; {more}" if more else "")))


def sass_functions(text):
    """``{mangled name: [(address, instruction)]}`` of a ``cuobjdump
    -sass`` listing."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def _bra_target(ins):
    m = re.search(r"\bBRA\b(?:.*,)?\s*(0x[0-9a-f]+)$", ins)
    return int(m.group(1), 16) if m else None


def k4_sass_counts(ins):
    """The instructions a warp issues in one substep of a K4
    instantiation, counted in its SASS (``ins``: address, instruction):
    ``slot``, one intact-bond slot (the slot's partner reads, geometry and
    bond part, and the contact part's vote and skip); ``contact``, what a
    slot with a broken bond adds; ``element``, the rest of the substep
    (drift, barriers, assembly, kick, empty slots' skips).  The substep
    loop is the backward branch that spans the barriers, the slot loop
    the one inside it that holds the votes (has, valid, broken: the
    contact part runs from the third to the loop's end).  The fast
    path only: the spans a forward branch jumps over that call a
    subroutine (the IEEE division's and sqrtf's slow paths), touch local
    memory or loop (sinf's and cosf's reduction of large angles) are
    left out, but no warp-skip span (the branch after each vote)."""
    addr = [a for a, _ in ins]
    txt = [t for _, t in ins]
    pos = {a: k for k, a in enumerate(addr)}
    bars = [k for k, t in enumerate(txt) if t.startswith("BAR.SYNC")]
    loops = [(pos[tg], k) for k, tg in enumerate(map(_bra_target, txt))
             if tg is not None and tg <= addr[k]]
    lo, hi = max(loops, key=lambda lp: (
        sum(lp[0] <= b <= lp[1] for b in bars), lp[1] - lp[0]))
    votes = [k for k in range(lo, hi + 1) if txt[k].startswith("VOTE")]
    guards = {next(k for k in range(v + 1, hi) if txt[k].startswith("@")
                   and _bra_target(txt[k]) is not None) for v in votes}
    slow = re.compile(r"CALL|\bSTL\b|\bLDL\b")
    skip = set()
    for k in range(lo, hi + 1):
        tg = _bra_target(txt[k])
        if (tg is None or tg <= addr[k] or k in guards
                or not txt[k].startswith("@")):
            continue
        span = range(k + 1, pos[tg])
        if any(txt[j].startswith(("VOTE", "BAR")) for j in span):
            continue
        if any(slow.search(txt[j]) or (_bra_target(txt[j]) or 1 << 62)
               <= addr[j] for j in span):
            skip.update(span)

    def n(a, b):
        return sum(1 for j in range(a, b) if j not in skip)
    # the slot loop: the loop inside that holds the votes
    a, b = next(lp for lp in loops if lo < lp[0] and lp[1] < hi
                and any(lp[0] <= v <= lp[1] for v in votes))
    bm = [v for v in votes if a <= v <= b][2]
    region, contact = n(a, b + 1), n(bm, b + 1)
    return dict(slot=region - contact + 2, contact=contact - 2,
                element=n(lo, hi + 1) - region)


@functools.lru_cache(maxsize=None)
def k4_sass(path):
    """:func:`k4_sass_counts` of every K4 instantiation in the library at
    ``path`` (``cuobjdump -sass``), by variant name; empty without
    ``cuobjdump``."""
    import shutil
    from icebergs_tpu_torch.ops import dem_substeps as k4
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    return {k4.kernel_name(f): k4_sass_counts(ins)
            for f, ins in sass_functions(text).items()
            if k4.kernel_name(f)}


def k4_issue(torch, k4, s4, cfg, variant, bound_ms):
    """The issue-limited time of K4 on ``s4`` in ``variant`` and in the
    generic instantiation, as a note: the warp-instructions of one call
    (:func:`k4_sass` counts: every bonded slot of a moving element as an
    intact bond, every moving element, each substep; 32 lanes a warp)
    over 4 issued a clock on each SM at the SM clock ``nvidia-smi`` reads
    as ``clocks.max.sm``, beside the operation bound."""
    from icebergs_tpu_torch import cuda_build
    counts = k4_sass(str(cuda_build.library_path()))
    if not counts:
        return "issue-limited time not measured (no cuobjdump)"
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mv = s4.alive & (s4.static_berg < 0.5)
    slots = int(((s4.bond_idx >= 0) & mv[:, None]).sum())
    out = []
    for v in (variant, "generic"):
        c = counts[v]
        warp = cfg.n_sub_steps * (slots * c["slot"]
                                  + int(mv.sum()) * c["element"]) / 32
        out.append(f"{v} {warp / (sms * 4 * mhz * 1e6) * 1e3:.4f} ms "
                   f"({c['slot']} instructions an intact-bond slot, "
                   f"{c['contact']} more a broken one's contact, "
                   f"{c['element']} an element, a substep)")
    return (f"issue-limited (SASS fast path, {slots} bonded slots, "
            f"warp-instructions / ({sms} SMs x 4 x {mhz:.0f} MHz)): "
            + ", ".join(out) + f", beside the operation bound "
            f"{bound_ms:.4f} ms")


def k4_resources(k4, nslots, block_n):
    """Each K4 instantiation's registers, stack and spill bytes (the
    build's -Xptxas -v report), dynamic shared memory and resident CTAs
    per SM at block_n threads, as one line."""
    parts = []
    for variant, r in sorted(k4.kernel_resources().items()):
        smem, ctas = k4.kernel_config(variant, nslots, block_n)
        parts.append(
            f"{variant}: {r['registers']} registers, stack "
            f"{r.get('stack')} B, spill "
            f"stores/loads {r.get('spill_stores')}/{r.get('spill_loads')} B, "
            f"smem {smem} B, {ctas} CTAs/SM at {block_n} threads")
    return "; ".join(parts) or "no ptxas report"


def phase_cross(ibp, torch, device, cfg_kw=None, multi_kw=None,
                world=None):
    """2 steps of a mid-size world (``world``: (cfg, grid, frc, state),
    the headline world at 50k bergs by default) on the card and on a CPU
    copy, through ``make_multi_step(**multi_kw)`` (config changed by
    ``cfg_kw``)."""
    import numpy as np
    from icebergs_tpu_torch.ops.sorted import starts_from_sorted_key

    cfg, grid, frc, st = world or headline_world(ibp, torch, N_CROSS,
                                                 NX_CROSS, device, seed=1)
    cfg = cfg.replace(**(cfg_kw or {}))
    cpu = torch.device("cpu")
    outs = {}
    for dev in (device, cpu):
        multi = ibp.make_multi_step(grid.to(dev), cfg, 2, with_stats=True,
                                    **(multi_kw or {}))
        s, ov, fb, acc = multi(st.to(dev), frc.to(dev))
        outs[dev.type] = (ibp.to_numpy(s), int(ov), int(fb),
                          acc.cpu().numpy())
    (g, gov, gfb, gacc), (c, cov, cfb, cacc) = outs["cuda"], outs["cpu"]
    require((gov, gfb) == (cov, cfb),
            f"counters differ: card {(gov, gfb)} cpu {(cov, cfb)}")
    for name in ("alive", "id_cnt", "id_ij", "ine", "jne"):
        require(np.array_equal(g[name], c[name]),
                f"{name} differs between the card and the CPU")
    ncells = grid.nx * grid.ny
    keys = [np.where(x["alive"], x["jne"] * grid.nx + x["ine"], ncells)
            for x in (g, c)]
    starts = [starts_from_sorted_key(torch.as_tensor(k).int(), ncells)
              for k in keys]
    require(torch.equal(*starts), "cell_starts differ")
    alive = g["alive"]
    worst = 0.0
    for name, gv in g.items():
        if gv.dtype.kind != "f":
            continue
        a, b = gv[alive].astype(np.float64), c[name][alive]
        scale = max(np.abs(b).max(), 1e-30) if b.size else 1.0
        tol = CROSS_RTOL * np.abs(b) + CROSS_ATOL_SCALE * scale
        require(np.all(np.abs(a - b) <= tol), f"{name} beyond tolerance")
        worst = max(worst, float((np.abs(a - b) / scale).max())
                    if b.size else 0.0)
    acc_err = float(np.abs(gacc - cacc).max() / max(np.abs(cacc).max(),
                                                    1e-30))
    require(acc_err <= CROSS_ATOL_SCALE, f"coupler fields rel {acc_err}")
    return dict(n=int(st.alive.sum()), overflow=gov, fallback=gfb,
                worst_scaled_err=worst, coupler_rel_err=acc_err)


def dem_multi(ibp, grid, cfg, n_inner, deltas):
    return ibp.make_multi_step(grid, cfg, n_inner, with_stats=True,
                               mts_substep_kernel="vmem",
                               mts_vmem_deltas=deltas,
                               mts_vmem_block_n=DEM_BLOCK)


def dem_cross_world(ibp, torch, device, cfg):
    """Phase 4b's world: 20 conglomerates in two rows of ten.  A grid row
    then holds enough elements that some 256-row search blocks stay
    inside it (good blocks, the normal group); blocks across grid rows
    take the exact fallback, which the cap covers whole.  A 3 m jitter
    keeps the bonds elastic: once bonds fracture, one ulp of a library
    sin decides which break first and the two runs part (fracture is
    held bitwise in phase 3 instead)."""
    return dem_world(ibp, torch, cfg, DEM_CROSS_UNITS, NX_DEM_CROSS, device,
                     gaps=(2.5e3, 3.5e3), cols=10, jitter=3.0,
                     vel_spread=0.05, seed=1)


def mts_counters(d):
    """An MTS step's counters (StepDiags or MtsDiags) as host ints."""
    out = {}
    for f in ("p1_overflow", "contact_overflow", "contact_fallback",
              "p1_fallback", "broken_bonds", "conv_iters", "skin_dropped",
              "pair_overflow", "inner_conv_iters"):
        v = getattr(d, f, None)
        if v is not None:
            out[f] = int(v)
    return out


def cross_yardstick(ibp, torch, label, st, run, grid=None, clamps=False):
    """``run(device, state) -> (state, coupler fields, counters)`` on the
    card, on a CPU copy and on a CPU copy with every velocity one ulp
    faster: counters and integers exact, each float field of the card
    within DEM_CROSS_ULP_FACTOR times the CPU's own one-ulp response or
    DEM_CROSS_FLOOR of scale.  With ``grid`` (a regular lat-lon grid,
    whose metric the card's and the CPU's cos round an ulp apart) an
    element may sit in a neighbouring cell on the two sides where
    :func:`edge_flips` shows the cell edge between its two positions;
    its ``ine`` / ``jne`` / ``xi`` / ``yj`` then leave the comparison and
    the flips are counted.  With ``clamps`` an element that the walk's
    final clamp moved POSN_EPS into its cell on one side only, its other
    side's position within an ulp-scale distance of that cell edge
    (:func:`edge_clamps`), leaves the position fields' comparison, and
    the coupler fields of its 3 x 3 cells leave theirs; they are
    counted."""
    import numpy as np
    cpu = torch.device("cpu")
    up = torch.nextafter(st.uvel, torch.full_like(st.uvel, float("inf")))
    nudged = st.replace(uvel=up, uvel_old=up)     # one ulp faster
    outs = {}
    for key, dev, s0 in (("cuda", st.device, st), ("cpu", cpu, st),
                         ("ulp", cpu, nudged)):
        s, acc, counters = run(dev, s0.to(dev))
        outs[key] = (ibp.to_numpy(s), acc.cpu().numpy(), counters)
    (g, gacc, gc), (c, cacc, cc), (p, pacc, _) = (outs["cuda"], outs["cpu"],
                                                  outs["ulp"])
    alive = g["alive"]
    flips, flip_ulps = np.zeros_like(alive), 0
    if grid is not None:
        flips, flip_ulps = edge_flips(grid, g, c)
    clamped = edge_clamps(g, c) if clamps else np.zeros_like(alive)
    keep = alive & ~flips
    placed = keep & ~clamped

    def scaled(x, y):
        return float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
    ints = ("alive", "id_cnt", "id_ij", "ine", "jne", "bond_idx",
            "bond_broken", "n_bonds", "conglom_id")
    differ = {k: int((g[k] != c[k])[~flips].sum()) for k in ints}

    def rows(k):
        if k in ("lon", "lat", "lon_old", "lat_old"):
            return alive & ~clamped
        return placed if k in ("xi", "yj") else alive
    errs = {k: (scaled(v[rows(k)], c[k][rows(k)]),
                scaled(p[k][rows(k)], c[k][rows(k)]))
            for k, v in g.items() if v.dtype.kind == "f" and alive.any()}
    cells = np.ones(gacc.shape, bool)
    for n in np.nonzero(clamped)[0]:
        i, j = int(c["ine"][n]) + 1, int(c["jne"][n]) + 1
        cells[max(i - 1, 0):i + 2, max(j - 1, 0):j + 2] = False
    errs["coupler"] = (scaled(gacc[cells], cacc[cells]),
                       scaled(pacc[cells], cacc[cells]))
    beyond = {k: e for k, e in errs.items()
              if e[0] > max(DEM_CROSS_ULP_FACTOR * e[1], DEM_CROSS_FLOOR)}
    if gc != cc or any(differ.values()) or beyond:
        print(f"[{label}] card {gc} cpu {cc} differing integers {differ} "
              f"(card, one-ulp) scaled float errors beyond {beyond}")
        for n in np.nonzero(((g["ine"] != c["ine"]) | (g["jne"] != c["jne"]))
                            & ~flips)[0][:8]:
            print(f"[{label}] cell differs at slot {n}: card "
                  f"{[g[k][n] for k in ('ine', 'jne', 'lon', 'lat', 'xi')]}"
                  f" cpu {[c[k][n] for k in ('ine', 'jne', 'lon', 'lat')]}")
    require(gc == cc, f"{label}: counters differ: card {gc} cpu {cc}")
    require(gc.get("p1_overflow", 0) == 0
            and gc.get("contact_overflow", 0) == 0,
            f"{label}: overflow {gc}")
    for name in ints:
        require(differ[name] == 0,
                f"{label}: {name} differs between the card and the CPU")
    require(not beyond, f"{label}: floats beyond the one-ulp yardstick: "
            f"{sorted(beyond)}")
    worst = max(errs, key=lambda k: errs[k][0])
    ratio = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-30))
    bitwise = all(np.array_equal(g[k], c[k]) for k in g)
    res = dict(capacity=st.capacity, **gc, worst_field=worst,
               worst_scaled_err=errs[worst][0],
               its_one_ulp_response=errs[worst][1],
               worst_ratio_field=ratio, worst_ratio_errs=errs[ratio],
               coupler_rel_err=errs["coupler"][0], state_bitwise=bitwise)
    if grid is not None:
        res.update(cells_flipped_at_an_edge=int(flips.sum()),
                   their_position_ulps_apart=flip_ulps)
    if clamps:
        res.update(clamped_at_an_edge=int(clamped.sum()),
                   coupler_cells_left_out=int((~cells).sum()))
    return res


def edge_clamps(g, c):
    """The live elements of the states ``g`` and ``c`` (to_numpy dicts)
    whose ``xi`` or ``yj`` is the walk's final clamp (POSN_EPS or 1 -
    POSN_EPS, dynamics.py) on one side only, POSN_EPS from the other
    side's, which lies within 1e-5 of a cell of that edge: the clamp
    moved the element POSN_EPS into its cell where its position rounded
    onto the edge (``yj <= 0`` is out of the cell, ``yj > 0`` in it).
    The same cell on both sides."""
    import numpy as np
    eps = np.float32(0.05)
    out = np.zeros_like(g["alive"])
    for ax in ("xi", "yj"):
        a, b = g[ax], c[ax]
        for x, y in ((a, b), (b, a)):
            at = (x == eps) | (x == np.float32(0.95))
            near = np.minimum(np.abs(y), np.abs(1. - y)) <= 1e-5
            out |= at & near & (x != y) & (np.abs(np.abs(x - y) - eps)
                                            <= 1e-5)
    return out & g["alive"] & c["alive"] & (g["ine"] == c["ine"]) \
        & (g["jne"] == c["jne"])


def edge_flips(grid, g, c, Lx=360.):
    """The live elements of the two states ``g`` and ``c`` (to_numpy
    dicts on one regular grid) in neighbouring cells whose shared edge
    lies between their two positions in the walk's fractional cell
    coordinates (``dynamics._frac_coords``: the longitude brought within
    half a period of the grid's middle, which rounds it to that sum's
    ulp): the positions, held to the one-ulp yardstick, straddle the
    edge, and each cell is the one its side's position lies in.  Returns
    (mask, the largest distance between such a pair of longitudes or
    latitudes in ulps).  Any other difference in cells fails."""
    import numpy as np
    import torch
    from icebergs_tpu_torch.dynamics import _frac_coords
    cpu_grid = grid.to(torch.device("cpu"))
    f = {}
    for k, x in (("g", g), ("c", c)):
        fx, fy = _frac_coords(cpu_grid, torch.as_tensor(x["lon"]),
                              torch.as_tensor(x["lat"]), Lx)
        f[k] = (fx.numpy(), fy.numpy())
    alive = g["alive"] & c["alive"]
    di = g["ine"].astype(np.int64) - c["ine"]
    dj = g["jne"].astype(np.int64) - c["jne"]
    cand = alive & ((di != 0) | (dj != 0))
    out = np.zeros_like(alive)
    worst = 0
    for n in np.nonzero(cand)[0]:
        if abs(di[n]) + abs(dj[n]) != 1:
            continue
        ax, name, cell = (0, "lon", "ine") if di[n] else (1, "lat", "jne")
        edge = max(g[cell][n], c[cell][n])
        a, b = f["g"][ax][n], f["c"][ax][n]
        out[n] = min(a, b) <= edge <= max(a, b)
        worst = max(worst, int(abs(np.float32(g[name][n]).view(np.int32)
                                   .astype(np.int64)
                                   - np.float32(c[name][n]).view(np.int32))))
    return out, worst


def multi_run(ibp, grid, frc, make):
    """A ``cross_yardstick`` run of one ``make(grid)`` multi-step call."""
    def run(dev, s0):
        multi = make(grid.to(dev))
        s, ov, fb, acc = multi(s0, frc.to(dev))
        counters = mts_counters(multi.step_diags[0])
        counters.update(max_overflow=int(ov), max_fallback=int(fb))
        return s, acc, counters
    return run


def phase_dem_cross(ibp, torch, device):
    """One MTS outer step of a 20-conglomerate world on the card and on a
    CPU copy (every kernel's plain version), substeps in K4."""
    cfg = dem_config(ibp, fused_fallback_cap=16384)
    grid, frc, st, deltas, n = dem_cross_world(ibp, torch, device, cfg)
    r = cross_yardstick(ibp, torch, "4b dem cross-check", st, multi_run(
        ibp, grid, frc, lambda g: dem_multi(ibp, g, cfg, 1, deltas)))
    return dict(elements=n, **r)


def profile_window(torch, fn, profile_out, stem, cuda_only=False):
    """Profile fn() once: writes the kernel table and trace under
    profile_out (when given); returns device kernel time (ms) and kernel
    count.  ``cuda_only``: the device's activity alone (the profiler's own
    cost grows with the host operations it records: phase 16's ~130k
    kernels an outer step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if cuda_only else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    if profile_out:
        out = pathlib.Path(profile_out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{stem}_profile.txt").write_text(prof.key_averages().table(
            sort_by="cuda_time_total", row_limit=40))
        prof.export_chrome_trace(str(out / f"{stem}_trace.json.gz"))
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in kern) / 1e3, len(kern))


def phase_dem_slice(ibp, torch, device, kernels, required, cfg, world,
                    profile_out=None, make=None, label="dem slice",
                    profile=False):
    """The bench_dem_1m world through make_multi_step, with K4 or as
    ``make(cfg, n_inner)`` builds it; each of the ``required`` kernels
    must launch, the Part-1 and pair-list overflows stay 0 (the Part-1
    fallback cap grows on evidence first) and one outer step makes one
    host sync per convergence iteration."""
    from icebergs_tpu_torch.diag import berg_chksum
    from icebergs_tpu_torch.ops import segment_spread as ss, sorted as srt

    grid, frc, st, deltas, n = world
    if make is None:
        def make(c, n_inner):
            return dem_multi(ibp, grid, c, n_inner, deltas)

    def peak(diags, f):
        return max(int(getattr(d, f)) if getattr(d, f) is not None else 0
                   for d in diags)
    mass0 = float(torch.where(st.alive, st.mass * st.mass_scaling,
                              0.).double().sum())
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        multi = make(cfg, DEM_INNER)
        out = multi(st, frc)                        # warm-up
        torch.cuda.synchronize()
        p1 = peak(multi.step_diags, "p1_overflow")
        if p1 == 0:
            break
        cap = min(4 * cfg.fused_fallback_cap, st.capacity)
        print(f"{label}: Part-1 fallback cap overran (dropped={p1}); "
              f"growing to {cap}")
        cfg = cfg.replace(fused_fallback_cap=cap)
    require(p1 == 0, f"{label}: p1_overflow {p1} != 0")
    require(peak(multi.step_diags, "contact_overflow") == 0,
            f"{label}: pair_overflow "
            f"{peak(multi.step_diags, 'contact_overflow')} != 0")

    for fn in kernels.values():
        fn.launches = 0
    times = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = multi(st, frc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if w == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
            diags = list(multi.step_diags)
    s, ov, fb, acc = out
    require(peak(diags, "p1_overflow") == 0
            and peak(diags, "contact_overflow") == 0,
            f"{label}: overflow in a timed window")
    for k in required:
        require(launches[k] > 0, f"kernel {k} was not launched by the "
                f"{label} path")

    # host syncs in one outer step
    step = make(cfg, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        step(s, frc)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    syncs = sorted({f"{pathlib.Path(r.filename).name}:{r.lineno}"
                    for r in rec})
    require(len(rec) == step.step_diags[0].conv_iters
            + (step.step_diags[0].inner_conv_iters or 0),
            f"{label}: {len(rec)} host syncs in an outer step of "
            f"{step.step_diags[0].conv_iters} convergence iterations: "
            f"{syncs}")
    floats = [getattr(s, f) for f in ("lon", "lat", "uvel", "vvel", "mass",
                                       "thickness", "ang_vel", "rot",
                                       "xi", "yj")]
    finite = all(bool(torch.isfinite(x[s.alive]).all()) for x in floats)
    finite = finite and bool(torch.isfinite(
        s.bond_nstress[s.alive]).all())
    require(finite, f"{label}: non-finite DEM state")
    require(bool(torch.isfinite(acc).all()), "non-finite coupler fields")
    mass1 = float(torch.where(s.alive, s.mass * s.mass_scaling,
                              0.).double().sum())
    require(mass1 <= mass0, f"total mass grew {mass0} -> {mass1}")
    chk, n_alive = berg_chksum(s)
    require(int(n_alive) > 0, "no elements alive")
    s_step = statistics.median(times) / DEM_INNER
    # K3's window flags on the final state, as its spreading sorts it
    ncells = grid.nx * grid.ny
    key = torch.where(s.alive, s.jne * grid.nx + s.ine, ncells).to(
        torch.int32)
    order = srt.lex_cell_id_order(key, s.id_cnt, s.id_ij)
    nbad = int(ss.window_bad(srt.starts_from_sorted_key(
        key[order.long()], ncells), ncells, s.capacity).sum())
    res = dict(
        elements=n, capacity=st.capacity, substeps=cfg.n_sub_steps,
        s_per_outer_step=s_step,
        windows_s=[t / DEM_INNER for t in times],
        dem_1m_element_substeps_per_sec=n * cfg.n_sub_steps / s_step,
        conv_iters=[d.conv_iters for d in diags],
        broken_bonds=[int(d.broken_bonds) for d in diags],
        p1_fallback=[int(d.p1_fallback) for d in diags],
        p1_overflow=int(ov), contact_fallback=int(fb),
        berg_chksum=int(chk), alive=int(n_alive), mass0=mass0, mass1=mass1,
        host_syncs_per_outer_step=len(rec), sync_kinds=syncs,
        conv_iters_sync_step=step.step_diags[0].conv_iters,
        skin_dropped=[int(d.skin_dropped) for d in diags
                      if d.skin_dropped is not None],
        pair_overflow=[int(d.contact_overflow) for d in diags
                       if d.contact_overflow is not None],
        spread_window_bad=nbad,
        spread_association="tree" if nbad else "sequential",
        fallback_cap=cfg.fused_fallback_cap,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile_out or profile:
        t0 = time.perf_counter()
        busy, nk = profile_window(torch, lambda: step(s, frc), profile_out,
                                  label.replace(" ", "_"))
        res.update(profiled_outer_step_s=time.perf_counter() - t0,
                   device_kernel_ms_per_outer_step=busy,
                   kernels_per_outer_step=nk)
    return res, launches


def all_finite(torch, st):
    """Every float field of the live bergs finite (bond tables too)."""
    return all(bool(torch.isfinite(v[st.alive]).all())
               for v in vars(st).values() if v.is_floating_point())


def max_occupancy(torch, st, grid):
    """The most alive bergs in one cell (bin_bergs' counts before the
    max_per_cell cut)."""
    cell = (st.jne * grid.nx + st.ine)[st.alive].long()
    return int(torch.bincount(cell, minlength=grid.nx * grid.ny).max())


def phase_path(ibp, torch, device, kernels, label, cfg_kw=None,
               multi_kw=None, profile_out=None, world=None, profile=False):
    """The headline world (or ``world``: (cfg, grid, frc, state)) through
    ``make_multi_step(**multi_kw)`` (config changed by ``cfg_kw``): a
    warm-up that grows the fallback cap until nothing overflows, 3 timed
    windows of ``INNER`` steps with every kernel's launches counted over
    the first, one step under torch's sync debug mode, and checks of the
    final state.  Returns ``(result, launches of the first window,
    coupler accumulator)``.  ``profile`` profiles a window without
    ``profile_out``."""
    from icebergs_tpu_torch.diag import berg_chksum

    cfg, grid, frc, st = world or headline_world(ibp, torch, N_HEAD,
                                                 NX_HEAD, device)
    cfg = cfg.replace(**(cfg_kw or {}))
    multi_kw = multi_kw or {}
    mpc = multi_kw.get("max_per_cell")
    occ0 = max_occupancy(torch, st, grid)
    if mpc is not None:
        require(occ0 <= mpc, f"{label}: {occ0} bergs in one cell > "
                f"max_per_cell {mpc}")
    mass0 = float(torch.where(st.alive, st.mass * st.mass_scaling,
                              0.).double().sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):
        multi = ibp.make_multi_step(grid, cfg, INNER, with_stats=True,
                                    **multi_kw)
        out = multi(st, frc)                        # warm-up
        torch.cuda.synchronize()
        if int(out[1]) == 0:
            break
        # at least 4x, and past the rows this run dropped
        cap = min(max(4 * cfg.fused_fallback_cap,
                      1 << (cfg.fused_fallback_cap
                            + int(out[1])).bit_length()), st.capacity)
        print(f"{label}: fallback cap overran (dropped={int(out[1])}); "
              f"growing to {cap}")
        cfg = cfg.replace(fused_fallback_cap=cap)
    require(int(out[1]) == 0, f"{label}: contact_overflow {int(out[1])} "
            "!= 0")

    for fn in kernels.values():
        fn.launches = 0
    times = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = multi(st, frc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / INNER)
        if w == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
    s, ov, fb, acc = out
    occ = [occ0]
    if mpc is not None:
        # the tables the last step builds, and the state it leaves
        s_in = ibp.make_multi_step(grid, cfg, INNER - 1, with_stats=True,
                                   **multi_kw)(st, frc)[0]
        occ += [max_occupancy(torch, s_in, grid),
                max_occupancy(torch, s, grid)]
        require(max(occ) <= mpc, f"{label}: {occ} bergs in one cell > "
                f"max_per_cell {mpc}")

    # host syncs inside one step (torch's sync debug mode warns on each)
    step = ibp.make_multi_step(grid, cfg, 1, with_stats=True, **multi_kw)
    s1 = step(s, frc)[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        step(s1, frc)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    require(all_finite(torch, s), f"{label}: non-finite state")
    require(bool(torch.isfinite(acc).all()),
            f"{label}: non-finite coupler fields")
    mass1 = float(torch.where(s.alive, s.mass * s.mass_scaling,
                              0.).double().sum())
    require(mass1 <= mass0, f"{label}: total mass grew {mass0} -> {mass1}")
    chk, n_alive = berg_chksum(s)
    require(int(n_alive) > 0, f"{label}: no bergs alive")
    syncs = sorted({f"{pathlib.Path(r.filename).name}:{r.lineno}"
                    for r in rec})
    res = dict(ms_per_step=statistics.median(times), windows_ms=times,
               contact_overflow=int(ov), contact_fallback=int(fb),
               berg_chksum=int(chk), alive=int(n_alive), mass0=mass0,
               mass1=mass1, host_syncs_per_step=len(rec),
               sync_kinds=syncs, fallback_cap=cfg.fused_fallback_cap,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches)
    if mpc is not None:
        # before the first step, before the last, after the last
        res.update(max_per_cell=mpc, max_occupancy=occ)
    if profile_out or profile:
        busy, nk = profile_window(torch, lambda: multi(st, frc), profile_out,
                                  label)
        res.update(device_kernel_ms_per_step=busy / INNER,
                   kernels_per_step=nk / INNER)
    return res, launches, acc


def coupled_world(ibp, torch, n, nx, cap, device, seed=0):
    """Phase 10a's world (COUPLED_* above): ``(cfg, grid, frc, state,
    calving flux, primed stored ice)``."""
    cfg, grid, frc, st = headline_world(ibp, torch, n, nx, device, seed)
    cfg = cfg.replace(**COUPLED_FL)
    ring = torch.zeros(nx + 2, nx + 2, dtype=torch.bool, device=device)
    ring[1:-1, 1:-1] = True
    ring[2:-2, 2:-2] = False
    return (cfg, grid, frc) + prime_coupled(torch, grid, cfg, st, cap, ring,
                                            device, seed)


def prime_coupled(torch, grid, cfg, st, cap, coast, device, seed=0):
    """Phase 10a's priming of a world: ``st`` in ``cap`` slots with every
    COUPLED_TABULAR_EVERY-th berg tabular and its foot primed and every
    COUPLED_PROMOTE_EVERY-th holding footloose bits past the promotion;
    COUPLED_FLUX into each cell of the (nx+2, ny+2) mask ``coast`` and
    its buckets primed at random fractions of their thresholds.  Returns
    ``(state, calving flux, primed stored ice)``."""
    from icebergs_tpu_torch.calving import class_grids
    from icebergs_tpu_torch.state import grow_capacity

    st = grow_capacity(st, cap)
    k = torch.arange(cap, device=device)
    tab = st.alive & (k % COUPLED_TABULAR_EVERY == 0)
    prom = st.alive & (k % COUPLED_PROMOTE_EVERY == 1)

    def put(f, mask, v):
        return torch.where(mask, v, getattr(st, f))
    st = st.replace(thickness=put("thickness", tab, 100.),
                    width=put("width", tab, 400.),
                    length=put("length", tab, 600.),
                    mass=put("mass", tab, 850. * 100. * 400. * 600.),
                    fl_k=put("fl_k", tab, 1e5),
                    mass_of_fl_bits=put("mass_of_fl_bits", prom, 1.2e12))
    calving = torch.where(coast, COUPLED_FLUX, 0.).to(torch.float32)
    tb = class_grids(grid, cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(tb["mass"].shape, generator=g, device=device)
    stored = torch.where(coast[:, :, None], tb["mass"] * tb["scal"] * u, 0.)
    return st, calving, stored


def coupled_state(model, st, stored, seed=0):
    s = model.init_state(st, seed=seed)
    return s.replace(calving=s.calving.replace(stored_ice=stored))


_COUPLED_COUNTS = ("nbergs", "nbergs_calved", "nbergs_calved_fl",
                   "spawn_overflow", "fl_spawn_overflow", "contact_overflow",
                   "contact_fallback", "nbergs_melted", "nbergs_deleted_fl",
                   "tickets")
_COUPLED_FIELDS = ("spread_mass", "spread_area", "spread_uvel",
                   "spread_vvel", "ustar_iceberg", "mass_on_ocean",
                   "berg_melt", "fl_bits_src")
_COUPLED_MELT = ("calving", "calving_hflx", "floating_melt")


def phase_coupled_cross(ibp, torch, device, world=None):
    """2 steps of ``IcebergsModel.run`` on the coupled world at 50k bergs
    (a 65,536-slot slab; or ``world``, as coupled_world or tripolar_world
    returns it) on the card and on a CPU copy: every counter and the
    integers exact, floats within the cross-check tolerance (the
    coupler's melt fields within COUPLED_MELT_ATOL_SCALE).  The result
    also reads how many ulps apart the live positions are after the
    first step."""
    import numpy as np

    cfg, grid, frc, st, calving, stored = world or coupled_world(
        ibp, torch, N_CROSS, NX_CROSS, 1 << 16, device, seed=1)
    outs = []
    for dev in (device, torch.device("cpu")):
        model = ibp.IcebergsModel(grid, cfg, device=dev)
        s = coupled_state(model, st.to(dev), stored.to(dev))
        counts = []
        for _ in range(2):
            s, o = model.run(s, frc.to(dev), calving.to(dev))
            counts.append({f: int(getattr(o, f)) for f in _COUPLED_COUNTS})
            if len(counts) == 1:
                first = ibp.to_numpy(s.bergs)
        outs.append((ibp.to_numpy(s.bergs), counts, {
            f: getattr(o, f).cpu().numpy()
            for f in _COUPLED_FIELDS + _COUPLED_MELT}, first))
    (g, gc, gf, g1), (c, cc, cf, c1) = outs
    require(gc == cc, f"coupled counters differ: card {gc} cpu {cc}")
    require(np.array_equal(g1["alive"], c1["alive"]),
            "alive differs between the card and the CPU after one step")
    alive1 = g1["alive"]
    ulps = {f: int(np.abs(g1[f][alive1].view(np.int32).astype(np.int64)
                          - c1[f][alive1].view(np.int32).astype(np.int64)
                          ).max(initial=0)) for f in ("lon", "lat")}
    for name in ("alive", "id_cnt", "id_ij", "ine", "jne", "fl_k"):
        if name == "fl_k":
            # the footloose states (-1, -2, -3) exactly
            require(np.array_equal(g[name] < 0, c[name] < 0)
                    and np.array_equal(g[name][g[name] < 0],
                                       c[name][c[name] < 0]),
                    "footloose states differ between the card and the CPU")
            continue
        require(np.array_equal(g[name], c[name]),
                f"{name} differs between the card and the CPU")
    alive = g["alive"]
    worst = {}
    for name, gv in g.items():
        if gv.dtype.kind != "f" or gv.ndim != 1:
            continue
        a, b = gv[alive].astype(np.float64), c[name][alive]
        scale = max(np.abs(b).max(), 1e-30)
        require(np.all(np.abs(a - b) <= CROSS_RTOL * np.abs(b)
                       + CROSS_ATOL_SCALE * scale),
                f"coupled {name} beyond tolerance")
        worst[name] = float(np.abs(a - b).max() / scale)
    for name in _COUPLED_FIELDS + _COUPLED_MELT:
        a, b = gf[name].astype(np.float64), cf[name]
        scale = max(np.abs(b).max(), 1e-30)
        atol = (COUPLED_MELT_ATOL_SCALE if name in _COUPLED_MELT
                else CROSS_ATOL_SCALE)
        require(np.all(np.abs(a - b) <= CROSS_RTOL * np.abs(b)
                       + atol * scale), f"coupled {name} beyond tolerance")
        worst[name] = float(np.abs(a - b).max() / scale)
    w = max(worst, key=worst.get)
    return dict(n=int(alive.sum()), capacity=st.capacity, steps=gc,
                worst_field=w, worst_scaled_err=worst[w],
                position_ulps_after_step1=ulps)


def phase_coupled(ibp, torch, device, kernels, profile_out=None,
                  world=None, label="coupled", profile=False, check=None):
    """Phase 10a: ``IcebergsModel.run`` on the coupled world at 1M bergs
    (or ``world``, as coupled_world returns it): a warm-up that grows the
    slab or the fallback cap until no counter overflows, 3 timed windows
    of ``INNER`` steps from the same state with every kernel's launches
    counted over the first, bucket and footloose spawns required in each
    window, one ``run`` under torch's sync debug mode, and the budgets'
    closure; ``check(state)`` adds to the final state's checks.  Returns
    ``(result, launches of the first window)``."""
    from icebergs_tpu_torch.diag import berg_chksum, compute_budgets
    from icebergs_tpu_torch.state import grow_capacity

    cfg, grid, frc, st, calving, stored = world or coupled_world(
        ibp, torch, N_HEAD, NX_HEAD, COUPLED_CAP, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def window(model):
        s = coupled_state(model, st, stored)
        outs = []
        for _ in range(INNER):
            s, o = model.run(s, frc, calving)
            outs.append(o)
        return s, outs

    def peak(outs, f):
        return max(int(getattr(o, f)) for o in outs)

    for _ in range(4):
        model = ibp.IcebergsModel(grid, cfg, device=device)
        s, outs = window(model)
        torch.cuda.synchronize()
        ov = {f: peak(outs, f) for f in ("spawn_overflow",
                                         "fl_spawn_overflow",
                                         "contact_overflow")}
        if not any(ov.values()):
            break
        if ov["contact_overflow"]:
            cap = min(4 * cfg.fused_fallback_cap, st.capacity)
            print(f"{label}: fallback cap overran ({ov}); growing to {cap}")
            cfg = cfg.replace(fused_fallback_cap=cap)
        if ov["spawn_overflow"] or ov["fl_spawn_overflow"]:
            print(f"{label}: slab full ({ov}); growing it to "
                  f"{2 * st.capacity} slots")
            st = grow_capacity(st, 2 * st.capacity)
    require(not any(ov.values()), f"{label}: overflow {ov}")

    b0 = compute_budgets(st, coupled_state(model, st, stored).calving)
    for fn in kernels.values():
        fn.launches = 0
    times, per_window = [], []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, outs = window(model)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / INNER)
        if w == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
        per_window.append({f: sum(int(getattr(o, f)) for o in outs)
                           for f in ("nbergs_calved", "nbergs_calved_fl")})
    for w, c in enumerate(per_window):
        require(c["nbergs_calved"] > 0 and c["nbergs_calved_fl"] > 0,
                f"{label} window {w}: no bucket or no footloose spawn {c}")
    ov = {f: peak(outs, f) for f in ("spawn_overflow", "fl_spawn_overflow",
                                     "contact_overflow")}
    require(not any(ov.values()), f"{label}: overflow {ov}")

    # the budgets close over the last window
    b1 = outs[-1].budgets
    used = sum(float(o.net_calving_used) for o in outs)
    melt = sum(float(o.net_melt_kg) for o in outs)
    start = float(b0.mass) + float(b0.mass_of_bits) + float(b0.stored_ice)
    end = float(b1.mass) + float(b1.mass_of_bits) + float(b1.stored_ice)
    budget_rel = abs(end - (start + used - melt)) / end
    require(budget_rel <= COUPLED_BUDGET_RTOL,
            f"{label}: the budgets do not close (rel {budget_rel:.3e})")

    # host syncs inside one run (torch's sync debug mode warns on each)
    s0 = coupled_state(model, st, stored)
    s1, _ = model.run(s0, frc, calving)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        model.run(s1, frc, calving)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    fin = s.bergs
    require(all_finite(torch, fin), f"{label}: non-finite state")
    o = outs[-1]
    require(all(bool(torch.isfinite(getattr(o, f)).all())
                for f in _COUPLED_FIELDS + _COUPLED_MELT),
            f"{label}: non-finite coupler fields")
    chk, n_alive = berg_chksum(fin)
    syncs = sorted({f"{pathlib.Path(r.filename).name}:{r.lineno}"
                    for r in rec})
    require(not rec, f"{label}: host syncs in a run: {syncs}")
    res = dict(ms_per_step=statistics.median(times), windows_ms=times,
               capacity=st.capacity, alive0=int(st.alive.sum()),
               alive=int(n_alive), berg_chksum=int(chk),
               spawns_per_window=per_window, overflow=ov,
               contact_fallback=peak(outs, "contact_fallback"),
               fallback_cap=cfg.fused_fallback_cap,
               budget_rel_err=budget_rel, host_syncs_per_run=len(rec),
               sync_kinds=syncs,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches)
    if check is not None:
        res.update(check(fin))
    if profile_out or profile:
        busy, nk = profile_window(torch, lambda: window(model), profile_out,
                                  label.replace(" ", "_") + "_run")
        res.update(device_kernel_ms_per_step=busy / INNER,
                   kernels_per_step=nk / INNER)
    return res, launches


def bonded_world(ibp, torch, device, dem=None):
    """Phase 10c's configuration (the headline config with BONDED_CFG) on
    phase 6's world ``dem`` (grid, frc, state, ...) or, without it, on
    the cross-check world of BONDED_CROSS_UNITS conglomerates."""
    cfg = headline_world(ibp, torch, 1, 4, device)[0].replace(**BONDED_CFG)
    if dem is None:
        dem = dem_world(ibp, torch, dem_config(ibp), BONDED_CROSS_UNITS,
                        NX_CROSS, device, seed=2)
        # the cross-check grows no cap: most elements take the fallback
        # (their neighbours sit at the contact distance, an ulp either
        # side)
        cfg = cfg.replace(fused_fallback_cap=dem[2].capacity)
    return cfg, dem[0], dem[1], dem[2]


def scan_vs_k4(ibp, torch, grid, frc, st, cfg, deltas):
    """One outer step from ``st`` through the scan and through K4 (the
    dynamics alone): the largest |scan - K4| / scale of each of
    SCAN_FIELDS (scale: the scan's largest magnitude) and both
    broken-bond counts."""
    outs = []
    for kw in (SCAN_KW, dict(mts_substep_kernel="vmem",
                             mts_vmem_deltas=deltas,
                             mts_vmem_block_n=DEM_BLOCK)):
        step = ibp.make_step(grid, cfg, with_thermo=False, with_spread=False,
                             **kw)
        s, d = step(st, frc)
        outs.append((s, int(d.broken_bonds)))
    (a, na), (b, nb) = outs
    errs = {}
    for f in SCAN_FIELDS:
        x, y = getattr(a, f).double(), getattr(b, f).double()
        errs[f] = float((x - y).abs().max() / max(float(x.abs().max()),
                                                  1e-30))
    return errs, na, nb


def pair_cap_on_evidence(ibp, torch, st, grid, cfg):
    """The frozen pair list's capacity as the JAX driver sizes it:
    ``auto_pair_cap`` on the state, doubled while
    ``compact_conglom_pairs`` overflows.  Returns (cap, auto cap, pairs,
    skin_dropped, overflow at the auto cap)."""
    from icebergs_tpu_torch import mts
    from icebergs_tpu_torch.ops import forces
    nbr = forces.build_neighbor_tables(
        st, grid, cfg, max_per_cell=MTS_MAX_PER_CELL,
        ncells_radius=forces.neighbor_radius(grid, cfg))
    cap0 = cap = mts.auto_pair_cap(st, nbr, cfg)
    limit = nbr.cand_idx.numel()
    ov0 = None
    while True:
        me, ot, pv, ov, sd = mts.compact_conglom_pairs(st, nbr, cap, cfg=cfg,
                                                       dt=cfg.dt)
        ov = int(ov)
        ov0 = ov if ov0 is None else ov0
        if ov == 0 or cap >= limit:
            break
        cap = min(2 * cap, limit)
    npair = int(pv.sum())
    del nbr, me, ot, pv
    torch.cuda.empty_cache()
    require(ov == 0, f"pair list overflows at the slab's size {cap}")
    return cap, cap0, npair, int(sd), ov0


def phase_mts_coupled(ibp, torch, device, kernels, cfg, world,
                      profile_out=None, label="11c", inner=DEM_INNER,
                      stem="mts_coupled_run", profile=True):
    """Phase 11c: ``IcebergsModel.run`` with MTS on phase 6's world
    (Part 1 on the candidate tables, K7 at M = 400, the scan substeps,
    ``interp_flds``, thermodynamics, the spreading): a warm-up, 3 timed
    windows of ``inner`` runs from one state with every kernel's launches
    counted over the first, every overflow 0, the largest cell within
    the tables' MTS_MAX_PER_CELL, the budgets closed over a window, one
    host sync per Part-1 convergence iteration in a run, a profiled
    window when ``profile``.  Returns ``(result, launches of the first
    window)``."""
    from icebergs_tpu_torch.diag import berg_chksum, compute_budgets

    grid, frc, st, deltas, n = world
    occ = max_occupancy(torch, st, grid)
    require(occ <= MTS_MAX_PER_CELL, f"{label}: {occ} elements in a cell "
            f"> max_per_cell {MTS_MAX_PER_CELL}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = ibp.IcebergsModel(grid, cfg, device=device)

    def window():
        s = model.init_state(st)
        outs = []
        for _ in range(inner):
            s, o = model.run(s, frc)
            outs.append(o)
        return s, outs

    def overflow(outs):
        ov = {f: max(int(getattr(o, f)) for o in outs)
              for f in ("contact_overflow", "spawn_overflow",
                        "fl_spawn_overflow")}
        ov["p1_overflow"] = max(int(o.mts.p1_overflow or 0) for o in outs)
        return ov

    s, outs = window()                                 # warm-up
    torch.cuda.synchronize()
    require(not any(overflow(outs).values()),
            f"{label}: overflow {overflow(outs)}")
    b0 = compute_budgets(st, model.init_state(st).calving)
    for fn in kernels.values():
        fn.launches = 0
    times = []
    for w in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, outs = window()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / inner)
        if w == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
        require(not any(overflow(outs).values()),
                f"{label} window {w}: overflow {overflow(outs)}")
    b1 = outs[-1].budgets
    used = sum(float(o.net_calving_used) for o in outs)
    melt = sum(float(o.net_melt_kg) for o in outs)
    start = float(b0.mass) + float(b0.mass_of_bits) + float(b0.stored_ice)
    end = float(b1.mass) + float(b1.mass_of_bits) + float(b1.stored_ice)
    budget_rel = abs(end - (start + used - melt)) / end
    require(budget_rel <= COUPLED_BUDGET_RTOL,
            f"{label}: the budgets do not close (rel {budget_rel:.3e})")

    require(all_finite(torch, s.bergs), f"{label}: non-finite state")
    require(all(bool(torch.isfinite(getattr(outs[-1], f)).all())
                for f in _COUPLED_FIELDS[:-1] + _COUPLED_MELT),
            f"{label}: non-finite coupler fields")
    chk, n_alive = berg_chksum(s.bergs)
    # one more run from the last window's state, its host syncs counted
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, o = model.run(s, frc)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sorted({f"{pathlib.Path(r.filename).name}:{r.lineno}"
                    for r in rec})
    require(len(rec) == o.mts.conv_iters, f"{label}: {len(rec)} host syncs "
            f"in a run of {o.mts.conv_iters} convergence iterations: {syncs}")
    res = dict(elements=n, capacity=st.capacity, substeps=cfg.n_sub_steps,
               s_per_outer_step=statistics.median(times), windows_s=times,
               conv_iters=[o.mts.conv_iters for o in outs],
               broken_bonds=[int(o.mts.broken_bonds) for o in outs],
               overflow=overflow(outs), max_occupancy=occ,
               budget_rel_err=budget_rel, alive=int(n_alive),
               berg_chksum=int(chk), host_syncs_per_run=len(rec),
               conv_iters_sync_run=o.mts.conv_iters, sync_kinds=syncs,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile:
        t0 = time.perf_counter()
        busy, nk = profile_window(torch, window, profile_out, stem)
        res.update(profiled_window_s=time.perf_counter() - t0,
                   device_kernel_ms_per_outer_step=busy / inner,
                   kernels_per_outer_step=nk / inner)
    return res, launches


def k7_tables_case(ibp, torch, forces, pairs, pack, cfg, device):
    """K7 at the tables Part 1's M = 400 (the cross-conglomerate group
    over the (N, 25 x 16) candidate tables) on phase 6's 2066
    conglomerates packed 2.5 km apart in rows of 46, 3.5 km between rows,
    so that the group has pairs (phase 6's own world has none): held to
    its plain version as phase 3 holds it; and K1 at the Part-1 refresh's
    shape (both partner velocities by the (N x 400) partner slots).
    Returns (K7 row, K1 line)."""
    from icebergs_tpu_torch.ops.pack import to_bits
    grid, frc, st, _, n = dem_world(ibp, torch, cfg, DEM_UNITS, NX_DEM,
                                    device, gaps=(2.5e3, 3.5e3), cols=46,
                                    vel_spread=0.05, seed=4)
    nbr = forces.build_neighbor_tables(
        st, grid, cfg, max_per_cell=MTS_MAX_PER_CELL,
        ncells_radius=forces.neighbor_radius(grid, cfg))
    same = st.conglom_id[:, None] == st.conglom_id[nbr.cand_idx.long()]
    mask = nbr.cand_valid & ~same
    del same
    pd = forces.precompute_pair_data(st, cfg, nbr.cand_idx, mask)
    del nbr, mask
    torch.cuda.empty_cache()
    k1 = k1_case(torch, pack, "mts tables refresh",
                 [to_bits(st.uvel_old), to_bits(st.vvel_old)],
                 pd.other.reshape(-1))
    row = k7_case(torch, forces, pairs, st, grid, cfg, False, pd=pd)
    del pd
    torch.cuda.empty_cache()
    row["note"] = f"elements={n}; " + row["note"]
    return row, k1


def pair_list_check(ibp, torch, st, grid, cfg, cap):
    """The frozen pair list on the card and on a CPU copy (every
    integer exact), and the pair-list contact sums twice on the card from
    one state, bit for bit."""
    from icebergs_tpu_torch import mts
    from icebergs_tpu_torch.ops import dem, forces
    lists = []
    for dev in (st.device, torch.device("cpu")):
        s = st.to(dev)
        g = grid.to(dev)
        nbr = forces.build_neighbor_tables(
            s, g, cfg, max_per_cell=MTS_MAX_PER_CELL,
            ncells_radius=forces.neighbor_radius(g, cfg))
        lists.append([x.cpu() for x in mts.compact_conglom_pairs(
            s, nbr, cap, cfg=cfg, dt=cfg.dt)])
    for name, a, b in zip(("me", "other", "pvalid", "overflow",
                           "skin_dropped"), *lists):
        require(torch.equal(a, b), f"11d: the pair list's {name} differs "
                "between the card and the CPU")
    me, ot, pv = (x.to(st.device) for x in lists[0][:3])
    # every bond broken and the elements moved up to 600 m (a shattered
    # raft): the listed partners come into contact
    g = torch.Generator(device=st.device).manual_seed(6)

    def moved(x):
        return x + (torch.rand(x.shape, generator=g, device=st.device)
                    - .5) * 1200.
    sm = st.replace(lon_old=moved(st.lon_old), lat_old=moved(st.lat_old),
                    bond_broken=(st.bond_idx >= 0).to(st.bond_broken.dtype))
    m = mts._pair_contact_masks(sm, me, ot, pv, cfg)
    runs = [dem.dem_contact_forces_pairs(sm, cfg, me, ot, m, valid=pv)
            for _ in range(2)]
    require(all(torch.equal(a, b) for a, b in zip(*runs)),
            "11d: the pair-list contact sums differ from run to run")
    return dict(pairs=int(pv.sum()), cap=cap,
                overflow=int(lists[0][3]), skin_dropped=int(lists[0][4]),
                engaged_rows=int((runs[0][0] != 0).sum())), (me, ot, pv)


def substep_forces_check(torch, st, grid, cfg, pcfg, pairs):
    """One substep's accelerations and bond stresses (``_substep_forces``)
    on the card and on a CPU copy, each within SUBSTEP_RTOL plus
    SUBSTEP_ATOL_SCALE of scale: where the outer step is chaotic, this
    holds the forces themselves.  Two states of the world: its bonds
    strained by moving each element up to 400 m (as the CPU tests move
    them; at a few metres of stretch one ulp of a 3 km bond length,
    where the card's and the CPU's sqrt may part, is ~1e-4 of the
    stretch), and every bond broken with the elements moved up
    to 600 m (the listed partners in contact), read on the live slots.  Three regimes: the pair list, the
    dense candidate tables (``pcfg``, no pair list) and contact through
    broken bonds only (``cfg``, K4's flags).  Returns the worst scaled
    error of each."""
    from icebergs_tpu_torch import mts
    from icebergs_tpu_torch.ops import forces
    cpu = torch.device("cpu")
    g = torch.Generator(device=st.device).manual_seed(7)

    def moved(x, r):
        return x + (torch.rand(x.shape, generator=g, device=st.device)
                    - .5) * (2. * r)
    states = {
        "strained": st.replace(lon_old=moved(st.lon_old, 400.),
                               lat_old=moved(st.lat_old, 400.)),
        "shattered": st.replace(
            lon_old=moved(st.lon_old, 600.), lat_old=moved(st.lat_old, 600.),
            bond_broken=(st.bond_idx >= 0).to(st.bond_broken.dtype))}
    regimes = (("pairs", pcfg, pairs), ("dense", pcfg, None),
               ("broken_bonds", cfg, None))
    out = {}
    for sname, s0 in states.items():
        for rname, c, pr in regimes:
            res = []
            for dev in (st.device, cpu):
                s = s0.to(dev)
                gd = grid.to(dev)
                nbr = forces.build_neighbor_tables(
                    s, gd, c, max_per_cell=MTS_MAX_PER_CELL,
                    ncells_radius=forces.neighbor_radius(gd, c))
                p = None if pr is None else tuple(x.to(dev) for x in pr)
                a = mts._substep_forces(s, nbr, c, c.dt / c.n_sub_steps,
                                        pairs=p)
                live = s.alive
                res.append([x[live].cpu() for x in (*a[:3], a[3].nstress,
                                                   a[3].sstress)])
            worst = 0.
            for name, x, y in zip(("axn", "ayn", "ang_accel", "nstress",
                                   "sstress"), *res):
                scale = max(float(y.abs().max()), 1e-30)
                require(bool(((x - y).abs() <= SUBSTEP_RTOL * y.abs()
                              + SUBSTEP_ATOL_SCALE * scale).all()),
                        f"11d: one substep's {name} ({sname}, {rname}) "
                        "differs between the card and the CPU")
                worst = max(worst, float((x - y).abs().max()) / scale)
            require(float(res[1][0].abs().max()) > 0,
                    f"11d: no substep force ({sname}, {rname})")
            out[f"{sname}_{rname}"] = worst
    return out


def kid_world(ibp, torch, device):
    """tests/test_mts_collision.py's world: two bonded 2x2 conglomerates
    of 400 m bergs in a converging jet on a 20 x 20 grid of 1 km cells."""
    import numpy as np
    from icebergs_tpu_torch.ops import forces
    cfg = ibp.IcebergsConfig(**KID_CFG)
    grid = ibp.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, device=device)
    xc = 1000. * np.arange(21)[:, None] * np.ones((1, 21))
    yc = 1000. * np.arange(21)[None, :] * np.ones((21, 1))
    vo = np.where((xc > 10e3) | (xc <= 0.) | (yc == 10e3), 0.,
                  np.where(yc > 10e3, -0.2, 0.2))
    frc = ibp.uniform_forcing(20, 20, sst=-2.0, device=device)
    frc = dataclasses.replace(frc, vo=torch.as_tensor(
        vo, dtype=torch.float32, device=device))
    side = 400.0
    lon, lat = [], []
    for cx, cy in ((5000., 8000.), (5000., 12000.)):
        for dx in (-side / 2, side / 2):
            for dy in (-side / 2, side / 2):
                lon.append(cx + dx)
                lat.append(cy + dy)
    st = ibp.create_bergs(32, lon=lon, lat=lat, mass=850. * 100 * side * side,
                          thickness=100., width=side, length=side,
                          mass_scaling=1., id_cnt=np.arange(len(lon)) + 1,
                          device=device)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = forces.initialize_bonds_host(
        st.replace(ine=i, jne=j, xi=xi, yj=yj),
        cfg.replace(length_for_manually_initialize_bonds=side * 1.2))
    require(int((st.bond_idx >= 0).sum()) == 16, "KID world: 16 bonds")
    return cfg, grid, frc, st


def phase_mts_cross(ibp, torch, device, kernels, by_path):
    """Phase 11d: card against CPU.  On phase 4b's world: 11a's scan, 11b's
    pair-list regime (the pair list itself exact, its contact sums bit for
    bit from run to run, one substep's forces within SUBSTEP_RTOL), 11c's
    coupled entry on K4's flags and on the reference's defaults, and the
    scan against K4 on the card within SCAN_K4_TOL with broken_bonds
    equal; on the
    input_MTS_KID.nml world: explicit substeps without DEM and implicit
    ones with force convergence (2 outer steps; its host syncs counted).
    Every path's kernel launches go to ``by_path``."""
    out = {}

    def counted(label, fn):
        for k in kernels.values():
            k.launches = 0
        r = fn()
        for k, fn_ in kernels.items():
            if fn_.launches:
                by_path.setdefault(k, {})[label] = fn_.launches
        return r

    cfg = dem_config(ibp, fused_fallback_cap=16384)
    grid, frc, st, deltas, n = dem_cross_world(ibp, torch, device, cfg)
    cpu = torch.device("cpu")

    def yard(label, make):
        return counted(label, lambda: cross_yardstick(
            ibp, torch, f"11d {label}", st, multi_run(ibp, grid, frc,
                                                      make)))
    out["11a_scan"] = yard("mts_cross_scan", lambda g: ibp.make_multi_step(
        g, cfg, 1, with_stats=True, **SCAN_KW))
    errs, na, nb = scan_vs_k4(ibp, torch, grid, frc, st, cfg, deltas)
    worst = max(errs, key=errs.get)
    require(na == nb, f"11d: broken_bonds scan {na} != K4 {nb}")
    require(errs[worst] <= SCAN_K4_TOL, f"11d: scan against K4: {worst} "
            f"{errs[worst]:.3e} of scale > {SCAN_K4_TOL}")
    out["scan_vs_k4"] = dict(broken_bonds=[na, nb], worst_field=worst,
                             worst_scaled_err=errs[worst], errs=errs)

    pcfg = cfg.replace(**PAIR_REGIME)
    cap, cap0, npair, sd, ov0 = pair_cap_on_evidence(
        ibp, torch, st.to(cpu), grid.to(cpu), pcfg)
    out["11b_pairs"] = yard("mts_cross_pairs",
                            lambda g: ibp.make_multi_step(
                                g, pcfg, 1, with_stats=True,
                                mts_pair_cap=cap, **SCAN_KW))
    plist, pairs = pair_list_check(ibp, torch, st, grid, pcfg, cap)
    out["pair_list"] = dict(plist, auto_cap=cap0, overflow_at_auto_cap=ov0)
    out["substep_forces"] = substep_forces_check(torch, st, grid, cfg, pcfg,
                                                 pairs)
    # two whole outer steps of the pair-list regime from one state
    step = ibp.make_step(grid, pcfg, mts_pair_cap=cap, **SCAN_KW)
    a, b = step(st, frc)[0], step(st, frc)[0]
    require(all(torch.equal(getattr(a, f), getattr(b, f))
                for f in SCAN_FIELDS + ("xi", "yj")),
            "11d: the pair-list outer step differs from run to run")

    def coupled(c):
        def run(dev, s0):
            model = ibp.IcebergsModel(grid.to(dev), c, device=dev)
            s, o = model.run(model.init_state(s0), frc.to(dev))
            return s.bergs, o.spread_mass, dict(
                mts_counters(o.mts), contact_overflow=int(o.contact_overflow),
                nbergs=int(o.nbergs))
        return run
    out["11c_coupled"] = counted("mts_cross_coupled", lambda: cross_yardstick(
        ibp, torch, "11d coupled", st, coupled(cfg)))
    # the reference's defaults through the entry: dense substep contact
    out["11c_dense_coupled"] = counted(
        "mts_cross_coupled_dense", lambda: cross_yardstick(
            ibp, torch, "11d coupled dense", st, coupled(pcfg)))

    kcfg, kgrid, kfrc, kst = kid_world(ibp, torch, device)
    for form, explicit in (("kid_explicit", True), ("kid_implicit", False)):
        c = kcfg.replace(explicit_inner_mts=explicit)
        out[form] = counted(f"mts_cross_{form}", lambda: cross_yardstick(
            ibp, torch, f"11d {form}", kst, multi_run(
                ibp, kgrid, kfrc, lambda g: ibp.make_multi_step(
                    g, c, 2, with_stats=True, with_thermo=False))))
        step = ibp.make_step(kgrid, c, with_thermo=False)
        s1, _ = step(kst, kfrc)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            _, d = step(s1, kfrc)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[form].update(host_syncs_per_outer_step=len(rec),
                         conv_iters_sync_step=d.conv_iters,
                         inner_conv_iters_sync_step=d.inner_conv_iters)
        require(len(rec) == d.conv_iters + d.inner_conv_iters,
                f"11d {form}: {len(rec)} host syncs, {d.conv_iters} + "
                f"{d.inner_conv_iters} convergence iterations: " + str(sorted(
                    {f"{pathlib.Path(r.filename).name}:{r.lineno}"
                     for r in rec})))
    return out


def phase11(ibp, torch, device, kernels, by_path, kres, dcfg, dem,
            dem_s_per_step, profile_out=None):
    """Phase 11, ROADMAP item 16: the MTS scan substep path on phase 6's
    world ``dem`` (11a-11c), K7 at the candidate tables' M = 400, and the
    card-against-CPU checks (11d).  K7's launches at M = 400 are counted
    apart from its others; each path's launches go to ``by_path`` and
    the K7 row to ``kres``."""
    from icebergs_tpu_torch.ops import forces, pack, pairs

    def fmt(x):
        return "-" if x is None else f"{x:.3f} ms"
    kernels["eval_pair_ia_kernel/m400"] = _ByM(
        pairs.eval_pair_ia_kernel, 25 * MTS_MAX_PER_CELL)
    grid6, frc6, st6 = dem[0], dem[1], dem[2]
    mts_k = ("permute_cols_u32", "extract_sorted", "segment_spread_sums")

    def mts_slice(label, cfg, **kw):
        res, launches = phase_dem_slice(
            ibp, torch, device, kernels, mts_k, cfg, dem, profile_out,
            make=lambda c, n_: ibp.make_multi_step(
                grid6, c, n_, with_stats=True, **SCAN_KW, **kw),
            label=label, profile=True)
        for k, n_ in launches.items():
            if n_:
                by_path.setdefault(k, {})[label.replace(" ", "_")] = n_
        return res

    res = mts_slice("mts scan", dcfg)
    errs, na, nb = scan_vs_k4(ibp, torch, grid6, frc6, st6, dcfg, dem[3])
    res.update(phase6_s_per_outer_step=dem_s_per_step,
               scan_vs_k4_scaled=errs, broken_bonds_scan_k4=[na, nb])
    print(f"[11a mts scan] {json.dumps(res)}")
    pcfg = dcfg.replace(**PAIR_REGIME)
    cap, cap0, npair, sd, ov0 = pair_cap_on_evidence(ibp, torch, st6,
                                                     grid6, pcfg)
    res = mts_slice("mts pairs", pcfg, mts_pair_cap=cap)
    res.update(pair_cap=cap, auto_pair_cap=cap0, pairs=npair,
               skin_dropped_at_start=sd, overflow_at_auto_cap=ov0,
               pair_list_bytes=cap * (4 + 4 + 1))
    print(f"[11b mts pairs] {json.dumps(res)}")
    torch.cuda.empty_cache()
    res, launches = phase_mts_coupled(ibp, torch, device, kernels, dcfg, dem,
                                      profile_out)
    for k, n_ in launches.items():
        if n_:
            by_path.setdefault(k, {})["mts_coupled_run"] = n_
    require(launches["eval_pair_ia_kernel/m400"] > 0
            and launches["segment_spread_sums"] > 0,
            "11c: K7 at M = 400 or K3 was not launched")
    print(f"[11c mts coupled run] {json.dumps(res)}")
    torch.cuda.empty_cache()
    # the reference's defaults through the entry, which passes no pair
    # cap: the substep contact over the dense (N, 400) candidates.  Its
    # profiled run (~240,000 kernels) takes ~150 s: only with
    # --profile-out
    res, launches = phase_mts_coupled(
        ibp, torch, device, kernels, dcfg.replace(**PAIR_REGIME), dem,
        profile_out, label="11c dense", inner=1, stem="mts_coupled_dense",
        profile=profile_out is not None)
    for k, n_ in launches.items():
        if n_:
            by_path.setdefault(k, {})["mts_coupled_dense"] = n_
    require(launches["eval_pair_ia_kernel/m400"] > 0
            and launches["segment_spread_sums"] > 0,
            "11c dense: K7 at M = 400 or K3 was not launched")
    print(f"[11c dense mts coupled run] {json.dumps(res)}")
    torch.cuda.empty_cache()
    kres["eval_pair_ia_kernel/m400"], k1t = k7_tables_case(
        ibp, torch, forces, pairs, pack, dcfg, device)
    print(f"[11 k1] {json.dumps(k1t)}")
    r = kres["eval_pair_ia_kernel/m400"]
    print(f"[11 kernel] eval_pair_ia_kernel/m400: kernel {r['ms']:.4f} "
          f"ms, plain {fmt(r['plain_ms'])}, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}), max_abs_err {r['err']} ({r['note']})")
    for tag, r in phase_mts_cross(ibp, torch, device, kernels,
                                  by_path).items():
        print(f"[11d cross-check {tag}] {json.dumps(r)}")


def ll_world(ibp, torch, n, nx, ny, device, seed=0):
    """Phase 12a's world: the headline flags with LL_CFG on a regular
    LL_DEG lat-lon grid of nx x ny cells from (0 E, LL_LAT0), periodic in
    longitude, ``n`` bergs of the headline's size seeded uniformly over
    its cells (all ocean), the swirl on the index grid."""
    import numpy as np
    cfg = headline_world(ibp, torch, 1, 4, device)[0].replace(**LL_CFG)
    grid = ibp.make_uniform_grid(nx, ny, 0., LL_LAT0, LL_DEG, LL_DEG,
                                 grid_is_latlon=True, device=device)
    frc = ibp.swirl_forcing(nx, ny, 1.0, uo=0.3, ua=5.0, sst=4.0, sss=33.0,
                            device=device)
    rng = np.random.RandomState(seed)
    lon = rng.uniform(0., nx * LL_DEG, n)
    lat = rng.uniform(LL_LAT0, LL_LAT0 + ny * LL_DEG, n)
    st = ibp.create_bergs(n, lon=lon, lat=lat,
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.0,
                          device=device)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, 360.)
    return cfg, grid, frc, st.replace(ine=i, jne=j, xi=xi, yj=yj)


def tripolar_world(ibp, torch, nx, ny, n, cap, device, seed=0):
    """Phase 12b's world, as coupled_world returns its own: the coupled
    flags (COUPLED_FL, LL_CFG, ``grid_is_regular=False``) on
    ``make_tripolar_grid(nx, ny, lat0=TRI_LAT0)`` with land south of
    TRI_LAND and on the cap's polar cells (the four top-row cells at the
    geographic pole's corners, two cells across the fold), calving into
    every ocean cell whose southern neighbour is Antarctic land, and
    ``n`` bergs in ``cap`` slots over the ocean cells from TRI_LAND to
    TRI_SEED: a cell drawn uniformly, a place in it by bilinear weights,
    located by the quad geometry; primed as phase 10a's."""
    import numpy as np
    from icebergs_tpu_torch import geometry as geo
    from icebergs_tpu_torch.grid import bilin_corner
    cfg = headline_world(ibp, torch, 1, 4, device)[0].replace(
        grid_is_regular=False, **LL_CFG, **COUPLED_FL)
    g = ibp.make_tripolar_grid(nx, ny, lat0=TRI_LAT0,
                               device=torch.device("cpu"))
    latm = g.lat_center[1:-1, 1:-1]
    ocean = latm >= TRI_LAND
    for i in (nx // 4 - 1, nx // 4, 3 * nx // 4 - 1, 3 * nx // 4):
        ocean[i, ny - 1] = False
    msk = torch.zeros_like(g.msk)
    msk[1:-1, 1:-1] = ocean.to(msk.dtype)
    grid = g.replace(msk=msk).to(device)
    coast = torch.zeros(nx + 2, ny + 2, dtype=torch.bool)
    coast[1:-1, 2:-1] = ocean[:, 1:] & ~ocean[:, :-1] & (latm[:, 1:] < 0.)
    cells = torch.nonzero(ocean & (latm < TRI_SEED)).numpy()
    rng = np.random.RandomState(seed)
    pick = cells[rng.randint(0, len(cells), n)]
    ci = torch.as_tensor(pick[:, 0], dtype=torch.int32, device=device)
    cj = torch.as_tensor(pick[:, 1], dtype=torch.int32, device=device)
    w = [torch.as_tensor(rng.uniform(0.05, 0.95, n), dtype=torch.float32,
                         device=device) for _ in range(2)]
    lon = bilin_corner(grid.lonc, ci, cj, *w, False)
    lat = bilin_corner(grid.latc, ci, cj, *w, False)
    st = ibp.create_bergs(n, lon=lon.cpu().numpy(), lat=lat.cpu().numpy(),
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.0,
                          device=device)
    xi, yj, inside = geo.pos_within_cell_curvilinear(grid, st.lon, st.lat,
                                                     ci, cj, 360.)
    require(bool(inside.all()), "12b: a seeded berg lies outside its cell")
    st = st.replace(ine=ci, jne=cj, xi=xi, yj=yj)
    frc = ibp.swirl_forcing(nx, ny, 1.0, uo=0.3, ua=5.0, sst=4.0, sss=33.0,
                            device=device)
    return (cfg, grid, frc) + prime_coupled(torch, grid, cfg, st, cap,
                                            coast.to(device), device, seed)


def in_cells(torch, grid, Lx=360.):
    """The curvilinear paths' gate: every live berg inside its cell by
    the quad test (``is_point_in_cell``)."""
    from icebergs_tpu_torch import geometry as geo

    def check(st):
        ok = geo.is_point_in_cell(grid, st.lon, st.lat, st.ine, st.jne, Lx)
        bad = int((~ok & st.alive).sum())
        require(bad == 0, f"{bad} live bergs outside their cells")
        return dict(outside_cell=bad)
    return check


def k2_latlon_row(torch, world, ab):
    """K2's lat-lon row (``fused3_ll``, BN 128) on 12a's world sorted by
    cell: ``(row, sorted state, cell starts)``."""
    from icebergs_tpu_torch.ops import extract, sorted as srt
    from icebergs_tpu_torch.ops.fused_contact import contact_features
    cfg, grid, frc, st0 = world
    st, cs = srt.sort_state_by_cell(st0, grid)
    PT, key_s = contact_features(st, grid, cfg)
    row = k2_case(torch, extract, PT, key_s, cs, grid, cfg, ab, block_n=128,
                  window=cfg.fused_window)[0]
    return row, st, cs


def k2_grouped_latlon_row(torch, dem, dcfg, radius, ab):
    """Grouped K2 lat-lon's row (``part1_ll``) on 12c's world as MTS Part
    1 runs it: the feature rows moved into (cell, id) order, block 256,
    window 512."""
    from icebergs_tpu_torch.ops import extract, sorted as srt
    from icebergs_tpu_torch.ops.fused_contact import contact_features
    from icebergs_tpu_torch.ops.pack import (from_bits, permute_cols_u32,
                                             to_bits)
    grid, frc, st = dem[:3]
    PT0, key = contact_features(st, grid, dcfg, exclude_same_group=True)
    order = srt.lex_cell_id_order(key, st.id_cnt, st.id_ij)
    PT = from_bits(permute_cols_u32(to_bits(PT0), order), PT0.dtype)
    key_s = key[order.long()]
    cs = srt.starts_from_sorted_key(key_s, grid.nx * grid.ny)
    return k2_case(torch, extract, PT, key_s, cs, grid, dcfg, ab,
                   block_n=256, window=512, radius=radius,
                   exclude_same_group=True)[0]


def ab_latlon_rows(ibp, torch, device):
    """``--ab``'s phase-12 cases: K2 lat-lon and K5 lat-lon on 12a's slab
    and grouped K2 lat-lon on 12c's, as phase 12 builds them."""
    from icebergs_tpu_torch.ops import prepass
    from icebergs_tpu_torch.ops.forces import neighbor_radius
    world = ll_world(ibp, torch, N_HEAD, LL_NX, LL_NY, device)
    row, st, cs = k2_latlon_row(torch, world, True)
    rows = {"extract_sorted/latlon": row}
    cfg, grid = world[:2]
    P, key_p = prepass.prepass_features(st, grid, cfg)
    rows["contact_prepass_sorted/latlon"] = k5_case(
        torch, prepass, P, key_p, cs, grid, cfg, True)
    del world, st, cs, P, key_p
    dcfg = dem_config(ibp, **LL_CFG)
    dem = dem_world(ibp, torch, dcfg, DEM_UNITS, NX_DEM, device, latlon=True)
    rows["extract_sorted/grouped_latlon"] = k2_grouped_latlon_row(
        torch, dem, dcfg, neighbor_radius(dem[0], dcfg), True)
    del dem
    torch.cuda.empty_cache()
    return rows


def phase12(ibp, torch, device, kernels, by_path, kres, profile_out=None):
    """Phase 12, ROADMAP item 11: 12a the persistent fused3 lane (K1, K2
    lat-lon, K3) and the persistent ``fused`` lane with K6 (K5 lat-lon)
    on the 0.25-degree lat-lon world, timed as phase 5 is with a profiled
    window; 12b ``IcebergsModel.run`` on the tripolar world, timed as
    phase 10a is; 12c phase 6's DEM world on a lat-lon grid through K4's
    lat-lon form (grouped K2 lat-lon in Part 1), timed as phase 6 is, and
    one outer step of the scan against K4; the kernel rows of K2's, K5's
    and K4's lat-lon forms; 12d card against CPU on small worlds of each.
    Each path's launches go to ``by_path``."""
    from icebergs_tpu_torch.ops import dem_substeps as k4, prepass
    from icebergs_tpu_torch.ops.prepass import prepass_features

    def fmt(x):
        return "-" if x is None else f"{x:.3f} ms"

    def count(label, launches):
        for k, n_ in launches.items():
            if n_:
                by_path.setdefault(k, {})[label] = n_

    def kernel_line(name):
        r = kres[name]
        print(f"[12 kernel] {name}: kernel {r['ms']:.4f} ms, plain "
              f"{fmt(r['plain_ms'])}, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}), max_abs_err {r['err']} ({r['note']})")

    # 12d first: card against CPU on the small worlds
    t0 = time.perf_counter()
    lw = ll_world(ibp, torch, N_CROSS, LL_CROSS_NX, LL_CROSS_NY, device,
                  seed=1)
    for tag, ckw, mkw in (("fast lane", None, None),
                          ("fused kernel-interp",
                           dict(interp_mode="kernel",
                                fused_fallback_cap=32768),
                           dict(neighbor_mode="fused"))):
        r = phase_cross(ibp, torch, device, ckw, mkw, world=lw)
        require(r["overflow"] == 0, f"12d {tag}: contact_overflow "
                f"{r['overflow']}")
        print(f"[12d cross-check latlon {tag}] {json.dumps(r)}")
    del lw
    # the tripolar coupled world at the full world's density (~5 bergs
    # an ocean cell), at phase 10a's tolerance; the positions after the
    # first step within one ulp (the card's and the CPU's cos and sin
    # round at most an ulp apart)
    r = phase_coupled_cross(ibp, torch, device, world=tripolar_world(
        ibp, torch, TRI_CROSS_NX, TRI_CROSS_NY, TRI_CROSS_N, TRI_CROSS_CAP,
        device, seed=1))
    print(f"[12d cross-check tripolar coupled] {json.dumps(r)}")
    for c in r["steps"]:
        require(c["contact_overflow"] == c["spawn_overflow"]
                == c["fl_spawn_overflow"] == 0, f"12d tripolar: overflow {c}")
    require(max(r["position_ulps_after_step1"].values()) <= 1,
            f"12d tripolar: positions after one step differ by "
            f"{r['position_ulps_after_step1']} ulps")
    lcfg = dem_config(ibp, fused_fallback_cap=16384, **LL_CFG)
    grid, frc, st, deltas, n = dem_world(
        ibp, torch, lcfg, DEM_CROSS_UNITS, NX_DEM_CROSS, device,
        gaps=(2.5e3, 3.5e3), cols=5, jitter=3.0, vel_spread=0.05, seed=1,
        latlon=True)
    r = cross_yardstick(ibp, torch, "12d dem latlon", st, multi_run(
        ibp, grid, frc, lambda g: dem_multi(ibp, g, lcfg, 1, deltas)),
        grid=grid)
    print(f"[12d cross-check dem latlon] {json.dumps(dict(elements=n, **r))}")
    print(f"[12d] {time.perf_counter() - t0:.1f} s")
    del grid, frc, st

    # 12a: the fast lanes on the lat-lon world, and K2's and K5's lat-lon
    # rows on its sorted slab
    world = ll_world(ibp, torch, N_HEAD, LL_NX, LL_NY, device)
    cfg, grid, frc, st0 = world
    kres["extract_sorted/latlon"], st, cs = k2_latlon_row(torch, world,
                                                          False)
    P, key_p = prepass_features(st, grid, cfg)
    kres["contact_prepass_sorted/latlon"] = k5_case(
        torch, prepass, P, key_p, cs, grid, cfg, False)
    del P, key_p, st, cs
    for name in ("extract_sorted/latlon", "contact_prepass_sorted/latlon"):
        kernel_line(name)
    for tag, label, ckw, mkw, names in (
            ("12a latlon fast lane", "ll_fast_lane", None, None,
             ("permute_cols_u32", "extract_sorted", "segment_spread_sums")),
            ("12a latlon persistent fused kernel-interp",
             "ll_persistent_fused_kernel", dict(interp_mode="kernel"),
             dict(neighbor_mode="fused"),
             ("contact_prepass_sorted", "interp_sorted",
              "permute_cols_u32", "segment_spread_sums"))):
        res, launches, _ = phase_path(ibp, torch, device, kernels, label,
                                      cfg_kw=ckw, multi_kw=mkw,
                                      profile_out=profile_out, world=world,
                                      profile=True)
        count(label, launches)
        print(f"[{tag}] {json.dumps(res)}")
        for k in names:
            require(launches[k] > 0, f"kernel {k} was not launched by the "
                    f"{label} path")
        require(res["host_syncs_per_step"] == 0,
                f"{label}: host syncs in a step: {res['sync_kinds']}")
    del world, st0
    torch.cuda.empty_cache()

    # 12b: the coupled entry on the tripolar grid
    t0 = time.perf_counter()
    tw = tripolar_world(ibp, torch, TRI_NX, TRI_NY, N_HEAD, COUPLED_CAP,
                        device)
    built = time.perf_counter() - t0
    res, launches = phase_coupled(ibp, torch, device, kernels, profile_out,
                                  world=tw, label="12b tripolar coupled",
                                  profile=True, check=in_cells(torch, tw[1]))
    count("tripolar_coupled_run", launches)
    res.update(world_built_s=built, grid=[TRI_NX, TRI_NY],
               ocean_cells=int(tw[1].msk.sum()),
               calving_cells=int((tw[4] > 0).sum()))
    print(f"[12b tripolar coupled run] {json.dumps(res)}")
    for k in ("permute_cols_u32", "extract_sorted", "segment_spread_sums"):
        require(launches[k] > 0, f"kernel {k} was not launched by the "
                "tripolar coupled run")
    del tw
    torch.cuda.empty_cache()

    # 12c: DEM on the lat-lon grid: K4's lat-lon form, grouped K2
    # lat-lon, then one outer step of the scan against K4
    t0 = time.perf_counter()
    dcfg = dem_config(ibp, **LL_CFG)
    dem = dem_world(ibp, torch, dcfg, DEM_UNITS, NX_DEM, device, latlon=True)
    grid, frc, st, deltas, n = dem
    from icebergs_tpu_torch.ops.forces import neighbor_radius
    radius = neighbor_radius(grid, dcfg)
    require(radius <= 4, f"12c: search radius {radius} > K2's 4")
    print(f"[12c dem latlon world] {n} elements, capacity {st.capacity}, "
          f"deltas {deltas}, radius {radius}, lat "
          f"{float(st.lat[st.alive].min()):.3f}.."
          f"{float(st.lat[st.alive].max()):.3f}, lon "
          f"{float(st.lon[st.alive].min()):.3f}.."
          f"{float(st.lon[st.alive].max()):.3f}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    # grouped K2 lat-lon as Part 1 runs it, and K4's lat-lon form
    kres["extract_sorted/grouped_latlon"] = k2_grouped_latlon_row(
        torch, dem, dcfg, radius, False)
    s4 = k4_state(torch, st, device, latlon=True)
    kres["dem_substeps/latlon"] = k4_row(torch, k4, s4, dcfg, deltas,
                                         "dem_ll", "")
    del s4
    for name in ("extract_sorted/grouped_latlon", "dem_substeps/latlon"):
        kernel_line(name)
    res, launches = phase_dem_slice(
        ibp, torch, device, kernels, (
            "permute_cols_u32", "extract_sorted", "segment_spread_sums",
            "dem_substeps"), dcfg, dem, profile_out, label="12c dem latlon",
        profile=True)
    count("ll_dem", launches)
    errs, na, nb = scan_vs_k4(ibp, torch, grid, frc, st, dcfg, deltas)
    wf = max(errs, key=errs.get)
    require(na == nb, f"12c: broken_bonds scan {na} != K4 {nb}")
    require(errs[wf] <= SCAN_K4_TOL, f"12c: scan against K4: {wf} "
            f"{errs[wf]:.3e} of scale > {SCAN_K4_TOL}")
    res.update(radius=radius, scan_vs_k4_scaled=errs,
               broken_bonds_scan_k4=[na, nb])
    print(f"[12c dem latlon] {json.dumps(res)}")
    del dem, grid, frc, st
    torch.cuda.empty_cache()


# phase 13: ROADMAP items 21 and 12, the stand-alone driver end to end
# (python -m icebergs_tpu_torch.driver): its input files written by the
# port's writers into a directory of the checkout, run through driver.run
# on the card, its output files read back by the port's readers
WORK = ROOT / "_chip_work"
DRIVER_CAP = 1 << 20
# tests/test_driver.py:14 and :132, the worlds of phase 13d
NML_DRIVER = """
&icebergs_driver_nml
  ni=20
  nj=20
  ibdt=600.0
  ibuo=0.2
  ibvo=0.0
  ibhrs=4
  nmax=1000
  saverestart=.true.
  gridres=1000.0
/

&icebergs_nml
  grid_is_latlon=.false.
  Lx=20000.
  use_f_plane=.true.
  lat_ref=0.
  Runge_not_Verlet=.false.
  use_new_predictive_corrective=.true.
  traj_sample_hrs=1.0
  set_melt_rates_to_zero=.false.
/
"""
NML_DEM = """
&icebergs_driver_nml
  ni=24
  nj=24
  ibdt=120.0
  ibuo=0.15
  ibvo=0.05
  ibhrs=1
  nmax=1000
  saverestart=.true.
  gridres=7000.0
/

&icebergs_nml
  grid_is_latlon=.false.
  Lx=-1.
  use_f_plane=.true.
  lat_ref=-55.
  Runge_not_Verlet=.false.
  mts=.true.
  mts_sub_steps=12
  dem=.true.
  explicit_inner_mts=.true.
  dem_spring_coef=5.e6
  dem_damping_coef=1.0
  interactive_icebergs_on=.true.
  iceberg_bonds_on=.true.
  spring_coef=0.00065
  contact_spring_coef=1.e-7
  contact_distance=4.e3
  use_broken_bonds_for_substep_contact=.true.
  break_bonds_on_sub_steps=.true.
  fracture_criterion='stress'
  frac_thres_n=18.e3
  frac_thres_t=100.e3
  constant_interaction_LW=.true.
  manually_initialize_bonds=.true.
  manually_initialize_bonds_from_radii=.true.
  allow_bergs_to_roll=.false.
  max_bonds=6
/
"""
# 13c: tools/run_a68.py:27's synthetic forcing files at that tool's size
# (48 x 32 nodes of 0.125 degrees from 38 W 56 S, 48 hourly frames: the
# observed files are not in the repository), and an 8 x 8 raft of 3 km
# square elements at 2r spacing drifting at 0.22 m/s (tools/run_a68.py's
# square makeberg convention) in the A68 flag set (long_run.nml's
# MTS+DEM) on the curvilinear grid, two 30-min steps: an hourly frame,
# then the half-hour blend.  In float32 degrees one ulp of longitude is
# ~1.9 m here, a strain of 6e-4 on a bond: the CPU's own one-ulp response
# reaches the whole scale of the raft's velocities within the two steps
A68_NI, A68_NJ, A68_NT, A68_LON0, A68_LAT0 = 48, 32, 48, -38.0, -56.0
A68_SIDE, A68_R = 8, 1500.0
# the history's ratio fields (a cell's sum over its spread area) are
# compared where both spread areas exceed this share of their largest: a
# berg on a cell's mid-line puts ~1e-9 of its area on the neighbour cell
# in one run and none in the other by one ulp of its position, and the
# ratio there is its whole velocity or 0
RATIO_FIELDS = ("spread_uvel", "spread_vvel", "ustar_iceberg")
SPREAD_FLOOR = 1e-6


def nml_text(drv: dict, cfg, base) -> str:
    """An input.nml: the driver stanza ``drv`` and every field of ``cfg``
    that differs from ``base`` (the config's defaults)."""
    def fmt(v):
        if isinstance(v, bool):
            return ".true." if v else ".false."
        if isinstance(v, str):
            return f"'{v}'"
        if isinstance(v, (tuple, list)):
            return ", ".join(fmt(x) for x in v)
        return repr(v)
    lines = ["&icebergs_driver_nml"]
    lines += [f"  {k}={fmt(v)}" for k, v in drv.items()]
    lines += ["/", "&icebergs_nml"]
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v != getattr(base, f.name):
            lines.append(f"  {f.name}={fmt(v)}")
    return "\n".join(lines + ["/", ""])


def driver_inputs(ibp, d, drv, cfg, st, bonds=False):
    """Write ``d``: the namelist (checked to parse back into ``cfg``)
    and the initial state's restart(s), by the port's writers."""
    import shutil
    from icebergs_tpu_torch.io import namelist, restart
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "input.nml").write_text(nml_text(drv, cfg, ibp.IcebergsConfig()))
    back, _ = namelist.config_from_namelist(str(d / "input.nml"))
    require(dataclasses.asdict(back) == dataclasses.asdict(cfg.normalized(
        warn=False)), f"{d.name}: the namelist does not give the config")
    restart.write_restart_bergs(str(d / "icebergs.res.nc"), st, cfg)
    if bonds:
        restart.write_restart_bonds(str(d / "bonds_iceberg.res.nc"), st,
                                    cfg)


@functools.lru_cache(maxsize=None)
def _make_step_orig():
    from icebergs_tpu_torch import model
    return model.make_step


class WatchedSteps:
    """Within ``with``: every step the driver builds (``model.make_step``)
    counts the host syncs inside it (torch's sync debug mode) and keeps
    its last ``StepDiags``."""

    def __init__(self, torch):
        self.torch, self.calls, self.syncs, self.kinds = torch, 0, 0, set()
        self.last = None

    def __enter__(self):
        from icebergs_tpu_torch import model
        orig, torch = _make_step_orig(), self.torch

        def make_step(*a, **k):
            step = orig(*a, **k)

            def watched(*sa, **sk):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings(record=True) as rec:
                        warnings.simplefilter("always")
                        out = step(*sa, **sk)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                self.calls += 1
                self.syncs += len(rec)
                self.kinds |= {f"{pathlib.Path(r.filename).name}:{r.lineno}"
                               for r in rec}
                self.last = out[1]
                return out
            return watched
        model.make_step = make_step
        return self

    def __exit__(self, *exc):
        from icebergs_tpu_torch import model
        model.make_step = _make_step_orig()


def run_driver(ibp, torch, d, out, kernels=None, **kw):
    """driver.run on the card from input directory ``d``: (final state,
    the driver's report, the watched steps, launches per kernel, peak
    GB)."""
    from icebergs_tpu_torch import driver
    if kernels:
        for fn in kernels.values():
            fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rep = {}
    with WatchedSteps(torch) as w:
        st = driver.run(str(d / "input.nml"), str(d), str(out),
                        verbose=False, device="cuda", report=rep, **kw)
    torch.cuda.synchronize()
    launches = ({k: fn.launches for k, fn in kernels.items()}
                if kernels else {})
    return st, rep, w, launches, torch.cuda.max_memory_allocated() / 1e9


def restart_fields(cfg):
    from icebergs_tpu_torch.io import restart
    v = list(restart.BERG_VARS)
    v += restart.FL_VARS if cfg.footloose else []
    v += restart.MTS_VARS if cfg.mts else []
    v += restart.DEM_VARS if cfg.dem else []
    return v


def check_restart_file(ibp, torch, path, st, cfg, grid):
    """The restart at ``path`` holds the state's live slots bit for bit,
    and the port's reader gives them back (its cells re-localised:
    returns the count that differ from the state's)."""
    import numpy as np
    from scipy.io import netcdf_file
    from icebergs_tpu_torch.io import restart
    S = ibp.to_numpy(st)
    live = np.nonzero(S["alive"] & (S["halo_berg"] < 0.5))[0]
    with netcdf_file(str(path), "r", mmap=False) as f:
        for name, field, kind in restart_fields(cfg):
            v = np.asarray(f.variables[name][:])
            want = S[field][live] + (1 if field in ("ine", "jne") else 0)
            require(np.array_equal(v, want.astype(v.dtype)) and np.array_equal(
                v.astype(S[field].dtype), want), f"{path.name}: {name} is "
                "not the state's")
    back = ibp.to_numpy(restart.read_restart_bergs(
        str(path), st.capacity, grid, cfg))
    n = len(live)
    for name, field, kind in restart_fields(cfg):
        if field not in ("ine", "jne"):
            require(np.array_equal(back[field][:n], S[field][live]),
                    f"{path.name}: {field} read back differs")
    return int(((back["ine"][:n] != S["ine"][live])
                | (back["jne"][:n] != S["jne"][live])).sum())


def check_outputs(ibp, torch, out, cfg, grid, st):
    """Every output file opens; the restart is the state's, bit for bit,
    and reads back; the calving restart reads back; the trajectory and
    history files hold finite values.  Returns {file: bytes}."""
    import numpy as np
    from scipy.io import netcdf_file
    from icebergs_tpu_torch import calving
    from icebergs_tpu_torch.io import restart
    sizes = {p.name: p.stat().st_size for p in sorted(out.iterdir())}
    res = dict(relocalised_cells_differ=check_restart_file(
        ibp, torch, out / "icebergs.res.nc", st, cfg, grid))
    restart.read_restart_calving(str(out / "calving.res.nc"),
                                 calving.init_calving_state(grid), grid)
    for name in sizes:
        if name.endswith(".res.nc"):
            continue
        with netcdf_file(str(out / name), "r", mmap=False) as f:
            for k, v in f.variables.items():
                require(bool(np.isfinite(np.asarray(v[:])).all()),
                        f"{name}: {k} is not finite")
    return res, sizes


def phase13a(ibp, torch, device, kernels):
    """13a: the driver on the headline world (bench.py:43-72's 1M bergs
    on 512 x 512 cells of 2 km, uniform forcing: the driver has no
    swirl) at capacity 2^20, 24 steps of 600 s with an hourly trajectory
    sample and the restart written; 13a': 12 steps, the restart, 12
    more, against the 24.  Returns (result, launches)."""
    import shutil
    import numpy as np
    from icebergs_tpu_torch.diag import berg_chksum
    cfg, grid, _, st = headline_world(ibp, torch, N_HEAD, NX_HEAD, device)
    cfg = cfg.replace(traj_sample_hrs=1.0)
    drv = dict(ni=NX_HEAD, nj=NX_HEAD, gridres=DXY, ibdt=600.0, ibuo=0.3,
               ibua=5.0, sst=4.0, ibhrs=4, saverestart=True)
    d = WORK / "13a"
    driver_inputs(ibp, d, drv, cfg, st)
    del st
    t0 = time.perf_counter()
    s, rep, w, launches, peak = run_driver(ibp, torch, d, d / "out",
                                           kernels, capacity=DRIVER_CAP)
    wall = time.perf_counter() - t0
    last = w.last
    require(int(last.contact_overflow) == 0, "13a: contact_overflow "
            f"{int(last.contact_overflow)} after the driver's growth")
    n_alive = int(s.count())
    require(n_alive == N_HEAD, f"13a: {n_alive} bergs of {N_HEAD}")
    require(w.syncs == 0, f"13a: host syncs in a step: {sorted(w.kinds)}")
    for k in ("permute_cols_u32", "extract_sorted", "segment_spread_sums"):
        require(launches[k] > 0, f"13a: kernel {k} was not launched")
    chk, _ = berg_chksum(s)
    outs, sizes = check_outputs(ibp, torch, d / "out", cfg, grid, s)
    res = dict(steps=rep["steps"], s_per_step=rep["loop_s"] / rep["steps"],
               loop_s=rep["loop_s"], io_write_s=rep["io_s"],
               run_wall_s=wall, host_reads_per_step=rep["host_reads"]
               / rep["steps"], host_syncs_in_steps=w.syncs,
               step_calls=w.calls, peak_gb=peak, berg_chksum=int(chk),
               alive=n_alive, file_bytes=sizes, contact_overflow=0,
               launches={k: launches[k] for k in (
                   "permute_cols_u32", "pack_rows_u32", "gather_rows_u32",
                   "extract_sorted", "segment_spread_sums")}, **outs)

    # 13a': the same run cut by a restart
    h = WORK / "13a_half"
    shutil.rmtree(h, ignore_errors=True)
    h.mkdir(parents=True)
    shutil.copy(d / "icebergs.res.nc", h / "icebergs.res.nc")
    half = nml_text(dict(drv, ibhrs=2), cfg, ibp.IcebergsConfig())
    (h / "input.nml").write_text(half)
    kw = dict(capacity=DRIVER_CAP, cfg_overrides=dict(ignore_traj=True))
    run_driver(ibp, torch, h, h / "b", **kw)
    (h / "b" / "input.nml").write_text(half)
    s2, *_ = run_driver(ibp, torch, h / "b", h / "c", **kw)
    A, B = ibp.to_numpy(s), ibp.to_numpy(s2)
    differ = {}
    for name, v in A.items():
        bad = (v != B[name]) & ~(np.isnan(v) & np.isnan(B[name])) \
            if v.dtype.kind == "f" else v != B[name]
        if bad.any():
            rows = bad if bad.ndim == 1 else bad.any(axis=1)
            differ[name] = (int(rows.sum()), float(np.abs(
                v.astype(np.float64) - B[name]).max()))
    chk2, _ = berg_chksum(s2)
    # the restart re-localises every berg by pos_to_cell (it holds no
    # xi / yj), an ulp from the walk's fractions: the JAX package's runs
    # part too (ROADMAP.md Queue 3, tests/test_torch_driver.py::
    # test_restart_relocalisation_is_not_exact), so the bergs that differ
    # and the worst error of each field are reported; ids, liveness and
    # the berg count must agree
    lon = A["lon"]
    res["exact_restart"] = dict(
        bitwise=not differ, fields_differing=differ,
        bergs_differing=int((lon != B["lon"]).sum()),
        worst_lon_ulps=int(np.abs(lon.view(np.int32).astype(np.int64)
                                  - B["lon"].view(np.int32)).max()),
        berg_chksum_24=int(chk), berg_chksum_12_12=int(chk2))
    for name in ("alive", "id_cnt", "id_ij"):
        require(name not in differ, f"13a': {name} differs after the "
                "restart")
    shutil.rmtree(d)
    shutil.rmtree(h)
    return res, launches


def phase13b(ibp, torch, device, kernels, dcfg):
    """13b: phase 6's DEM world (tools/bench_dem_1m.py:27-112, 999,944
    bonded elements) through the driver: its restarts written by the
    port, 2 outer steps with the substep kernel the driver picks (K4 on
    the card), the bond tables through write and read; then the same
    world's bonds formed once by manually_initialize_bonds on the native
    library.  Returns (result, launches)."""
    import shutil
    import numpy as np
    from icebergs_tpu_torch.io import restart
    from icebergs_tpu_torch.ops import forces
    grid, _, st, _, n = dem_world(ibp, torch, dcfg, DEM_UNITS, NX_DEM,
                                  device)
    drv = dict(ni=NX_DEM, nj=NX_DEM, gridres=DXY_DEM, ibdt=600.0, ibuo=0.25,
               ibvo=0.05, ibua=5.0, sst=-2.0, ibhrs=1, nmax=DEM_INNER,
               saverestart=True)
    d = WORK / "13b"
    t0 = time.perf_counter()
    driver_inputs(ibp, d, drv, dcfg, st, bonds=True)
    t_write = time.perf_counter() - t0

    # the bond tables through write and read, bit for bit: the reader
    # packs the live elements to the front in slot order
    t0 = time.perf_counter()
    back = restart.read_restart_bonds(
        str(d / "bonds_iceberg.res.nc"), restart.read_restart_bergs(
            str(d / "icebergs.res.nc"), DRIVER_CAP, grid, dcfg), dcfg)
    t_read = time.perf_counter() - t0
    S, B = ibp.to_numpy(st), ibp.to_numpy(back)
    live = np.nonzero(S["alive"])[0]
    rank = np.full(st.capacity, -1, np.int64)
    rank[live] = np.arange(len(live))
    bi = S["bond_idx"][live]
    require(np.array_equal(np.where(bi >= 0, rank[np.maximum(bi, 0)], -1),
                           B["bond_idx"][:len(live)]),
            "13b: bond partners differ after write and read")
    for f in ("bond_broken", "bond_tangd1", "bond_tangd2", "bond_nstress",
              "bond_sstress", "bond_rel_rotation", "n_bonds"):
        require(np.array_equal(S[f][live], B[f][:len(live)]),
                f"13b: {f} differs after write and read")
    del back, B

    s, rep, w, launches, peak = run_driver(ibp, torch, d, d / "out",
                                           kernels, capacity=DRIVER_CAP)
    last = w.last
    require(launches["dem_substeps"] > 0, "13b: the driver did not pick K4")
    require(int(last.p1_overflow) == 0,
            f"13b: p1_overflow {int(last.p1_overflow)}")
    require(int(s.count()) == n, f"13b: {int(s.count())} elements of {n}")
    outs, sizes = check_outputs(ibp, torch, d / "out", dcfg, grid, s)
    res = dict(elements=n, capacity=s.capacity, outer_steps=rep["steps"],
               s_per_outer_step=rep["loop_s"] / rep["steps"],
               io_write_s=rep["io_s"], restart_write_s=t_write,
               restart_read_s=t_read, host_reads_per_outer_step=rep[
                   "host_reads"] / rep["steps"],
               host_syncs_per_outer_step=w.syncs / rep["steps"],
               conv_iters=last.conv_iters, p1_overflow=0,
               broken_bonds=int(last.broken_bonds), peak_gb=peak,
               bond_restart_bytes=sizes["bonds_iceberg.res.nc"],
               file_bytes=sizes,
               launches={k: launches[k] for k in (
                   "permute_cols_u32", "extract_sorted",
                   "segment_spread_sums", "dem_substeps")}, **outs)
    del s

    # the world's bonds formed by the native library, partner ids against
    # the replicated prototype's
    bare = st.replace(bond_idx=torch.full_like(st.bond_idx, -1))
    t0 = time.perf_counter()
    formed = forces.initialize_bonds_host(bare, dcfg)
    res["native_bond_init_s"] = time.perf_counter() - t0
    ids = S["id_cnt"]

    def partner_ids(bidx):
        return np.sort(np.where(bidx >= 0, ids[np.maximum(bidx, 0)], 0),
                       axis=1)[live]
    F = formed.bond_idx.cpu().numpy()
    require(np.array_equal(partner_ids(F), partner_ids(S["bond_idx"])),
            "13b: the native bond formation's partners differ from "
            "dem_world's")
    res["native_bonds"] = int((F >= 0).sum())
    shutil.rmtree(d)
    return res, launches


def write_a68_synthetic(d):
    """tools/run_a68.py:27's schema-identical synthetic forcing (a
    rotating wind over a sheared ocean jet) at that tool's size."""
    import numpy as np
    from scipy.io import netcdf_file
    from icebergs_tpu_torch.io import a68
    ni, nj, nt = A68_NI, A68_NJ, A68_NT
    lon = A68_LON0 + a68.GRES * np.arange(ni)
    lat = A68_LAT0 + a68.GRES * np.arange(nj)
    with netcdf_file(str(d / a68.GRID_FILE), "w") as f:
        f.createDimension("lon", ni)
        f.createDimension("lat", nj)
        L, T = np.meshgrid(lon, lat, indexing="ij")
        f.createVariable("longitude", "d", ("lon", "lat"))[:] = L
        f.createVariable("latitude", "d", ("lon", "lat"))[:] = T
    t = np.arange(nt)[:, None, None]
    Y = np.linspace(0, 1, nj)[None, None, :]

    def write3(fname, fields):
        with netcdf_file(str(d / fname), "w") as f:
            f.createDimension("time", nt)
            f.createDimension("lon", ni)
            f.createDimension("lat", nj)
            for name, arr in fields.items():
                f.createVariable(name, "d", ("time", "lon", "lat"))[:] = \
                    arr * np.ones((nt, ni, nj))
    write3(a68.WIND_FILE, {"ua": 6. * np.cos(2 * np.pi * t / 24.),
                           "va": 6. * np.sin(2 * np.pi * t / 24.)})
    write3(a68.OCEAN_FILE, {"uo": 0.3 * np.sin(np.pi * Y) * np.ones_like(t),
                            "vo": 0.05 * np.ones((nt, ni, nj))})
    write3(a68.SSH_FILE, {"SSH": 0.05 * np.sin(np.pi * Y)
                          * np.cos(2 * np.pi * t / 48.)})
    return lon[0] + 360. + 0.5 * a68.GRES * ni, lat[0] + 0.5 * a68.GRES * nj


def a68_config(ibp):
    """The A68 flag set (tools/run_a68.py:80-106's long run) on the
    curvilinear grid, with 180 substeps of 10 s (phase 6's substep),
    elastic: once bonds fracture, one ulp decides which break first and
    the card's and the CPU's runs part (phase 4b keeps its world
    elastic for that reason)."""
    return ibp.IcebergsConfig(
        grid_is_latlon=True, grid_is_regular=False, Lx=360., dt=1800.,
        Runge_not_Verlet=False, mts=True, mts_sub_steps=180,
        explicit_inner_mts=True, dem=True, dem_spring_coef=5.e6,
        dem_damping_coef=1.0, poisson=0.3, interactive_icebergs_on=True,
        iceberg_bonds_on=True, spring_coef=0.00065359477124183,
        contact_spring_coef=1.e-7, contact_distance=4.e3,
        force_convergence=True, convergence_tolerance=1e-4,
        use_broken_bonds_for_substep_contact=True,
        break_bonds_on_sub_steps=True, constant_interaction_LW=True,
        fracture_criterion="stress", frac_thres_scaling=1.,
        frac_thres_n=1.e12, frac_thres_t=1.e12,
        manually_initialize_bonds=True,
        manually_initialize_bonds_from_radii=True,
        allow_bergs_to_roll=False, max_bonds=6,
        hexagonal_icebergs=False).normalized(warn=False)


def driver_yardstick(ibp, torch, label, d, dem, max_grazed=0, **kw):
    """The driver from input directory ``d`` on the card and on the CPU:
    every integer of the final state and of every output file exact;
    floats within phase 4's tolerance (``dem``: within
    DEM_CROSS_ULP_FACTOR times the CPU's own response to every other
    element's longitude one ulp larger, or DEM_CROSS_FLOOR of scale, as
    phase 4b holds the DEM step).  The history's ratio fields on the cells with a
    spread area in both runs, and but for at most ``max_grazed`` cells
    whose step-averaged spread area agrees (where a footprint grazes a
    cell edge in one step, an ulp puts ~1e-9 of its area on the
    neighbour cell in one run and none in the other, and that step's
    ratio there is the berg's whole velocity or 0)."""
    import shutil
    import numpy as np
    from scipy.io import netcdf_file
    from icebergs_tpu_torch import driver

    def run(dev, src, out):
        # the CPU runs K4's plain version where the card picks K4
        sk = "auto" if dev == "cuda" else "vmem"
        return ibp.to_numpy(driver.run(str(src / "input.nml"), str(src),
                                       str(out), verbose=False, device=dev,
                                       substep_kernel=sk, **kw))
    outs = [d / "o_card", d / "o_cpu"]
    runs = {"cuda": run("cuda", d, outs[0]), "cpu": run("cpu", d, outs[1])}
    if dem:
        u = d.parent / f"{d.name}_ulp"
        shutil.rmtree(u, ignore_errors=True)
        shutil.copytree(d, u, ignore=shutil.ignore_patterns("o_*"))
        with netcdf_file(str(d / "icebergs.res.nc"), "r", mmap=False) as f:
            data = {k: np.array(v[:]) for k, v in f.variables.items()}
        with netcdf_file(str(u / "icebergs.res.nc"), "w") as f:
            f.createDimension("i", len(data["lon"]))
            for k, v in data.items():
                if k == "lon":
                    # every other element: a shift of all would keep the
                    # lattice's symmetry, which the roundings do not
                    up = np.nextafter(v.astype(np.float32),
                                      np.float32(np.inf)).astype(np.float64)
                    v = np.where(np.arange(len(v)) % 2 == 0, up, v)
                f.createVariable(k, v.dtype.char, ("i",))[:] = v
        outs.append(u / "o_cpu")
        runs["ulp"] = run("cpu", u, outs[2])

    def floats_ok(a, b, p, name):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not b.size:
            return 0.
        scale = max(np.abs(b).max(), 1e-30)
        err = float(np.abs(a - b).max() / scale)
        if p is None:
            tol = CROSS_RTOL * np.abs(b) + CROSS_ATOL_SCALE * scale
            require(bool(np.all(np.abs(a - b) <= tol)),
                    f"{label}: {name} beyond phase 4's tolerance "
                    f"({err:.3e} of scale)")
        else:
            ulp = float(np.abs(np.asarray(p, np.float64) - b).max() / scale)
            require(err <= max(DEM_CROSS_ULP_FACTOR * ulp, DEM_CROSS_FLOOR),
                    f"{label}: {name} {err:.3e} of scale beyond the one-ulp "
                    f"yardstick ({ulp:.3e})")
        return err

    def grazed(G, C, P, k, name):
        scale = max(np.abs(C[k]).max(), 1e-30)
        ulp = (0. if P is None else
               float(np.abs(P[k] - C[k]).max() / scale))
        off = np.abs(G[k] - C[k]) > max(DEM_CROSS_ULP_FACTOR * ulp,
                                        DEM_CROSS_FLOOR) * scale
        require(int(off.sum()) <= max_grazed, f"{label}: {name} differs "
                f"on {int(off.sum())} cells > {max_grazed}")
        area = [None if x is None else x["spread_area"] for x in (G, C, P)]
        floats_ok(area[0][off], area[1][off],
                  None if P is None else area[2][off], f"{name}'s area")
        grazed_cells[name] = int(off.sum())
        return off

    grazed_cells = {}
    g, c, p = runs["cuda"], runs["cpu"], runs.get("ulp")
    alive = c["alive"]
    worst = {}
    for name, v in c.items():
        if v.dtype.kind != "f":
            require(np.array_equal(g[name], v), f"{label}: {name} differs "
                    "between the card and the CPU")
            continue
        worst[name] = floats_ok(g[name][alive], v[alive],
                                None if p is None else p[name][alive], name)
    files = sorted(q.name for q in outs[1].iterdir())
    require(files == sorted(q.name for q in outs[0].iterdir()),
            f"{label}: the card and the CPU wrote other files")
    for fname in files:
        F = [None] * 3
        for n_, o in enumerate(outs):
            with netcdf_file(str(o / fname), "r", mmap=False) as f:
                F[n_] = {k: np.array(v[:]) for k, v in f.variables.items()}
        G, C, P = F
        require(list(G) == list(C), f"{label}: {fname}'s variables differ")
        keep = None
        if "spread_area" in C:
            a = np.minimum(C["spread_area"], G["spread_area"])
            keep = a > SPREAD_FLOOR * max(C["spread_area"].max(), 1e-30)
        for k, v in C.items():
            if k == "list_chksum":
                continue            # a hash of every bit of the state
            if v.dtype.kind != "f":
                require(np.array_equal(G[k], v), f"{label}: {fname} {k} "
                        "differs between the card and the CPU")
                continue
            sel = keep if (keep is not None and k in RATIO_FIELDS) else \
                np.ones(v.shape, bool)
            if max_grazed and keep is not None and k in RATIO_FIELDS:
                sel = sel & ~grazed(G, C, P, k, f"{fname} {k}")
            worst[f"{fname}:{k}"] = floats_ok(
                G[k][sel], v[sel], None if P is None else P[k][sel],
                f"{fname} {k}")
    top = max(worst, key=worst.get)
    if dem:
        shutil.rmtree(outs[2].parent)
    res = dict(worst_field=top, worst_scaled_err=worst[top],
               bitwise=all(np.array_equal(g[k], c[k]) for k in c),
               alive=int(alive.sum()))
    if max_grazed:
        res.update(grazed_cells=grazed_cells)
    return res


def phase13c(ibp, torch, device, kernels):
    """13c: the A68 transient branch (the hourly frames and the half-hour
    blend) with MTS+DEM on the curvilinear grid, card against CPU (K4's
    plain version on the CPU).  Returns (result, launches)."""
    import shutil
    import numpy as np
    from icebergs_tpu_torch.io import a68
    d, dd = WORK / "13c", WORK / "13c_data"
    shutil.rmtree(dd, ignore_errors=True)
    dd.mkdir(parents=True)
    lon_c, lat_c = write_a68_synthetic(dd)
    cfg = a68_config(ibp)
    data = a68.load_a68(str(dd), cfg, device=torch.device("cpu"))
    # square elements at 2r, metres to degrees at each element's latitude
    k = (np.arange(A68_SIDE) - 0.5 * (A68_SIDE - 1)) * 2 * A68_R
    px, py = np.meshgrid(k, k, indexing="ij")
    mlat = 1. / ((np.pi / 180.) * cfg.Rearth)
    lat = lat_c + py.ravel() * mlat
    lon = lon_c + px.ravel() * mlat / np.cos(np.radians(lat))
    n = lon.size
    st = ibp.create_bergs(128, lon=lon, lat=lat, uvel=np.full(n, 0.22),
                          mass=850. * 200. * (2 * A68_R) ** 2,
                          thickness=200., width=2 * A68_R,
                          length=2 * A68_R, mass_scaling=1.,
                          id_cnt=np.arange(n) + 1, max_bonds=6,
                          device=torch.device("cpu"))
    i, j, xi, yj = ibp.pos_to_cell(data.grid, st.lon, st.lat, 360.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    drv = dict(a68_test=True, transient_a68_data_start_ind=2,
               data_dir=f"{dd}/", ibdt=1800., ibhrs=1, saverestart=True)
    driver_inputs(ibp, d, drv, cfg, st)
    for fn in kernels.values():
        fn.launches = 0
    with WatchedSteps(torch) as w:
        r = driver_yardstick(ibp, torch, "13c a68", d, True, capacity=128)
    launches = {k_: fn.launches for k_, fn in kernels.items()}
    require(launches["dem_substeps"] > 0,
            "13c: the driver did not pick K4 on the card")
    r.update(elements=n, launches={k_: v for k_, v in launches.items()
                                    if v}, host_syncs_in_steps=w.syncs)
    shutil.rmtree(d)
    shutil.rmtree(dd)
    return r, launches


def phase13d(ibp, torch, device):
    """13d: the driver on tests/test_driver.py:14's NML world and :132's
    DEM_NML world, card against CPU, the CPU running K4's plain version
    where the card runs K4."""
    import shutil
    import numpy as np
    from icebergs_tpu_torch.io import namelist, restart
    from icebergs_tpu_torch.ops import forces
    out = {}
    cpu = torch.device("cpu")
    for name, text in (("nml", NML_DRIVER), ("dem_nml", NML_DEM)):
        d = WORK / f"13d_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "input.nml").write_text(text)
        cfg, _ = namelist.config_from_namelist(str(d / "input.nml"))
        if name == "nml":
            grid = ibp.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                         grid_is_latlon=False, device=cpu)
            st = ibp.create_bergs(64, lon=[5000., 9000., 13000.],
                                  lat=[9500., 10500., 9000.],
                                  mass=850. * 20 * 100 * 100, thickness=20.,
                                  width=100., length=100., mass_scaling=1.,
                                  device=cpu)
        else:
            grid = ibp.make_uniform_grid(24, 24, 0., 0., 7000., 7000.,
                                         grid_is_latlon=False, device=cpu)
            r = 1500.0
            px, py = np.meshgrid(np.arange(4) * 2 * r, np.arange(4) * 2 * r,
                                 indexing="ij")
            st = ibp.create_bergs(64, lon=px.ravel() + 30000.,
                                  lat=py.ravel() + 40000.,
                                  mass=850. * 200. * (2 * r) ** 2,
                                  thickness=200., width=2 * r, length=2 * r,
                                  mass_scaling=1., id_cnt=np.arange(16) + 1,
                                  max_bonds=6, device=cpu)
        i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.)
        st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
        if name == "dem_nml":
            st = forces.count_bonds(forces.initialize_bonds_host(st, cfg))
            restart.write_restart_bonds(str(d / "bonds_iceberg.res.nc"),
                                        st, cfg)
        restart.write_restart_bergs(str(d / "icebergs.res.nc"), st, cfg)
        out[name] = driver_yardstick(ibp, torch, f"13d {name}", d,
                                     name == "dem_nml", capacity=64)
        shutil.rmtree(d)
    return out


def phase13(ibp, torch, device, kernels, by_path):
    """Phase 13, ROADMAP items 21 and 12: the driver at full width (13a,
    13a', 13b) and card against CPU (13c, 13d); the timed paths'
    launches go to ``by_path``."""
    import shutil
    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        r = phase13d(ibp, torch, device)
        print(f"[13d driver cross-check] {json.dumps(r)}")
        r, launches = phase13c(ibp, torch, device, kernels)
        print(f"[13c a68 driver] {json.dumps(r)}")
        r, launches = phase13a(ibp, torch, device, kernels)
        for k, n in launches.items():
            if n:
                by_path.setdefault(k, {})["driver_headline"] = n
        print(f"[13a driver headline] {json.dumps(r)}")
        torch.cuda.empty_cache()
        r, launches = phase13b(ibp, torch, device, kernels,
                               dem_config(ibp))
        for k, n in launches.items():
            if n:
                by_path.setdefault(k, {})["driver_dem"] = n
        print(f"[13b driver dem] {json.dumps(r)}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[13 phase] {time.perf_counter() - t0:.1f} s")


# phase 14: ROADMAP item 22, hexagonal elements.  14a the headline world
# with hexagonal_icebergs (make_multi_step's persistent fused3 lane; the
# spreading through the slot sums on the presorted slab, K3's
# pass-through, never K3); 14b phase 6's world hexagonally packed (2,066
# units of 22 x 22, 999,944 elements 2r = 3 km apart: hexagons of apothem
# r = 1.5 km, area 2 sqrt(3) r^2, side HEX_SIDE, so that neighbours touch
# and every bond starts at its rest length; the bonding radius 1.25 x 2r =
# 3.75 km bonds six neighbours, the units' gaps stay beyond 4 km; hexagons
# of the square world's 9 km^2 would overlap by 224 m, and every bond
# would break in the first outer step) with the radius-based faces, K4's
# hexagonal form (dem_hex); 14c card against CPU: 14a's flags on
# the phase-4 world, 14b's on 20 units (as 4b), and the driver on
# input_MTS_KID.nml (tests/test_torch_io.py's MTS_KID_NML, 4 hours with
# restarts and hourly trajectories) on two seven-element hexagonal rafts
# either side of the converging jet
HEX_KW = dict(hexagonal_icebergs=True)
HEX_SIDE = (2. * 3. ** 0.5) ** 0.5 * DEM_R        # 2,791.8 m
HEX_DEM_KW = dict(hexagonal_icebergs=True, radius_based_drag=True,
                  constant_length=HEX_SIDE, constant_width=HEX_SIDE)
NML_MTS_KID = """
&icebergs_driver_nml
  ni=20
  nj=20
  ibdt=3600.0
  ibvo=0.2
  collision_test=.true.
  ibhrs=4
  saverestart=.true.
/
&icebergs_nml
  grid_is_latlon=.false.
  Lx=20000.
  use_f_plane=.true.
  lat_ref=0.
  Runge_not_Verlet=.false.
  mts=.true.
  mts_sub_steps=60
  explicit_inner_mts=.true.
  force_convergence=.true.
  convergence_tolerance=1.d-8
  contact_distance=1.75e3
  contact_spring_coef=1.e-7
  hexagonal_icebergs=.true.
  interactive_icebergs_on=.true.
  iceberg_bonds_on=.true.
  spring_coef=1.e-5
  critical_interaction_damping_on=.true.
  allow_bergs_to_roll=.false.
  set_melt_rates_to_zero=.true.
  max_bonds=6
  traj_sample_hrs=1.
  traj_name='kid_traj.nc'   ! a string
  initial_mass=8.8e7, 4.1e8, 3.3e9, 1.8e10, 3.8e10, 7.5e10, 1.2e11, 2.2e11, 3.9e11, 7.4e11
  no_such_setting=3
/
"""
KID_SIDE = 400.            # the rafts' elements: width and length (m)
KID_MAX_GRAZED = 2


def hex_geometry_profile(torch, sp, st, grid, cfg):
    """The hexagon spreading weights of ``st`` (the quadrant clipping
    and, with bonds, the bond orientation) profiled once: (device ms,
    kernels)."""
    return profile_window(torch, lambda: sp.spread_weights(st, grid, cfg),
                          None, "hex_geometry")


def kid_rafts(ibp, torch, d):
    """Two seven-element hexagonal rafts (a centre and its six
    neighbours, two apothems apart: touching) 2 km either side of the
    jet's midline, bonded by the radius criterion; the namelist, the
    restart and the bond file written into ``d`` by the port."""
    import math
    import shutil
    import numpy as np
    from icebergs_tpu_torch.io import namelist, restart
    from icebergs_tpu_torch.ops import forces
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "input.nml").write_text(NML_MTS_KID)
    cfg, _ = namelist.config_from_namelist(str(d / "input.nml"))
    require(cfg.hexagonal_icebergs and cfg.mts, "14c: MTS_KID flags")
    cpu = torch.device("cpu")
    grid = ibp.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, device=cpu)
    rh = math.sqrt(KID_SIDE * KID_SIDE / (2. * math.sqrt(3.)))
    ring = [(0., 0.)] + [(2 * rh * math.cos(math.pi / 3 * k + math.pi / 6),
                          2 * rh * math.sin(math.pi / 3 * k + math.pi / 6))
                         for k in range(6)]
    lon, lat = [], []
    for cx, cy in ((5000., 8000.), (5200., 12000.)):
        lon += [cx + dx for dx, _ in ring]
        lat += [cy + dy for _, dy in ring]
    n = len(lon)
    st = ibp.create_bergs(32, lon=lon, lat=lat,
                          mass=850. * 100 * KID_SIDE * KID_SIDE,
                          thickness=100., width=KID_SIDE, length=KID_SIDE,
                          mass_scaling=1., id_cnt=np.arange(n) + 1,
                          max_bonds=6, device=cpu)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.)
    st = forces.count_bonds(forces.initialize_bonds_host(
        st.replace(ine=i, jne=j, xi=xi, yj=yj),
        cfg.replace(manually_initialize_bonds_from_radii=True)))
    require(int((st.bond_idx >= 0).sum()) == 48, "14c: the rafts' bonds")
    restart.write_restart_bergs(str(d / "icebergs.res.nc"), st, cfg)
    restart.write_restart_bonds(str(d / "bonds_iceberg.res.nc"), st, cfg)
    return n


def phase14(ibp, torch, device, kernels, by_path, kres, profile_out=None):
    """Phase 14, ROADMAP item 22: 14c card against CPU first, then 14a
    the hexagonal fast lane, timed as phase 5 is with a profiled window
    and the hexagon geometry's own kernels and device time at 1M bergs,
    and 14b the hexagonal DEM world timed as phase 6 is, K4's ``F_HEX``
    row bitwise against its plain version on the world's first outer
    step; each path's launches go to ``by_path``."""
    import shutil
    import numpy as np
    from icebergs_tpu_torch import dynamics as dyn
    from icebergs_tpu_torch import mts as mts_mod
    from icebergs_tpu_torch.ops import dem_substeps as k4
    from icebergs_tpu_torch.ops import spread as sp

    def count(label, launches):
        for k, n_ in launches.items():
            if n_:
                by_path.setdefault(k, {})[label] = n_

    t0 = time.perf_counter()
    # 14c: card against CPU
    r = phase_cross(ibp, torch, device, HEX_KW)
    require(r["overflow"] == 0, f"14c hexagons: overflow {r['overflow']}")
    print(f"[14c cross-check hex fast lane] {json.dumps(r)}")
    cfg = dem_config(ibp, fused_fallback_cap=16384, **HEX_DEM_KW)
    grid, frc, st, deltas, n = dem_world(
        ibp, torch, cfg, DEM_CROSS_UNITS, NX_DEM_CROSS, device,
        gaps=(2.5e3, 3.5e3), cols=10, jitter=3.0, vel_spread=0.05, seed=1,
        hexagonal=True)
    r = cross_yardstick(ibp, torch, "14c hex dem", st, multi_run(
        ibp, grid, frc, lambda g: dem_multi(ibp, g, cfg, 1, deltas)),
        clamps=True)
    print(f"[14c cross-check hex dem] {json.dumps(dict(elements=n, **r))}")
    del grid, frc, st
    d = WORK / "14c_kid"
    try:
        n = kid_rafts(ibp, torch, d)
        with WatchedSteps(torch) as w:
            r = driver_yardstick(ibp, torch, "14c mts_kid driver", d, True,
                                 max_grazed=KID_MAX_GRAZED, capacity=32)
        require(r["alive"] == n, f"14c mts_kid: {r['alive']} of {n} alive")
        r.update(host_syncs_in_steps=w.syncs, steps=w.calls)
        print(f"[14c mts_kid driver] {json.dumps(r)}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"[14c] {time.perf_counter() - t0:.1f} s")

    # 14a: the hexagonal fast lane on the headline world
    world = headline_world(ibp, torch, N_HEAD, NX_HEAD, device)
    hcfg = world[0].replace(**HEX_KW)
    require(not hasattr(ibp.make_multi_step(world[1], hcfg, 1),
                        "step_diags"), "14a: make_multi_step did not route "
            "the hexagonal fast lane to the persistent lane")
    res, launches, _ = phase_path(ibp, torch, device, kernels,
                                  "hex_fast_lane", cfg_kw=HEX_KW,
                                  profile_out=profile_out, world=world,
                                  profile=True)
    count("hex_fast_lane", launches)
    for k in ("permute_cols_u32", "extract_sorted",
              "segment_spread_sums/assoc"):
        require(launches[k] > 0, f"kernel {k} was not launched by the "
                "hex_fast_lane path")
    require(launches["segment_spread_sums"] == 0, "14a: K3 ran under "
            "hexagons")
    require(res["host_syncs_per_step"] == 0,
            f"14a: host syncs in a step: {res['sync_kinds']}")
    s = world[3]
    ms, nk = hex_geometry_profile(torch, sp, s, world[1], hcfg)
    res.update(hex_geometry_device_ms=ms, hex_geometry_kernels=nk)
    print(f"[14a hex fast lane] {json.dumps(res)}")
    del world, s
    torch.cuda.empty_cache()

    # 14b: the hexagonal DEM world through K4's F_HEX form
    t1 = time.perf_counter()
    dcfg = dem_config(ibp, **HEX_DEM_KW)
    dem = dem_world(ibp, torch, dcfg, DEM_UNITS, NX_DEM, device,
                    hexagonal=True)
    grid, frc, st, deltas, n = dem
    nb = (st.bond_idx >= 0).sum(1)
    print(f"[14b hex dem world] {n} elements, capacity {st.capacity}, "
          f"deltas {deltas}, bonds a slot max {int(nb.max())}, elements "
          f"with 6 bonds {int((nb == 6).sum())}, built in "
          f"{time.perf_counter() - t1:.1f} s")
    require(int(nb.max()) == 6, "14b: no element bonds six neighbours")
    # K4's input on the world's first outer step, caught at its call
    caught = []
    orig = mts_mod.part3_substeps_vmem

    def catch(s4, *a, **kw):
        caught.append((s4, a, kw))
        return orig(s4, *a, **kw)
    mts_mod.part3_substeps_vmem = catch
    try:
        first = dem_multi(ibp, grid, dcfg, 1, deltas)(st, frc)[0]
        # the walk's final clamp at full width: the same outer step from
        # every velocity one ulp faster, on the card
        up = torch.nextafter(st.uvel, torch.full_like(st.uvel, float("inf")))
        nudged = dem_multi(ibp, grid, dcfg, 1, deltas)(
            st.replace(uvel=up, uvel_old=up), frc)[0]
    finally:
        mts_mod.part3_substeps_vmem = orig
    require(len(caught) == 2, f"14b: K4 called {len(caught)} times in two "
            "outer steps")
    s4 = caught[0][0]
    del caught, up
    g, c = ibp.to_numpy(first), ibp.to_numpy(nudged)
    at = np.float32([dyn.POSN_EPS, 1. - dyn.POSN_EPS])
    clamps = dict(
        at_the_clamp=int((g["alive"] & (np.isin(g["xi"], at)
                                        | np.isin(g["yj"], at))).sum()),
        clamped_at_an_edge_vs_one_ulp=int(edge_clamps(g, c).sum()))
    del first, nudged, g, c
    # phase 3's input too (each element moved by up to 8 m): fracture
    sm = k4_state(torch, st, device)
    _, nbm, _, _, msm = k4_run(torch, k4, sm, dcfg, deltas)
    gm = k4_run(torch, k4, sm, dcfg, deltas, "generic")[4]
    del sm
    kres["dem_substeps/hex"] = k4_row(
        torch, k4, s4, dcfg, deltas, "dem_hex",
        "the first outer step's input, ",
        f"on phase 3's input moved by up to 8 m {msm:.3f} ms (generic "
        f"{gm:.3f}), nbroken={int(nbm)}, bitwise")
    del s4
    r = kres["dem_substeps/hex"]
    print(f"[14 kernel] dem_substeps/hex: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}), max_abs_err {r['err']} ({r['note']})")
    res, launches = phase_dem_slice(
        ibp, torch, device, kernels, (
            "permute_cols_u32", "extract_sorted", "segment_spread_sums/assoc",
            "dem_substeps"), dcfg, dem, profile_out, label="14b hex dem",
        profile=True)
    count("hex_dem", launches)
    require(launches["segment_spread_sums"] == 0, "14b: K3 ran under "
            "hexagons")
    ms, nk = hex_geometry_profile(torch, sp, st, grid, dcfg)
    res.update(hex_geometry_device_ms=ms, hex_geometry_kernels=nk,
               bonds=int(nb.sum()), **clamps)
    print(f"[14b hex dem] {json.dumps(res)}")
    del dem, grid, frc, st
    torch.cuda.empty_cache()
    print(f"[14 phase] {time.perf_counter() - t0:.1f} s")


# phase 15: ROADMAP item 13 slices 1-3, the tiled coupling step and run,
# every tile in one process on device 0.  15a the headline world (1M bergs
# on 512 x 512 cells of 2 km, halo 4) through the tiled per-step fused3
# step on 4 tiles of 128 columns; 15b the same on a 2 x 2 layout of
# 256 x 256 tiles; each against the untiled per-step fused3 path (phase 7)
# on the same state: the merged owned state's berg_chksum equal, every
# exchange counter 0, no host sync in a step.  15c make_sharded_run on 4
# tiles of phase 10a's world against the untiled IcebergsModel.run: after
# one window the owned bergs by id bitwise, the budgets within 1e-6.  15d
# tests/test_parallel*.py's small worlds (4 tiles, 2 x 2) card against CPU
TILE_CAP = 1 << 19
# the exchange buffers' first width: a 128-column tile's edge strip holds
# ~4 columns x 512 x 3.8 bergs, ~7.8k a direction; it doubles on overflow
TILE_WIDTH = 16384
TILED_BUDGET_RTOL = 1e-6
TILED_STEP_KERNELS = K1_ROWS + ("permute_cols_u32", "extract_sorted",
                                "segment_spread_sums")
# 15d: test_parallel.py's colliding world (32 x 8 cells of 5 km, halo 2,
# pairs straddling the 4-tile edges and a 4-berg cluster) and
# test_parallel_2d.py's (16 x 16 cells of 4 km, 2 x 2)
SMALL_CFG = dict(grid_is_latlon=False, Lx=-1.0, use_f_plane=True,
                 lat_ref=30.0, dt=60.0, Runge_not_Verlet=False, halo=2,
                 interactive_icebergs_on=True)
SMALL_STEP = dict(neighbor_mode="fused3", fused_window=512,
                  fused_fallback_strip_width=140)


def tiled_world(ibp, torch, cfg, layout, nx, ny, dxy, device):
    from icebergs_tpu_torch.parallel import domain as dd
    ring = dd.Ring(layout)
    make = (dd.make_sharded_world_2d if len(layout) == 2
            else dd.make_sharded_world)
    return make(cfg, ring, nx=nx, ny=ny, lon0=0., lat0=0., dlon=dxy,
                dlat=dxy, device=device)


def tiled_shard(world, frc, st, cap):
    from icebergs_tpu_torch.parallel import domain as dd
    if isinstance(world, dd.ShardedWorld2D):
        return (dd.shard_forcing_2d(world, frc),
                dd.shard_state_2d(world, st, cap))
    return dd.shard_forcing(world, frc), dd.shard_state(world, st, cap)


# steps of the profiled windows of phase 15 (the profiler's own cost
# grows with the ~17k kernels a tiled step launches)
TILED_PROFILE_STEPS = 2


def tiled_window(torch, step, tiles, frcs, n=None):
    """``n`` (INNER) tiled steps: the tiles, the largest exchange counter
    and the largest contact overflow of any tile (device tensors)."""
    ex, co = [], []
    for _ in range(n or INNER):
        tiles, _, _, ov = step(tiles, frcs)
        ex.append(ov.max())
        co += [d.contact_overflow for d in step.diags]
    return tiles, torch.stack(ex).max(), torch.stack(co).max()


def host_syncs(torch, fn):
    """The host syncs torch's sync debug mode reports in one fn()."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return len(rec), sorted({f"{pathlib.Path(r.filename).name}:{r.lineno}"
                             for r in rec})


def phase_tiled_step(ibp, torch, device, kernels, label, layout, head, ref,
                     profile_out=None):
    """15a / 15b: the headline world ``head`` through the tiled per-step
    fused3 step on ``layout``: a warm-up that doubles the exchange width
    or grows the fallback cap until nothing overflows, 3 timed windows of
    INNER steps from the halo-filled tiles with every kernel's launches
    counted over the first, one step under sync debug, a profiled window;
    the merged owned state's berg_chksum against ``ref`` (the untiled
    per-step path's on the same state).  Returns ``(result, launches)``."""
    from icebergs_tpu_torch.diag import berg_chksum
    from icebergs_tpu_torch.parallel import domain as dd

    t0 = time.perf_counter()
    cfg, grid, frc, st = head
    cfg = cfg.replace(fused_fallback_cap=ref["fallback_cap"])
    world = tiled_world(ibp, torch, cfg, layout, NX_HEAD, NX_HEAD, DXY,
                        device)
    frcs, tiles0 = tiled_shard(world, frc, st, TILE_CAP)
    t_shard = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    width = TILE_WIDTH
    for _ in range(4):
        filled, ov0 = dd.make_halo_fill(world, width)(tiles0)
        step = dd.make_sharded_step(world, exchange_width=width,
                                    neighbor_mode="fused3")
        _, ex, co = tiled_window(torch, step, filled, frcs)
        ex, co = max(int(ex), int(ov0.max())), int(co)
        if not ex and not co:
            break
        if ex:
            width *= 2
            print(f"{label}: exchange overflow {ex}; width {width}")
        if co:
            cap = min(4 * world.cfg.fused_fallback_cap, TILE_CAP)
            print(f"{label}: fallback cap overran ({co}); growing to {cap}")
            world = dataclasses.replace(
                world, cfg=world.cfg.replace(fused_fallback_cap=cap))
    require(not ex and not co, f"{label}: exchange overflow {ex}, contact "
            f"overflow {co}")
    for fn in kernels.values():
        fn.launches = 0
    times = []
    for w in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, ex, co = tiled_window(torch, step, filled, frcs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3 / INNER)
        if w == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
        require(int(ex) == 0 and int(co) == 0,
                f"{label} window {w}: overflow {int(ex)} / {int(co)}")
    nsync, kinds = host_syncs(torch, lambda: step(s, frcs))
    require(nsync == 0, f"{label}: host syncs in a step: {kinds}")
    merged = dd.concat_tiles(s)
    require(all_finite(torch, merged), f"{label}: non-finite state")
    chk, n_alive = berg_chksum(merged)
    busy, nk = profile_window(
        torch, lambda: tiled_window(torch, step, filled, frcs,
                                    TILED_PROFILE_STEPS), profile_out, label)
    res = dict(layout=list(layout), tiles=len(s), tile_capacity=TILE_CAP,
               exchange_width=width, fallback_cap=world.cfg.fused_fallback_cap,
               ms_per_step=statistics.median(times), windows_ms=times,
               device_kernel_ms_per_step=busy / TILED_PROFILE_STEPS,
               kernels_per_step=nk / TILED_PROFILE_STEPS,
               berg_chksum=int(chk), alive=int(n_alive), untiled=ref,
               host_syncs_per_step=nsync, exchange_overflow=0,
               contact_overflow=0, shard_s=t_shard,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               phase_s=time.perf_counter() - t0, launches=launches)
    require(int(chk) == ref["berg_chksum"] and int(n_alive) == ref["alive"],
            f"{label}: berg_chksum {int(chk)} (#{int(n_alive)}) != the "
            f"untiled per-step path's {ref['berg_chksum']} "
            f"(#{ref['alive']})")
    for k in TILED_STEP_KERNELS:
        require(launches[k] > 0, f"kernel {k} was not launched by the "
                f"{label} path")
    return res, launches


def untiled_perstep(ibp, torch, device, head, profile_out=None,
                    phase7=None):
    """The untiled per-step fused3 path (phase 7's) on ``head``: its
    berg_chksum (15a's and 15b's reference), wall ms a step and fallback
    cap from ``phase7``'s result, or from a window of its own grown
    until nothing overflows; and its device ms and kernels a step from a
    profiled window of TILED_PROFILE_STEPS."""
    from icebergs_tpu_torch.diag import berg_chksum
    cfg, grid, frc, st = head
    if phase7 is not None:
        cfg = cfg.replace(fused_fallback_cap=phase7["fallback_cap"])
        short = ibp.make_multi_step(grid, cfg, TILED_PROFILE_STEPS,
                                    persistent=False, neighbor_mode="fused3")
        busy, nk = profile_window(torch, lambda: short(st, frc), profile_out,
                                  "untiled_perstep_fused3")
        return dict(berg_chksum=phase7["berg_chksum"],
                    alive=phase7["alive"], ms_per_step=phase7["ms_per_step"],
                    device_kernel_ms_per_step=busy / TILED_PROFILE_STEPS,
                    kernels_per_step=nk / TILED_PROFILE_STEPS,
                    fallback_cap=cfg.fused_fallback_cap, from_phase7=True)
    for _ in range(4):
        multi = ibp.make_multi_step(grid, cfg, INNER, with_stats=True,
                                    persistent=False, neighbor_mode="fused3")
        s, ov, _, _ = multi(st, frc)
        if int(ov) == 0:
            break
        cfg = cfg.replace(fused_fallback_cap=min(
            4 * cfg.fused_fallback_cap, st.capacity))
    require(int(ov) == 0, f"untiled per-step: contact overflow {int(ov)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = multi(st, frc)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / INNER
    short = ibp.make_multi_step(grid, cfg, TILED_PROFILE_STEPS,
                                persistent=False, neighbor_mode="fused3")
    busy, nk = profile_window(torch, lambda: short(st, frc), profile_out,
                              "untiled_perstep_fused3")
    chk, n_alive = berg_chksum(s)
    return dict(berg_chksum=int(chk), alive=int(n_alive), ms_per_step=ms,
                device_kernel_ms_per_step=busy / TILED_PROFILE_STEPS,
                kernels_per_step=nk / TILED_PROFILE_STEPS,
                fallback_cap=cfg.fused_fallback_cap)


def owned_by_id(ibp, st, fields):
    """The owned bergs' ``fields`` in (id_cnt, id_ij) order, numpy; ties
    broken by the fields' bits (phase 10a's world numbers its bergs 0 to
    n - 1, so a footloose child, its parent's id_cnt + 100000, can share
    an id with another berg)."""
    import numpy as np
    d = {f: getattr(st, f).cpu().numpy()
         for f in ("alive", "halo_berg", "id_cnt", "id_ij") + fields}
    own = d["alive"] & (d["halo_berg"] < 0.5)
    keys = [d[f][own].view(np.int32) for f in reversed(fields)]
    order = np.lexsort(keys + [d["id_ij"][own], d["id_cnt"][own]])
    return {f: v[own][order] for f, v in d.items()}


TILED_RUN_FIELDS = ("lon", "lat", "uvel", "vvel", "mass")


def phase_tiled_run(ibp, torch, device, kernels, profile_out=None):
    """15c: make_sharded_run on 4 tiles of phase 10a's world (buckets
    primed, calving into the coast ring, footloose) after a halo fill,
    against one window of the untiled IcebergsModel.run from the same
    state; each grown until nothing overflows.  Returns ``(result,
    launches of the tiled window)``."""
    import numpy as np
    from icebergs_tpu_torch.diag import berg_chksum
    from icebergs_tpu_torch.parallel import domain as dd

    t_start = time.perf_counter()
    cfg, grid, frc, st, calving, stored = coupled_world(
        ibp, torch, N_HEAD, NX_HEAD, COUPLED_CAP, device)
    for _ in range(4):
        model = ibp.IcebergsModel(grid, cfg, device=device)
        s = coupled_state(model, st, stored)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INNER):
            s, o = model.run(s, frc, calving)
            outs.append(o)
        torch.cuda.synchronize()
        ms1 = (time.perf_counter() - t0) * 1e3 / INNER
        co = max(int(o.contact_overflow) for o in outs)
        so = max(int(o.spawn_overflow) + int(o.fl_spawn_overflow)
                 for o in outs)
        require(so == 0, f"15c untiled: spawn overflow {so}")
        if not co:
            break
        cfg = cfg.replace(fused_fallback_cap=min(
            4 * cfg.fused_fallback_cap, st.capacity))
    require(co == 0, f"15c untiled: contact overflow {co}")
    ref = owned_by_id(ibp, s.bergs, TILED_RUN_FIELDS)
    ref_chk = int(berg_chksum(s.bergs)[0])
    b1 = outs[-1].budgets
    del s, outs, model

    world = tiled_world(ibp, torch, cfg, (4,), NX_HEAD, NX_HEAD, DXY, device)
    frcs, tiles = tiled_shard(world, frc, st, TILE_CAP)
    calvs = dd.shard_calving_field(world, calving)
    hflxs = dd.shard_calving_field(world, torch.zeros_like(calving))
    storeds = dd.shard_calving_field(world, stored)
    width = TILE_WIDTH

    def window(run, ms0, n=None):
        ms, outs, ex = ms0, [], []
        for _ in range(n or INNER):
            ms, o, _, ov = run(ms, frcs, calvs, hflxs)
            outs.append(o)
            ex.append(ov.max())
        return ms, outs, int(torch.stack(ex).max())

    for _ in range(4):
        filled, ov0 = dd.make_halo_fill(world, width)(tiles)
        ms0 = [m.replace(calving=m.calving.replace(stored_ice=si))
               for m, si in zip(dd.init_sharded_model_state(world, filled),
                                storeds)]
        run = dd.make_sharded_run(world, neighbor_mode=None,
                                  exchange_width=width)
        ms, outs, ex = window(run, ms0)
        ex = max(ex, int(ov0.max()))
        co = max(int(o.contact_overflow) for o in outs)
        if not ex and not co:
            break
        if ex:
            width *= 2
            print(f"15c: exchange overflow {ex}; width {width}")
        if co:
            cap = min(4 * world.cfg.fused_fallback_cap, TILE_CAP)
            print(f"15c: fallback cap overran ({co}); growing to {cap}")
            world = dataclasses.replace(
                world, cfg=world.cfg.replace(fused_fallback_cap=cap))
    require(not ex and not co, f"15c: exchange overflow {ex}, contact "
            f"overflow {co}")
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms, outs, ex = window(run, ms0)
    torch.cuda.synchronize()
    ms_tiled = (time.perf_counter() - t0) * 1e3 / INNER
    launches = {k: fn.launches for k, fn in kernels.items()}
    so = max(int(o.spawn_overflow) + int(o.fl_spawn_overflow) for o in outs)
    spawns = {f: sum(int(getattr(o, f)) for o in outs)
              for f in ("nbergs_calved", "nbergs_calved_fl")}
    require(ex == 0 and so == 0, f"15c: exchange overflow {ex}, spawn "
            f"overflow {so}")
    require(spawns["nbergs_calved"] > 0 and spawns["nbergs_calved_fl"] > 0,
            f"15c: no bucket or no footloose spawn {spawns}")
    nsync, kinds = host_syncs(torch, lambda: run(ms, frcs, calvs, hflxs))
    require(nsync == 0, f"15c: host syncs in a run: {kinds}")
    got = owned_by_id(ibp, dd.concat_tiles([m.bergs for m in ms]),
                      TILED_RUN_FIELDS)
    require(got["lon"].shape == ref["lon"].shape,
            f"15c: {got['lon'].shape[0]} owned bergs, untiled "
            f"{ref['lon'].shape[0]}")
    for f in ("id_cnt", "id_ij") + TILED_RUN_FIELDS:
        diff = np.nonzero(got[f].view(np.int32) != ref[f].view(np.int32))[0]
        require(not len(diff), f"15c: {f} differs from the untiled run on "
                f"{len(diff)} bergs, ids {ref['id_cnt'][diff[:5]].tolist()}")
    bud = {}
    for f in ("mass", "mass_of_bits", "heat", "stored_ice", "stored_heat"):
        a, b = float(getattr(outs[-1].budgets, f)), float(getattr(b1, f))
        bud[f] = abs(a - b) / max(abs(b), 1e-30)
        require(bud[f] <= TILED_BUDGET_RTOL, f"15c: budget {f} {a} vs the "
                f"untiled {b}")
    chk = int(berg_chksum(dd.concat_tiles([m.bergs for m in ms]))[0])
    busy, nk = profile_window(
        torch, lambda: window(run, ms0, TILED_PROFILE_STEPS), profile_out,
        "tiled_coupled_run")
    res = dict(tiles=4, tile_capacity=TILE_CAP, exchange_width=width,
               fallback_cap=world.cfg.fused_fallback_cap,
               ms_per_step=ms_tiled, untiled_ms_per_step=ms1,
               device_kernel_ms_per_step=busy / TILED_PROFILE_STEPS,
               kernels_per_step=nk / TILED_PROFILE_STEPS,
               phase_s=time.perf_counter() - t_start,
               owned=int(got["lon"].shape[0]),
               berg_chksum=chk, untiled_berg_chksum=ref_chk,
               spawns=spawns, budget_rel_err=bud, host_syncs_per_run=nsync,
               launches=launches)
    require(chk == ref_chk, f"15c: berg_chksum {chk} != untiled {ref_chk}")
    return res, launches


def small_tiled_worlds(ibp, torch, device):
    """15d's two worlds on ``device``: ``[(label, tiles, overflows)]``
    after a halo fill and half the steps of tests/test_parallel.py's and
    tests/test_parallel_2d.py's fused3 cases."""
    import numpy as np
    from icebergs_tpu_torch.parallel import domain as dd
    out = []
    for label, layout, nx, ny, dxy, frc_kw, nsteps in (
            ("1d", (4,), 32, 8, 5000., dict(uo=0.4, sst=2.0), 6),
            ("2x2", (2, 2), 16, 16, 4000., dict(uo=0.3, vo=0.2, sst=2.0),
             5)):
        cfg = ibp.IcebergsConfig(**SMALL_CFG)
        if label == "1d":
            lon = [8 * dxy - 10., 8 * dxy + 30., 16 * dxy - 10.,
                   16 * dxy + 30., 24 * dxy - 10., 24 * dxy + 30., 5 * dxy,
                   5 * dxy + 35., 5 * dxy + 17., 5 * dxy + 17.]
            lat = [4 * dxy] * 2 + [4 * dxy + 120.] * 2 + [4 * dxy + 240.] \
                * 2 + [3 * dxy, 3 * dxy, 3 * dxy + 30., 3 * dxy - 30.]
        else:
            lon = [8 * dxy - 10., 8 * dxy + 30., 3 * dxy, 3 * dxy, 5 * dxy,
                   5 * dxy + 35., 5 * dxy + 17.]
            lat = [4 * dxy, 4 * dxy, 8 * dxy - 10., 8 * dxy + 30., 3 * dxy,
                   3 * dxy, 3 * dxy + 30.]
        grid = ibp.make_uniform_grid(nx, ny, 0., 0., dxy, dxy,
                                     grid_is_latlon=False, device=device)
        frc = ibp.uniform_forcing(nx, ny, device=device, **frc_kw)
        st = ibp.create_bergs(64, lon=np.array(lon), lat=np.array(lat),
                              mass=1e8, thickness=20., width=50., length=60.,
                              mass_scaling=1.0, device=device)
        i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
        st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
        world = tiled_world(ibp, torch, cfg, layout, nx, ny, dxy, device)
        frcs, tiles = tiled_shard(world, frc, st, 32)
        tiles, ov = dd.make_halo_fill(world)(tiles)
        ovs = [ov]
        step = dd.make_sharded_step(world, **SMALL_STEP)
        for _ in range(nsteps):
            tiles, _, _, ov = step(tiles, frcs)
            ovs.append(ov)
        out.append((label, tiles, torch.stack(ovs)))
    return out


def phase_tiled_cross(ibp, torch, device):
    """15d: the small tiled worlds on the card against a CPU copy: the
    integers (alive, halo_berg, cells, ids, bonds) and every exchange
    counter exact, floats within the cross-check tolerance."""
    import numpy as np
    res = {}
    for (label, g, govs), (_, c, covs) in zip(
            small_tiled_worlds(ibp, torch, device),
            small_tiled_worlds(ibp, torch, torch.device("cpu"))):
        require(torch.equal(govs.cpu(), covs) and not covs.any(),
                f"15d {label}: exchange counters differ or overflow")
        worst = 0.
        for gt, ct in zip(g, c):
            gd, cd = ibp.to_numpy(gt), ibp.to_numpy(ct)
            alive = cd["alive"]
            for f, cv in cd.items():
                gv = gd[f]
                if f == "halo_berg" or cv.dtype.kind != "f":
                    require(np.array_equal(gv, cv), f"15d {label}: {f} "
                            "differs between the card and the CPU")
                    continue
                a, b = gv[alive].astype(np.float64), cv[alive]
                if not b.size:
                    continue
                scale = max(np.abs(b).max(), 1e-30)
                require(np.all(np.abs(a - b) <= CROSS_RTOL * np.abs(b)
                               + CROSS_ATOL_SCALE * scale),
                        f"15d {label}: {f} beyond tolerance")
                worst = max(worst, float(np.abs(a - b).max() / scale))
        res[label] = dict(tiles=len(g), alive=int(sum(int(t.alive.sum())
                                                      for t in c)),
                          worst_scaled_err=worst)
    return res


def phase15(ibp, torch, device, kernels, by_path, perstep=None,
            profile_out=None):
    """Phase 15, ROADMAP item 13 slices 1-3: 15d card against CPU, 15a
    and 15b the tiled per-step step on the headline world against the
    untiled per-step path (phase 7's result ``perstep``, or its own run
    without it), 15c the tiled run against the untiled run; each path's
    launches go to ``by_path``."""
    t0 = time.perf_counter()
    r = phase_tiled_cross(ibp, torch, device)
    r["phase_s"] = time.perf_counter() - t0
    print(f"[15d cross-check tiled] {json.dumps(r)}")
    t1 = time.perf_counter()
    head = headline_world(ibp, torch, N_HEAD, NX_HEAD, device)
    ref = untiled_perstep(ibp, torch, device, head, profile_out, perstep)
    ref["phase_s"] = time.perf_counter() - t1
    for tag, label, layout in (("15a", "tiled_perstep_fused3", (4,)),
                               ("15b", "tiled_2d_perstep_fused3", (2, 2))):
        res, launches = phase_tiled_step(ibp, torch, device, kernels, label,
                                         layout, head, ref, profile_out)
        for k, n in launches.items():
            if n:
                by_path.setdefault(k, {})[label] = n
        print(f"[{tag} {label}] {json.dumps(res)}")
        torch.cuda.empty_cache()
    del head
    torch.cuda.empty_cache()
    res, launches = phase_tiled_run(ibp, torch, device, kernels, profile_out)
    for k, n in launches.items():
        if n:
            by_path.setdefault(k, {})["tiled_coupled_run"] = n
    for k in ("permute_cols_u32", "extract_sorted", "segment_spread_sums"):
        require(launches[k] > 0, f"kernel {k} was not launched by the tiled "
                "run")
    print(f"[15c tiled_coupled_run] {json.dumps(res)}")
    torch.cuda.empty_cache()
    print(f"[15 phase] {time.perf_counter() - t0:.1f} s")



# phase 16: ROADMAP item 13's last slices, all tiles in one process on the
# card.  16a phase 6's DEM world (999,944 bonded elements, 2,066
# conglomerates on 512 x 512 cells of 7 km) in 4 tiles of 128 columns
# through the tiled MTS step (the scan, the ring ghost refresh of 2 hops,
# Part 1 through K2 grouped, thermodynamics and spreading) for
# TILED_DEM_STEPS outer steps against the untiled scan (phase 11a's path)
# from the same state; then the tiled restart (io_layout 1 and 2) read
# back into one state, and the tiled trajectory against the untiled one.
# 16b the headline world with its north edge a tripolar fold and a band of
# bergs heading for it, the tiled per-step fused3 step on 2 x 2 and 4 x 2
# tiles.  16c the small worlds of tests/test_parallel_bonds.py and
# tests/test_parallel_fold.py card against CPU
TILED_DEM_STEPS = 2
# the widths' first values for 16a's tiles (~250k owned elements, ~45k
# conglomerate replicas, ~640 conglomerates on an extended tile of 132
# columns); each doubles on overflow
TILED_DEM_WIDTHS = dict(exchange_width=1 << 16, ghost_width=1 << 19,
                        ghost_slots=1 << 16, conglom_id_cap=1024)
# the tiles' Part-1 fallback: the replicas far from a tile clamp into its
# outermost halo column, ~30-60 to a cell, whose blocks K2 cannot window
# and whose fallback strips outgrow the default 64 candidates (~30,000
# rows a tile truncated at 64, whatever the cap); the cap grows when the
# rows outnumber it, else the strip width
TILED_DEM_FALLBACK_CAP = 1 << 17
TILED_DEM_STRIP = 256
TILED_DEM_KERNELS = ("permute_cols_u32", "extract_sorted",
                     "segment_spread_sums")
FOLD_STEPS = 8
# bergs moved within 2 km of the fold (the top row of cells: ~3.9 more to
# a cell, about the world's density; at 20,000, ~39 a cell, the fused3
# fallback overflows at any cap)
FOLD_BAND = 2000
FOLD_LAYOUTS = ((2, 2), (4, 2))
SMALL_MTS_KW = dict(pair_cap=512, contact_cap=256, ghost_width=16,
                    ghost_slots=16)
# 16c floats, card against CPU: the bonded and fold worlds within phase
# 4's tolerance; the MTS chain's 12 stiff substeps an outer step amplify an
# ulp (phase 4b), so its floats are held to 1e-3 of scale
SMALL_MTS_ATOL_SCALE = 1e-3


def _tiles_global(dd, world, tiles):
    """The merged tiles with their cells in the global frame and each
    bond's partner id stamped on its tile."""
    from icebergs_tpu_torch.ops.forces import stamp_bond_ids
    return dd.concat_tiles([stamp_bond_ids(t).replace(ine=t.ine + g.i_off,
                                                      jne=t.jne + g.j_off)
                            for t, g in zip(tiles, world.grids)])


def _by_id(ibp, st, stamp=False):
    """Every field of the owned live elements in (id_cnt, id_ij) order
    (numpy) but the partner slots, whose partners' ids are stamped
    (``stamp``: here, on an untiled state)."""
    import numpy as np
    from icebergs_tpu_torch.ops.forces import stamp_bond_ids
    d = ibp.to_numpy(stamp_bond_ids(st) if stamp else st)
    own = d["alive"] & (d["halo_berg"] < 0.5)
    order = np.lexsort((d["id_ij"][own], d["id_cnt"][own]))
    return {k: v[own][order] for k, v in d.items()
            if isinstance(v, np.ndarray) and k != "bond_idx"}


def _differ(a, b, fields=None):
    """The fields of two ``_by_id`` dicts that differ in any bit, with
    their largest difference against the field's scale."""
    import numpy as np
    out = {}
    for f in fields or b:
        x, y = a[f], b[f]
        if x.shape != y.shape:
            out[f] = "shape"
            continue
        if x.dtype.kind == "f":
            if not np.array_equal(x.view(np.int32), y.view(np.int32)):
                scale = max(float(np.abs(y).max()), 1e-30)
                out[f] = float(np.abs(x.astype(np.float64) - y).max()
                               / scale)
        elif not np.array_equal(x, y):
            out[f] = "int"
    return out


def _mts_overflow(ov):
    """16a's counters (tiles, passes, 2) by what they size: the exchange
    passes, then the replication's (ov1, ov2), its id list's (ov_ids, 0),
    the ghost ship and slots (ov_ship, ov_rep) and the replicas found
    nowhere (not found, 0)."""
    m = ov.amax(dim=0).cpu()
    return dict(exchange=int(m[:-3, 0].max()), slots=int(m[:-2, 1].max()),
                ids=int(m[-3, 0]), ship=int(m[-2, 0]), rep=int(m[-2, 1]),
                not_found=int(m[-1, 0]))


def phase_tiled_dem(ibp, torch, device, kernels, dcfg, profile_out=None):
    """16a.  Returns ``(result, launches of the tiled window)``."""
    import shutil
    import tempfile
    import numpy as np
    from icebergs_tpu_torch.io import restart as rio
    from icebergs_tpu_torch.io import trajectory as tio
    from icebergs_tpu_torch.parallel import domain as dd

    t_start = time.perf_counter()
    clock = {}

    def lap(name):
        torch.cuda.synchronize()
        clock[name] = time.perf_counter() - t_start - sum(clock.values())
    grid, frc, st, _, n = dem_world(ibp, torch, dcfg, DEM_UNITS, NX_DEM,
                                    device)
    lap("world")
    tcfg = dcfg.replace(save_short_traj=True)      # the trajectory's schema
    cfg = dcfg

    def untiled(step, nsteps, record=None):
        s, diags = st, []
        for k in range(nsteps):
            s, d = step(s, frc)
            diags.append(d)
            if record is not None:
                record = tio.record_posn(record, s, tcfg, day=k + 1., year=0)
        return s, diags, record

    for _ in range(4):
        step1 = ibp.make_step(grid, cfg, mts_substep_kernel="scan")
        ubuf = tio.init_traj_buffer(st.capacity, TILED_DEM_STEPS, tcfg,
                                    device=device)
        s1, d1, ubuf = untiled(step1, TILED_DEM_STEPS, ubuf)
        p1 = max(int(d.p1_overflow) for d in d1)
        if not p1:
            break
        cfg = cfg.replace(fused_fallback_cap=min(4 * cfg.fused_fallback_cap,
                                                 st.capacity))
        print(f"16a untiled: Part-1 fallback cap overran ({p1}); growing "
              f"to {cfg.fused_fallback_cap}")
    require(p1 == 0, f"16a untiled: p1_overflow {p1}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    untiled(step1, TILED_DEM_STEPS)
    torch.cuda.synchronize()
    un_s = (time.perf_counter() - t0) / TILED_DEM_STEPS
    un_busy, un_nk = profile_window(torch, lambda: step1(st, frc),
                                    profile_out, "untiled_mts_scan", True)
    ref = _by_id(ibp, s1, stamp=True)
    ref_iters = [d.conv_iters for d in d1]
    del s1
    lap("untiled")

    world = dd.make_sharded_world(
        cfg.replace(fused_fallback_cap=max(cfg.fused_fallback_cap,
                                           TILED_DEM_FALLBACK_CAP)),
        dd.Ring((4,)), nx=NX_DEM, ny=NX_DEM, lon0=0., lat0=0., dlon=DXY_DEM,
        dlat=DXY_DEM, device=device)
    frcs = dd.shard_forcing(world, frc)
    tiles0 = dd.shard_state(world, st, TILE_CAP)
    lap("shard")
    widths = dict(TILED_DEM_WIDTHS)

    def tiled(step, record=None):
        ts, ovs, diags = tiles0, [], []
        for k in range(TILED_DEM_STEPS):
            ts, nb, _, ov = step(ts, frcs)
            ovs.append(ov)
            diags.append(step.diags)
            if record is not None:
                record[:] = tio.record_posn_tiled(record, ts, tcfg,
                                                  day=k + 1., year=0)
        return ts, nb, torch.stack(ovs).amax(dim=0), diags

    strip = TILED_DEM_STRIP
    for _ in range(5):
        step = dd.make_sharded_mts_step(
            world, ghost_sync="ring", ghost_hops=2, mts_neighbor_mode=None,
            with_thermo=True, with_spread=True,
            fused_fallback_strip_width=strip, **widths)
        bufs = tio.init_traj_buffer_tiled(world.ring, TILE_CAP,
                                          TILED_DEM_STEPS, tcfg,
                                          device=device)
        ts, nb, ov, diags = tiled(step, bufs)
        o = _mts_overflow(ov)
        p1 = max(int(d.p1_overflow) for ds in diags for d in ds)
        fb = max(int(d.p1_fallback) for ds in diags for d in ds)
        grow = [k for k, key in (("exchange_width", "exchange"),
                                 ("ghost_width", "ship"),
                                 ("ghost_slots", "rep"),
                                 ("conglom_id_cap", "ids")) if o[key]]
        if not grow and not p1:
            break
        for k in grow:
            widths[k] *= 2
        if p1 and fb > world.cfg.fused_fallback_cap:
            world = dataclasses.replace(world, cfg=world.cfg.replace(
                fused_fallback_cap=min(4 * world.cfg.fused_fallback_cap,
                                       TILE_CAP)))
        elif p1:
            strip *= 4
        print(f"16a: overflow {o}, p1 {p1} ({fb} fallback rows); widths "
              f"{widths}, tile fallback cap {world.cfg.fused_fallback_cap}, "
              f"strip {strip}")
        require(not o["slots"] and not o["not_found"],
                f"16a: tile slots or the ring's hops overran: {o}")
    require(not grow and not p1 and not any(o.values()),
            f"16a: overflow {o}, p1 {p1}")
    got = _by_id(ibp, _tiles_global(dd, world, ts))
    iters = [ds[0].conv_iters for ds in diags]
    require(all(d.conv_iters == it for ds, it in zip(diags, iters)
                for d in ds), "16a: tiles ran different iteration counts")
    require(int(nb) == ref["lon"].shape[0] == got["lon"].shape[0],
            f"16a: {int(nb)} owned elements, untiled {ref['lon'].shape[0]}")
    differ = _differ(got, ref)
    ints = {f: v for f, v in differ.items() if not isinstance(v, float)}
    require(not ints, f"16a: integers differ from the untiled scan: {ints}")
    require(not differ, f"16a: floats differ from the untiled scan: "
            f"{differ}")
    require(iters == ref_iters, f"16a: convergence iterations {iters} != "
            f"the untiled {ref_iters}")
    broken = int(((got["bond_broken"] == 1)
                  & ((got["bond_id_cnt"] != 0) | (got["bond_id_ij"] != 0))
                  ).sum())
    lap("tiled_warmup_and_compare")

    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts2, _, _, _ = tiled(step)
    torch.cuda.synchronize()
    tiled_s = (time.perf_counter() - t0) / TILED_DEM_STEPS
    launches = {k: fn.launches for k, fn in kernels.items()}
    for k in TILED_DEM_KERNELS:
        require(launches[k] > 0, f"kernel {k} was not launched by the tiled "
                "MTS step")
    require(not _differ(_by_id(ibp, _tiles_global(dd, world, ts2)), got),
            "16a: a second run differs from the first")
    del ts2
    nsync, kinds = host_syncs(torch, lambda: step(tiles0, frcs))
    require(nsync == step.diags[0].conv_iters,
            f"16a: {nsync} host syncs in an outer step of "
            f"{step.diags[0].conv_iters} iterations: {kinds}")
    ghost_b = step.ghost_bytes / (cfg.n_sub_steps * len(world.ring.tiles))
    lap("tiled_timed_and_syncs")
    busy, nk = profile_window(torch, lambda: step(tiles0, frcs), profile_out,
                              "tiled_dem_mts", True)
    lap("tiled_profile")

    # the tiled restart, read back into one state
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tiled_restart_"))
    try:
        backs = []
        for layout in (1, 2):
            base = str(tmp / f"l{layout}" / "icebergs.res.nc")
            pathlib.Path(base).parent.mkdir()
            paths = rio.write_restart_bergs_tiled(base, ts, cfg,
                                                  io_layout=layout)
            require(len(paths) == 4 // layout, f"16a: {len(paths)} files at "
                    f"io_layout {layout}")
            back = rio.read_restart_bergs_tiled(base, st.capacity, grid, cfg,
                                                device=device)
            backs.append(rio.read_restart_bonds_tiled(base, back, cfg))
        require(not _differ(_by_id(ibp, backs[0], True),
                            _by_id(ibp, backs[1], True)),
                "16a: io_layout 1 and 2 read back differently")
        back = _by_id(ibp, backs[0], True)
        del backs
        fields = [f for _, f, _ in restart_fields(cfg)] + [
            f for _, f in rio.BOND_VARS] + ["bond_id_cnt", "bond_id_ij",
                                            "n_bonds"]
        bad = _differ(back, got, fields)
        require(not bad, f"16a: the tiled restart read back differs: {bad}")
        # the reader labels the conglomerates anew: the same partition
        pairs = np.unique(np.stack([back["conglom_id"], got["conglom_id"]]),
                          axis=1).shape[1]
        require(pairs == np.unique(got["conglom_id"]).size
                == np.unique(back["conglom_id"]).size,
                "16a: the restart's conglomerates differ from the tiles'")
        lap("restart")

        # the trajectory: the union of the tiles' files against the
        # untiled recording of the same states
        total, _ = tio.write_trajectories_tiled(str(tmp / "traj.nc"), bufs,
                                                tcfg)
        n1, _ = tio.write_trajectories(str(tmp / "ref.nc"), ubuf, tcfg)
        require(total == n1 == TILED_DEM_STEPS * n, f"16a: trajectory "
                f"entries {total} tiled, {n1} untiled")
        from scipy.io import netcdf_file

        def rows(paths):
            cols = {}
            for p in paths:
                with netcdf_file(str(p), "r", mmap=False) as f:
                    for k, v in f.variables.items():
                        cols.setdefault(k, []).append(np.asarray(v[:]))
            cols = {k: np.concatenate(v) for k, v in cols.items()}
            o = np.lexsort((cols["day"], cols["id_ij"], cols["id_cnt"]))
            return {k: v[o] for k, v in cols.items()}
        a = rows(sorted(tmp.glob("traj.nc.[0-9]*")))
        b = rows([tmp / "ref.nc"])
        require(set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                         for k in b),
                "16a: the tiled trajectory differs from the untiled one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lap("trajectory")
    res = dict(
        tiles=4, elements=n, owned=int(nb), tile_capacity=TILE_CAP,
        widths=widths, fallback_cap=cfg.fused_fallback_cap,
        tile_fallback_cap=world.cfg.fused_fallback_cap,
        tile_fallback_strip=strip, tile_p1_fallback=fb,
        s_per_outer_step=tiled_s, untiled_s_per_outer_step=un_s,
        device_kernel_ms_per_outer_step=busy, kernels_per_outer_step=nk,
        untiled_device_kernel_ms_per_outer_step=un_busy,
        untiled_kernels_per_outer_step=un_nk,
        ghost_ring_bytes_per_substep_per_tile=ghost_b,
        conv_iters=iters, host_syncs_per_outer_step=nsync,
        broken_owned_bonds=broken, bitwise_to_untiled=True,
        trajectory_entries=total, seconds=clock,
        phase_s=time.perf_counter() - t_start,
        launches=launches)
    return res, launches


def fold_head(ibp, torch, device, seed=7):
    """16b's world: the headline world with FOLD_BAND bergs moved into the
    top row of cells, heading north at 0.5 m/s."""
    import numpy as np
    cfg, grid, frc, st = headline_world(ibp, torch, N_HEAD, NX_HEAD, device)
    rng = np.random.RandomState(seed)
    top = NX_HEAD * DXY
    lat = st.lat.cpu().numpy().copy()
    vvel = st.vvel.cpu().numpy().copy()
    lat[:FOLD_BAND] = top - rng.uniform(50., 1950., FOLD_BAND)
    vvel[:FOLD_BAND] = 0.5
    lat_t = torch.as_tensor(lat, device=device)
    v_t = torch.as_tensor(vvel, device=device)
    st = st.replace(lat=lat_t, lat_old=lat_t, vvel=v_t, vvel_old=v_t)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    return cfg, grid, frc, st.replace(ine=i, jne=j, xi=xi, yj=yj)


def phase_fold(ibp, torch, device, kernels, head):
    """16b: the folded headline world ``head`` on each FOLD_LAYOUTS
    layout.  Returns ``({label: result}, {label: launches})``."""
    from icebergs_tpu_torch.parallel import domain as dd
    cfg0, grid, frc, st = head
    results, launches_by, owned = {}, {}, {}
    for layout in FOLD_LAYOUTS:
        label = f"tiled_fold_{layout[0]}x{layout[1]}"
        t0 = time.perf_counter()
        world = dd.make_sharded_world_2d(
            cfg0, dd.Ring(layout), nx=NX_HEAD, ny=NX_HEAD, lon0=0., lat0=0.,
            dlon=DXY, dlat=DXY, folded_north=True, device=device)
        frcs = dd.shard_forcing_2d(world, frc)
        tiles0 = dd.shard_state_2d(world, st, TILE_CAP)
        width = TILE_WIDTH
        for _ in range(4):
            filled, ov0 = dd.make_halo_fill(world, width)(tiles0)
            step = dd.make_sharded_step(world, exchange_width=width,
                                        neighbor_mode="fused3",
                                        with_thermo=False)
            s, ex, co = tiled_window(torch, step, filled, frcs, FOLD_STEPS)
            ex, co = max(int(ex), int(ov0.max())), int(co)
            if not ex and not co:
                break
            if ex:
                width *= 2
            if co:
                world = dataclasses.replace(world, cfg=world.cfg.replace(
                    fused_fallback_cap=min(4 * world.cfg.fused_fallback_cap,
                                           TILE_CAP)))
            print(f"16b {label}: overflow {ex} / {co}; width {width}, "
                  f"fallback cap {world.cfg.fused_fallback_cap}")
        require(not ex and not co, f"16b {label}: exchange overflow {ex}, "
                f"contact overflow {co}")
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s2, ex2, co2 = tiled_window(torch, step, filled, frcs, FOLD_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / FOLD_STEPS
        launches_by[label] = {k: fn.launches for k, fn in kernels.items()}
        require(int(ex2) == 0 and int(co2) == 0, f"16b {label}: overflow")
        for k in TILED_STEP_KERNELS:
            require(launches_by[label][k] > 0, f"kernel {k} was not launched "
                    f"by the {label} path")
        nsync, kinds = host_syncs(torch, lambda: step(s2, frcs))
        require(nsync == 0, f"16b {label}: host syncs in a step: {kinds}")
        owned[label] = _by_id(ibp, _tiles_global(dd, world, s))
        require(not _differ(_by_id(ibp, _tiles_global(dd, world, s2)),
                            owned[label]),
                f"16b {label}: a second window differs from the first")
        nb = owned[label]["lon"].shape[0]
        crossed = int((owned[label]["rot"] != 0).sum())
        require(nb == int(st.alive.sum()), f"16b {label}: {nb} owned bergs "
                f"of {int(st.alive.sum())}")
        require(crossed > 0, f"16b {label}: no berg crossed the fold")
        busy, nk = profile_window(
            torch, lambda: tiled_window(torch, step, filled, frcs, 1), None,
            label, True)
        results[label] = dict(
            layout=list(layout), exchange_width=width,
            fallback_cap=world.cfg.fused_fallback_cap, ms_per_step=ms,
            device_kernel_ms_per_step=busy, kernels_per_step=nk, owned=nb,
            fold_crossings=crossed, host_syncs_per_step=nsync,
            exchange_overflow=0, contact_overflow=0,
            phase_s=time.perf_counter() - t0)
        del s, s2, filled, tiles0
        torch.cuda.empty_cache()
    a, b = (owned[f"tiled_fold_{x}x{y}"] for x, y in FOLD_LAYOUTS)
    bad = _differ(a, b)
    require(not bad, f"16b: the two layouts differ: {bad}")
    return results, launches_by


def phase_small_bonds(ibp, torch, device):
    """16c: the small bond, MTS-chain and fold worlds on the card against
    the CPU: every integer and counter exact, floats within tolerance."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parallel_worlds as W
    cases = (("edge_1d", W.edge_pair, (2,), 6, dict(with_thermo=False)),
             ("corner_2x2", W.corner_pair, (2, 2), 6,
              dict(with_thermo=False)),
             ("mts_chain_ring", W.mts_chain_world, (2,), 2,
              dict(mts=True, **SMALL_MTS_KW)),
             ("fold_crossing", W.fold_crossing, (2, 2), 8,
              dict(folded=True, cap=32, width=64, with_thermo=False)))
    res = {}
    for label, fn, layout, nsteps, kw in cases:
        out = {}
        for dev in (device, torch.device("cpu")):
            ts, nb, ovs, _ = W.tiled_bond_run(fn, layout, nsteps, device=dev,
                                              **kw)
            out[dev.type] = (ts, int(nb), torch.stack(ovs).cpu())
        (g, gn, gov), (c, cn, cov) = out["cuda"], out["cpu"]
        require(gn == cn and torch.equal(gov, cov) and not cov.any(),
                f"16c {label}: counts or counters differ or overflow")
        atol = SMALL_MTS_ATOL_SCALE if kw.get("mts") else CROSS_ATOL_SCALE
        worst = 0.
        for gt, ct in zip(g, c):
            gd, cd = ibp.to_numpy(gt), ibp.to_numpy(ct)
            alive = cd["alive"]
            for f, cv in cd.items():
                gv = gd[f]
                if f == "halo_berg" or cv.dtype.kind != "f":
                    require(np.array_equal(gv, cv), f"16c {label}: {f} "
                            "differs between the card and the CPU")
                    continue
                x, y = gv[alive].astype(np.float64), cv[alive]
                if not y.size:
                    continue
                scale = max(np.abs(y).max(), 1e-30)
                require(np.all(np.isfinite(x)) and np.all(
                    np.abs(x - y) <= CROSS_RTOL * np.abs(y) + atol * scale),
                    f"16c {label}: {f} beyond tolerance")
                worst = max(worst, float(np.abs(x - y).max() / scale))
        res[label] = dict(tiles=len(g), owned=cn, worst_scaled_err=worst)
    return res


def phase16(ibp, torch, device, kernels, by_path, profile_out=None):
    """Phase 16, ROADMAP item 13's last slices: 16c, 16a and 16b; each
    path's launches go to ``by_path``."""
    t0 = time.perf_counter()
    r = phase_small_bonds(ibp, torch, device)
    r["phase_s"] = time.perf_counter() - t0
    print(f"[16c cross-check tiled bonds mts fold] {json.dumps(r)}")
    res, launches = phase_tiled_dem(ibp, torch, device, kernels,
                                    dem_config(ibp), profile_out)
    for k, n in launches.items():
        if n:
            by_path.setdefault(k, {})["tiled_dem_mts"] = n
    print(f"[16a tiled_dem_mts] {json.dumps(res)}")
    torch.cuda.empty_cache()
    head = fold_head(ibp, torch, device)
    res, launches_by = phase_fold(ibp, torch, device, kernels, head)
    del head
    for label, launches in launches_by.items():
        for k, n in launches.items():
            if n:
                by_path.setdefault(k, {})[label] = n
        print(f"[16b {label}] {json.dumps(res[label])}")
    torch.cuda.empty_cache()
    print(f"[16 phase] {time.perf_counter() - t0:.1f} s")

def kernel_counters():
    """Every kernel wrapper (or second count) by its row's name: the
    ``launches`` each path reads and resets."""
    from icebergs_tpu_torch.ops import (dem_substeps, extract, interp_sorted,
                                       pack, pairs, prepass, segment_spread)
    return {"permute_cols_u32": pack.permute_cols_u32,
            "pack_rows_u32": pack.pack_rows_u32,
            "gather_rows_u32": pack.gather_rows_u32,
            "extract_sorted": extract.extract_sorted,
            "segment_spread_sums": segment_spread.segment_spread_sums,
            "dem_substeps": dem_substeps.part3_substeps_vmem,
            "contact_prepass_sorted": prepass.contact_prepass_sorted,
            "interp_sorted": interp_sorted.interp_sorted,
            "eval_pair_ia_kernel": pairs.eval_pair_ia_kernel,
            "extract_sorted/epilogue": _Counter(extract.extract_sorted,
                                                "epilogue_launches"),
            "segment_spread_sums/assoc": segment_spread.segment_sums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-out", default=None,
                    help="directory for a profiler table and trace")
    ap.add_argument("--tiled", action="store_true",
                    help="run only phases 15 and 16 (the tiled step and run, "
                    "bonds, MTS and the fold across tiles) after the build")
    ap.add_argument("--ab", metavar="ROOT", default=None,
                    help="run only phase 3's K1, K2, K3, K5 and K7 cases "
                    "and phase 12's K2 and K5 lat-lon cases, "
                    "with the package of the checkout at ROOT (a copy of "
                    "another commit inside this one, or this one): the "
                    "parent / change comparison")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = ROOT
    if args.ab is not None:
        root = pathlib.Path(args.ab).resolve()
        if root != ROOT and ROOT not in root.parents:
            ap.error(f"--ab {root} is not inside {ROOT}")
    sys.path.insert(0, str(root))
    import icebergs_tpu_torch as ibp
    from icebergs_tpu_torch import cuda_build
    from icebergs_tpu_torch.ops import (dem_substeps, extract, forces,
                                       interp_sorted, pack, pairs, prepass,
                                       segment_spread)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[1 env] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_build.library()
    log = cuda_build.library_path().with_suffix(".log")
    regs = [ln.strip().replace("ptxas info    : ", "")
            for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln] if log.exists() else []
    print(f"[2 build] {time.perf_counter() - t0:.1f} s "
          f"({cuda_build.library_path().name}); " + " | ".join(regs))

    if args.tiled:
        by_path = {}
        phase15(ibp, torch, device, kernel_counters(), by_path,
                profile_out=args.profile_out)
        phase16(ibp, torch, device, kernel_counters(), by_path,
                args.profile_out)
        print(f"[15-16 launches] {json.dumps(by_path)}")
        print(smi)
        return 0
    ab = args.ab is not None
    kres, k1 = phase_kernels(ibp, torch, device, ab)
    t_dem = time.perf_counter()
    dcfg = dem_config(ibp)
    dem = dem_world(ibp, torch, dcfg, DEM_UNITS, NX_DEM, device)
    print(f"[3 dem world] {dem[4]} elements, capacity {dem[2].capacity}, "
          f"deltas {dem[3]}, built in {time.perf_counter() - t_dem:.1f} s")
    dres, dk1 = phase_kernels_dem(ibp, torch, device, dcfg, dem, ab)
    kres.update(dres)
    if ab:
        del dem
        torch.cuda.empty_cache()
        kres.update(ab_latlon_rows(ibp, torch, device))
    for c in k1 + dk1:
        print(f"[3 k1] {json.dumps(c)}")
    def fmt(x):
        return "-" if x is None else f"{x:.3f} ms"
    for name, r in kres.items():
        print(f"[3 kernel] {name}: kernel {r['ms']:.4f} ms, plain "
              f"{fmt(r['plain_ms'])}, library {fmt(r['library_ms'])}, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max_abs_err "
              f"{r['err']} ({r['note']})")
    if ab:
        print(smi)
        print(json.dumps({"ab": str(root.relative_to(ROOT)) or ".",
                          "k1": k1 + dk1, "ms": {
                              k: r["ms"] for k, r in kres.items()}}))
        return 0

    cres = phase_cross(ibp, torch, device)
    print(f"[4 cross-check] {json.dumps(cres)}")
    dcres = phase_dem_cross(ibp, torch, device)
    print(f"[4b dem cross-check] {json.dumps(dcres)}")
    for name, ckw, mkw in CROSS_PATHS:
        r = phase_cross(ibp, torch, device, ckw, mkw)
        print(f"[4c cross-check {name}] {json.dumps(r)}")
        require(r["overflow"] == 0, f"4c {name}: contact_overflow "
                f"{r['overflow']}")

    kernels = kernel_counters()
    # launches on each main path: every kernel's count is set to 0 just
    # before the path runs and read just after its first timed window;
    # each path must launch the kernels listed for it
    by_path = {}

    def run_path(tag, label, names, **kw):
        res, launches, acc = phase_path(ibp, torch, device, kernels, label,
                                        profile_out=args.profile_out, **kw)
        for k, n in launches.items():
            if n:
                by_path.setdefault(k, {})[label] = n
        print(f"[{tag}] {json.dumps(res)}")
        for k in names:
            require(launches[k] > 0, f"kernel {k} was not launched by the "
                    f"{label} path")
        require(res["host_syncs_per_step"] == 0,
                f"{label}: host syncs in a step: {res['sync_kinds']}")
        return res, acc

    fast, fast_acc = run_path("5 slice", "fast_lane", K1_ROWS + (
        "permute_cols_u32", "extract_sorted", "segment_spread_sums"))
    dres, dlaunches = phase_dem_slice(
        ibp, torch, device, kernels, (
            "permute_cols_u32", "extract_sorted", "segment_spread_sums",
            "dem_substeps"), dcfg, dem, args.profile_out)
    print(f"[6 dem slice] {json.dumps(dres)}")
    dem_s_per_step = dres["s_per_outer_step"]
    for k, n in dlaunches.items():
        if n:
            by_path.setdefault(k, {})["dem"] = n
    perstep = {}
    for mode, names in PERSTEP_PATHS:
        kw = dict(persistent=False, neighbor_mode=mode)
        if mode == "buckets":
            kw.update(max_per_cell=MAX_PER_CELL)
        perstep[mode], _ = run_path(f"7 per-step {mode}", f"perstep_{mode}",
                                    names, multi_kw=kw)
    run_path("8 persistent fused kernel-interp", "persistent_fused_kernel",
             ("contact_prepass_sorted", "interp_sorted", "permute_cols_u32",
              "segment_spread_sums"),
             cfg_kw=dict(interp_mode="kernel"),
             multi_kw=dict(neighbor_mode="fused"))
    # phase 9: ROADMAP item 15's options on the headline world, each also
    # card against CPU on the cross-check world
    for tag, label, ckw, mkw, names in ITEM15_PATHS:
        r = phase_cross(ibp, torch, device, ckw, mkw)
        print(f"[{tag} cross-check] {json.dumps(r)}")
        require(r["overflow"] == 0, f"{tag} cross-check: contact_overflow "
                f"{r['overflow']}")
        res, acc = run_path(f"{tag} {label}", label, names, cfg_kw=ckw,
                            multi_kw=mkw)
        if tag == "9b":
            require(res["berg_chksum"] == fast["berg_chksum"],
                    f"9b: berg_chksum {res['berg_chksum']} != the fast "
                    f"lane's {fast['berg_chksum']}")
            tol = (ITEM15_ACC_RTOL * fast_acc.abs()
                   + ITEM15_ACC_ATOL_SCALE * fast_acc.abs().max())
            dev = (acc - fast_acc).abs()
            require(bool((dev <= tol).all()), "9b: coupler fields beyond "
                    "tolerance of the fast lane's")
            print(f"[9b coupler vs phase 5] max |diff| / scale "
                  f"{float(dev.max() / fast_acc.abs().max()):.3e}, cells "
                  f"differing {int((dev > 0).sum())} of {dev.numel()}")

    # phase 10: ROADMAP item 9 on the headline and DEM worlds, each also
    # card against CPU on a 50k-berg world
    r = phase_coupled_cross(ibp, torch, device)
    print(f"[10a cross-check] {json.dumps(r)}")
    res, launches = phase_coupled(ibp, torch, device, kernels,
                                  args.profile_out)
    for k, n in launches.items():
        if n:
            by_path.setdefault(k, {})["coupled_run"] = n
    print(f"[10a coupled run] {json.dumps(res)}")
    for k in ("permute_cols_u32", "extract_sorted", "segment_spread_sums"):
        require(launches[k] > 0, f"kernel {k} was not launched by the "
                "coupled run")
    r = phase_cross(ibp, torch, device, None, SORTED_KW)
    print(f"[10b cross-check] {json.dumps(r)}")
    require(r["overflow"] == 0, f"10b cross-check: contact_overflow "
            f"{r['overflow']}")
    run_path("10b per-step sorted", "perstep_sorted",
             ("permute_cols_u32", "eval_pair_ia_kernel",
              "segment_spread_sums"), multi_kw=SORTED_KW)
    r = phase_cross(ibp, torch, device, None, BONDED_KW,
                    world=bonded_world(ibp, torch, device))
    print(f"[10c cross-check] {json.dumps(r)}")
    require(r["overflow"] == 0, f"10c cross-check: contact_overflow "
            f"{r['overflow']}")
    bworld = bonded_world(ibp, torch, device, dem)
    bcfg, bst = bworld[0], bworld[3]
    # K7 on the bond table (M = max_bonds).  At rest every bond sits at
    # its rest length and none pulls; each element moved by up to 2 m (as
    # a few steps of drift move them) over-stretches about half
    g = torch.Generator(device=device).manual_seed(3)

    def moved(x):
        return x + (torch.rand(x.shape, generator=g, device=device) - .5) * 4.
    kst = bst.replace(lon_old=moved(bst.lon_old), lat_old=moved(bst.lat_old))
    kres["eval_pair_ia_kernel/bonds"] = k7_case(
        torch, forces, pairs, kst, bworld[1], bcfg, False,
        pd=forces.precompute_pair_data(
            kst, bcfg, *forces.bond_partner_table(kst), bonded=True))
    del kst
    r = kres["eval_pair_ia_kernel/bonds"]
    print(f"[10c kernel] eval_pair_ia_kernel/bonds: kernel {r['ms']:.4f} "
          f"ms, plain {fmt(r['plain_ms'])}, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}), max_abs_err {r['err']} ({r['note']})")
    run_path("10c bonded fused3", "bonded_fused3",
             ("permute_cols_u32", "extract_sorted", "eval_pair_ia_kernel",
              "segment_spread_sums"), multi_kw=BONDED_KW, world=bworld)
    del bworld, bst
    torch.cuda.empty_cache()

    phase11(ibp, torch, device, kernels, by_path, kres, dcfg, dem,
            dem_s_per_step, args.profile_out)
    del dem
    torch.cuda.empty_cache()
    phase12(ibp, torch, device, kernels, by_path, kres, args.profile_out)
    phase13(ibp, torch, device, kernels, by_path)
    phase14(ibp, torch, device, kernels, by_path, kres, args.profile_out)
    phase15(ibp, torch, device, kernels, by_path, perstep["fused3"],
            args.profile_out)
    phase16(ibp, torch, device, kernels, by_path, args.profile_out)

    source = {"permute_cols_u32": ("permute_cols.cu",
                                   "icebergs_tpu/ops/pallas_pack.py:30"),
              "pack_rows_u32": ("permute_cols.cu",
                                "icebergs_tpu/ops/pallas_pack.py:30"),
              "gather_rows_u32": ("permute_cols.cu",
                                  "icebergs_tpu/ops/pallas_pack.py:62"),
              "extract_sorted": ("extract_sorted.cu",
                                 "icebergs_tpu/ops/pallas_prepass.py:625"),
              "extract_sorted/grouped": (
                  "extract_sorted.cu", "icebergs_tpu/ops/pallas_prepass.py:625"),
              "extract_sorted/epilogue": (
                  "extract_sorted.cu", "icebergs_tpu/ops/pallas_prepass.py:625"),
              "segment_spread_sums/assoc": (
                  "segment_sums.cu", "icebergs_tpu/ops/pallas_spread.py:136"),
              "segment_spread_sums": ("segment_spread.cu",
                                      "icebergs_tpu/ops/pallas_spread.py:136"),
              "segment_spread_sums/extra14": (
                  "segment_spread.cu", "icebergs_tpu/ops/pallas_spread.py:136"),
              "segment_spread_sums/extra0": (
                  "segment_spread.cu", "icebergs_tpu/ops/pallas_spread.py:136"),
              "eval_pair_ia_kernel/bonds": (
                  "pair_eval.cu", "icebergs_tpu/ops/pallas_pairs.py:108"),
              "dem_substeps": ("dem_substeps.cu",
                               "icebergs_tpu/ops/dem_vmem.py:691"),
              "contact_prepass_sorted": (
                  "prepass_sorted.cu", "icebergs_tpu/ops/pallas_prepass.py:67"),
              "interp_sorted": ("interp_sorted.cu",
                                "icebergs_tpu/ops/pallas_interp.py:275"),
              "eval_pair_ia_kernel": ("pair_eval.cu",
                                      "icebergs_tpu/ops/pallas_pairs.py:108"),
              "eval_pair_ia_kernel/m400": (
                  "pair_eval.cu", "icebergs_tpu/ops/pallas_pairs.py:108"),
              "extract_sorted/latlon": (
                  "extract_sorted.cu", "icebergs_tpu/ops/pallas_prepass.py:625"),
              "extract_sorted/grouped_latlon": (
                  "extract_sorted.cu", "icebergs_tpu/ops/pallas_prepass.py:625"),
              "contact_prepass_sorted/latlon": (
                  "prepass_sorted.cu", "icebergs_tpu/ops/pallas_prepass.py:67"),
              "dem_substeps/latlon": ("dem_substeps.cu",
                                      "icebergs_tpu/ops/dem_vmem.py:691"),
              "dem_substeps/hex": ("dem_substeps.cu",
                                   "icebergs_tpu/ops/dem_vmem.py:691")}
    # the grouped K2 row is the DEM path's K2, the plain row the others';
    # K3's 14-column row is the per-step and DEM paths', the plain row the
    # persistent lanes' (3 columns)
    # the MTS paths' K2 is the grouped one (Part 1); their K3 takes 14
    # columns but on the coupled entry and the KID paths (no melt columns)
    # phase 12's lat-lon paths launch the lat-lon instantiations: K2's
    # grouped one on the lat-lon DEM path, its fused3 one on the lat-lon
    # and tripolar paths; K5's and K4's lat-lon forms
    def split(src, dst, paths):
        d = by_path.get(src, {})
        by_path[dst] = {p: d.pop(p) for p in list(d) if p in paths}
    split("extract_sorted", "extract_sorted/grouped_latlon", ("ll_dem",))
    split("extract_sorted", "extract_sorted/latlon",
          ("ll_fast_lane", "tripolar_coupled_run"))
    split("contact_prepass_sorted", "contact_prepass_sorted/latlon",
          ("ll_persistent_fused_kernel",))
    split("dem_substeps", "dem_substeps/latlon", ("ll_dem",))
    split("dem_substeps", "dem_substeps/hex", ("hex_dem",))
    k2 = by_path.get("extract_sorted", {})
    by_path["extract_sorted/grouped"] = {
        p: k2.pop(p) for p in list(k2)
        if p in ("dem", "driver_dem", "hex_dem", "tiled_dem_mts")
        or p.startswith("mts_")}
    k3 = by_path.get("segment_spread_sums", {})
    by_path["segment_spread_sums/extra14"] = {
        p: k3.pop(p) for p in list(k3)
        if p in ("dem", "bonded_fused3", "mts_scan", "mts_pairs",
                 "mts_cross_scan", "mts_cross_pairs", "ll_dem",
                 "driver_headline", "driver_dem", "tiled_perstep_fused3",
                 "tiled_2d_perstep_fused3", "tiled_dem_mts")
        or p.startswith("perstep_")}
    by_path["segment_spread_sums/extra0"] = {
        p: k3.pop(p) for p in list(k3)
        if p in ("coupled_run", "tripolar_coupled_run", "tiled_coupled_run")
        or p.startswith("mts_")}
    # K7: the launches at M = 400 are the m400 row's (the tables Part 1
    # of 11c and 11c-dense, and the same-conglomerate contact group of the
    # KID paths); of the rest, the bonded and MTS paths' are the bond
    # table's (M = max_bonds)
    k7 = by_path.get("eval_pair_ia_kernel", {})
    for p, nt in by_path.get("eval_pair_ia_kernel/m400", {}).items():
        k7[p] -= nt
        if not k7[p]:
            del k7[p]
    by_path["eval_pair_ia_kernel/bonds"] = {
        p: k7.pop(p) for p in list(k7)
        if p == "bonded_fused3" or p.startswith("mts_")}
    rows = [{"name": k, "route": "cuda",
             "source": f"icebergs_tpu_torch/csrc/{source[k][0]}",
             "replaces": source[k][1],
             "launches": sum(by_path.get(k, {}).values()),
             "launches_by_path": by_path.get(k, {}),
             "max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
             "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
            for k, r in kres.items()]
    # the rule-2 order of the redesigns: launches x (ms - bound_ms) over
    # every path's first timed window (K1's row times one shape, the
    # re-sort; its [3 k1] lines give the others); phase 11d's small
    # cross-check worlds are not timed windows
    def timed(r):
        return sum(n for p, n in r["launches_by_path"].items()
                   if not p.startswith("mts_cross_"))
    cost = sorted(((timed(r) * (r["ms"] - r["bound_ms"]), r["name"])
                   for r in rows), reverse=True)
    print("[rule2] launches x (ms - bound_ms): " + ", ".join(
        f"{n} {c:.2f}" for c, n in cost))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stand-alone driver, the counterpart of ``driver/icebergs_driver.F90``.

Counterpart of ``icebergs_tpu/driver.py``: reads the reference's
``input.nml`` (``icebergs_driver_nml`` and ``icebergs_nml``), builds the
synthetic grid and forcing of the test cases (a uniform Cartesian or
lat-lon box; the converging collision jet, driver:313-327; the Gaussian
grounding bump, 288-307; the footloose jet, 309-311) or the A68
hindcast's curvilinear grid and hourly forcing, loads the
``icebergs.res.nc`` / ``bonds_iceberg.res.nc`` / ``calving.res.nc``
initial conditions of the makeberg tooling, runs the time loop, and
writes restarts, trajectories and the diagnostics' history file.

The run is on CUDA unless the caller asks for the CPU (``device="cpu"``,
``--device cpu``).  A kernel that fails to build or launch raises out of
:func:`run`: nothing falls back to another lane.  The loop reads the
device on the host once a step, for the overflow counters of the growth
loop; the step itself makes none (but the MTS force-convergence reads),
and the budgets, progress lines and the checksum read only on their own
steps.

CLI:  python -m icebergs_tpu_torch.driver --nml input.nml
          [--input-dir DIR] [--output-dir DIR] [--capacity N]
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from . import trace


def build_grid_and_forcing(cfg, drv, dtype=torch.float32, *, device):
    """Synthetic grid and forcing from icebergs_driver_nml
    (driver/icebergs_driver.F90:196-328)."""
    from . import forcing as F
    from . import grid as G
    from .api import prepare_forcing

    ni = int(drv.get("ni", 20))
    nj = int(drv.get("nj", 20))
    gridres = float(drv.get("gridres", 1000.0))
    ibuo = float(drv.get("ibuo", 0.0))
    ibvo = float(drv.get("ibvo", 0.0))
    ibui = float(drv.get("ibui", 0.0))
    ibvi = float(drv.get("ibvi", 0.0))
    ibua = float(drv.get("ibua", 0.0))
    # the reference names the meridional wind "ibuy" (driver:74); ibva is
    # an alias
    ibva = float(drv.get("ibuy", drv.get("ibva", 0.0)))
    sst0 = float(drv.get("sst", -2.0))

    if cfg.grid_is_latlon:
        # a simple lat-lon box (the A68 case reads its grid from file)
        dll = float(drv.get("dlonlat", 0.125))
        grid = G.make_uniform_grid(ni, nj, float(drv.get("lon0", 0.0)),
                                   float(drv.get("lat0", -70.0)), dll, dll,
                                   grid_is_latlon=True, Rearth=cfg.Rearth,
                                   dtype=dtype, device=device)
    else:
        grid = G.make_uniform_grid(ni, nj, 0.0, 0.0, gridres, gridres,
                                   grid_is_latlon=False, dtype=dtype,
                                   device=device)
    frc = F.uniform_forcing(grid.nx, grid.ny, uo=ibuo, vo=ibvo, ui=ibui,
                            vi=ibvi, ua=ibua, va=ibva, sst=sst0, sss=33.0,
                            dtype=dtype, device=device)

    def t(a):
        return torch.as_tensor(a).to(device, dtype)

    xc = gridres * np.arange(ni + 1)[:, None] * np.ones((1, nj + 1))
    yc = gridres * np.arange(nj + 1)[None, :] * np.ones((ni + 1, 1))
    if drv.get("collision_test"):
        # a converging meridional jet toward y = mid (driver:313-327)
        mid = 10.e3
        vo = np.where((xc > mid) | (xc <= 0.) | (yc == mid), 0.,
                      np.where(yc > mid, -ibvo, ibvo))
        frc = frc.replace(vo=t(vo))
    if drv.get("fl_test"):
        frc = frc.replace(vo=t(np.where(xc > 10000., -ibvo, ibvo)))
    if drv.get("big_grounding_test"):
        # a Gaussian seamount and N/S land strips (driver:288-307): height
        # 1000 - bump_depth, width 5 km, centre (63, 60) km
        xm = gridres * (np.arange(ni) + 0.5)
        ym = gridres * (np.arange(nj) + 0.5)
        X, Y = np.meshgrid(xm, ym, indexing="ij")
        a = 1000.0 - float(drv.get("bump_depth", 0.0))
        c = 5.e3
        bump = a * np.exp(-((X - 63.e3) ** 2 + (Y - 60.e3) ** 2)
                          / (2. * c * c))
        msk2 = grid.msk.cpu().numpy().copy()
        land = (Y <= -5.e3) | (Y >= 220.e3)
        msk2[1:-1, 1:-1] = np.where(land, 0.0, msk2[1:-1, 1:-1])
        grid = grid.replace(ocean_depth=t(np.pad(1000.0 - bump, 1)),
                            msk=t(msk2))
    else:
        # a deep ocean, so that nothing grounds
        grid = grid.replace(ocean_depth=torch.full_like(grid.ocean_depth,
                                                        1000.0))
    # the reference driver hands ibua / ibuy to icebergs_run in the
    # wind-stress slots (driver:225, 389), so the interface applies
    # (icebergs.F90:5236-5383)
    return grid, prepare_forcing(grid, cfg, frc)


def _choose_substep_kernel(st, cfg, substep_kernel, fdtype, verbose):
    """The MTS substep loop's implementation
    (``icebergs_tpu/driver.py:219-256``): K4 when the state is on CUDA in
    float32 (or ``substep_kernel="vmem"``; on the CPU its plain version),
    the flag set is K4's and the bond topology packs into block-closed
    conglomerate blocks, else the scan.
    Returns ``(state, make_step keywords)``; packing may grow the
    capacity to whole blocks (one block of up to 4096 slots, rounded to
    128, or 1024-slot blocks, as the JAX package; on the card a block is
    at most K4's one CTA of 512 threads)."""
    from .ops import dem_substeps as DS
    on_card = st.device.type == "cuda"
    want = (substep_kernel == "vmem"
            or (substep_kernel == "auto" and on_card
                and fdtype == torch.float32))
    if not (want and cfg.mts and cfg.dem and cfg.iceberg_bonds_on
            and cfg.n_sub_steps > 0 and DS.supports_vmem_substeps(cfg)):
        return st, {}
    lat = st.lat[st.alive]
    if cfg.grid_is_latlon and lat.numel() and float(lat.max()) >= 85.0:
        return st, {}
    bn = -(-st.capacity // 128) * 128 if st.capacity <= 4096 else 1024
    if on_card:
        bn = min(bn, DS.MAX_BLOCK)
    try:
        st2 = DS.pack_conglomerates_blocked(st, bn)
        deltas = DS.analyze_bond_deltas(st2.bond_idx, bn)
    except ValueError:
        deltas = None
    if not deltas or not (st2.capacity == bn or bn % 1024 == 0 or on_card):
        return st, {}
    if verbose:
        print(f"KID-TPU driver: substep kernel K4 on (block_n={bn}, "
              f"deltas={deltas}, capacity={st2.capacity})")
    return st2, dict(mts_substep_kernel="vmem", mts_vmem_deltas=deltas,
                     mts_vmem_block_n=bn)


def _overflows(diags, cfg, pair_capped):
    """The growth loop's counters (footloose spawns denied, the frozen
    pair list's overflow, the contact search's and Part 1's drops) as
    one device vector, or None when the step reports none."""
    pair = (diags.contact_overflow if cfg.mts and pair_capped else None)
    fused = diags.contact_overflow if not cfg.mts else None
    parts = [diags.fl_spawn_overflow, pair, fused, diags.p1_overflow]
    if all(p is None for p in parts):
        return None
    zero = next(p for p in parts if p is not None).new_zeros(())
    return torch.stack([(zero if p is None else p).to(torch.int64)
                        for p in parts])


def run(nml_path: str, input_dir: str = ".", output_dir: str = ".",
        capacity: int = 4096, verbose: bool = True,
        neighbor_window: str = "auto", mts_pair_cap: int = None,
        dtype: str = "float32", substep_kernel: str = "auto",
        clocks: bool = False, cfg_overrides: dict = None, *,
        device="cuda", fl_uniforms=None, report: dict = None):
    """The main loop (driver/icebergs_driver.F90:339-444); returns the
    final state.

    ``device`` is where the model runs (CUDA unless the caller asks for
    the CPU).  ``dtype="float64"`` runs the model in double precision
    (the reference's ``-r8``) on the CPU: the CUDA kernels take float32
    slabs and refuse it.  ``fl_uniforms(n)`` gives
    step ``n``'s footloose uniforms (``uniforms(stream, state)``; by
    default :func:`.footloose.id_hash_uniforms` of (7, n)).  A
    ``report`` dict receives the loop's and the output writing's wall
    seconds, the steps, the host reads the loop made and each output
    file's bytes."""
    from . import diag, model
    from .calving import init_calving_state
    from .diagnostics import (DiagManager, collect_forcing_fields,
                              collect_step_fields)
    from .footloose import id_hash_uniforms
    from .io import restart as rio
    from .io import trajectory as tio
    from .io.namelist import config_from_namelist
    from .ops import forces as FO
    from .state import create_bergs, empty_state, grow_capacity

    device = torch.device(device)
    fdtype = torch.float64 if dtype in ("float64", "f64") else torch.float32
    if fl_uniforms is None:
        def fl_uniforms(n):
            return id_hash_uniforms(7, n)

    if not os.path.exists(nml_path):
        raise SystemExit(f"icebergs_tpu_torch.driver: namelist not found: "
                         f"{nml_path}")
    cfg, drv = config_from_namelist(nml_path)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    # the transient A68 hindcast (driver:254-272, 368-385): hourly forcing
    # files from data_dir, 30-min or 1-hr steps
    a68_data = None
    start_ind = int(drv.get("transient_a68_data_start_ind", 0))
    if drv.get("a68_test") and start_ind > 0:
        from .io import a68 as a68io
        if cfg.dt not in (1800.0, 3600.0):
            raise SystemExit("icebergs_tpu_torch.driver: transient A68 data "
                             "requires ibdt of 30 min or 1 hr")
        data_dir = str(drv.get("data_dir", input_dir))
        a68_data = a68io.load_a68(data_dir, cfg, device=device)
        grid = a68_data.grid
        frc = a68io.forcing_at_hour(a68_data, start_ind - 1)
        print(f"KID-TPU driver: transient A68 forcing from {data_dir} "
              f"({a68_data.n_hours} hourly frames, start index "
              f"{start_ind})")
    else:
        grid, frc = build_grid_and_forcing(cfg, drv, dtype=fdtype,
                                           device=device)
    # bathymetry from topog.nc when given (read_ocean_depth,
    # icebergs_fms2io.F90:1600-1629)
    grid = rio.read_ocean_depth(os.path.join(input_dir, "topog.nc"), grid)

    berg_restart = os.path.join(input_dir, "icebergs.res.nc")
    if os.path.exists(berg_restart):
        st = rio.read_restart_bergs(berg_restart, capacity, grid, cfg,
                                    dtype=fdtype)
    elif cfg.generate_test_icebergs:
        # the debug generator: 4 bergs over the domain (generate_bergs,
        # icebergs_fms2io.F90:1051-1154)
        from .grid import pos_to_cell
        fx = np.array([0.3, 0.7, 0.3, 0.7]) * grid.nx
        fy = np.array([0.3, 0.3, 0.7, 0.7]) * grid.ny
        st = create_bergs(capacity,
                          lon=float(grid.lon0) + fx * float(grid.dlon),
                          lat=float(grid.lat0) + fy * float(grid.dlat),
                          mass=8.8e7, thickness=40., width=182.,
                          length=273., mass_scaling=1.0,
                          id_cnt=np.arange(4) + 1, device=device)
        Lx = cfg.Lx if cfg.grid_is_latlon else -1.
        i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, Lx)
        st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    elif cfg.require_restart:
        raise SystemExit(f"no initial bergs found at {berg_restart}")
    else:
        st = empty_state(capacity, max_bonds=cfg.max_bonds, dtype=fdtype,
                         device=device)
    if cfg.static_icebergs:
        # the Static_icebergs switch holds every berg in place
        # (icebergs_framework.F90:826)
        st = st.replace(static_berg=torch.ones_like(st.static_berg))
    # constant-L/W interactions: the constants from the loaded elements
    # when the namelist left them 0 (icebergs.F90:175-177)
    cfg = FO.set_constant_interaction_length_and_width(cfg, st)
    bond_restart = os.path.join(input_dir, "bonds_iceberg.res.nc")
    if cfg.iceberg_bonds_on and os.path.exists(bond_restart):
        st = rio.read_restart_bonds(bond_restart, st, cfg)
    elif cfg.iceberg_bonds_on and cfg.manually_initialize_bonds:
        st = FO.initialize_bonds_host(st, cfg)
    calving_restart = os.path.join(input_dir, "calving.res.nc")
    calv = init_calving_state(grid)
    if os.path.exists(calving_restart):
        calv = rio.read_restart_calving(calving_restart, calv, grid)

    ibdt = cfg.dt
    nsteps = min(int(round(float(drv.get("ibhrs", 24)) * 3600.0 / ibdt)),
                 int(drv.get("nmax", 10 ** 9)))
    traj_every = max(1, int(round(cfg.traj_sample_hrs * 3600.0 / ibdt)))

    if neighbor_window == "auto":
        # the 2x2 quadrant window is an exact superset only when the
        # pair cutoff is below half a cell
        neighbor_window = ("quadrant" if FO.can_use_quadrant_window(
            st, grid, cfg) and not cfg.mts
            and FO.neighbor_radius(grid, cfg) == 1 else "full")
        if verbose and neighbor_window == "quadrant":
            print("KID-TPU driver: using the quadrant neighbor window")
    st, vmem_kw = _choose_substep_kernel(st, cfg, substep_kernel, fdtype,
                                         verbose)
    if (mts_pair_cap is None and cfg.mts and cfg.dem
            and not cfg.use_broken_bonds_for_substep_contact
            and not vmem_kw and bool(st.alive.any())):
        # size the frozen substep pair list from the initial state (only
        # the use_broken_bonds=False regime runs substep contact off it)
        from .mts import auto_pair_cap
        nbr0 = FO.build_neighbor_tables(
            st, grid, cfg, max_per_cell=16,
            ncells_radius=FO.neighbor_radius(grid, cfg))
        mts_pair_cap = auto_pair_cap(st, nbr0, cfg)
        if verbose:
            print(f"KID-TPU driver: auto mts_pair_cap={mts_pair_cap}")
    fused_fb_cap = cfg.fused_fallback_cap

    def build_step(pair_cap, fb_cap):
        return model.make_step(grid, cfg, with_thermo=True,
                               neighbor_window=neighbor_window,
                               mts_pair_cap=pair_cap,
                               fused_fallback_cap=fb_cap, **vmem_kw)

    step = build_step(mts_pair_cap, fused_fb_cap)
    nsamples = max(2, nsteps // traj_every + 2)
    buf = tio.init_traj_buffer(st.capacity, nsamples=nsamples, cfg=cfg,
                               device=device)
    bond_buf = (tio.init_bond_traj_buffer(st.capacity, cfg.max_bonds,
                                          nsamples=nsamples, device=device)
                if cfg.save_bond_traj else None)
    dmgr = DiagManager(grid)              # the reference's full catalog
    dstate = dmgr.init_state()
    verbose_every = max(1, int(round(cfg.verbose_hrs * 3600.0 / ibdt)))
    progress_every = max(1, int(drv.get("write_time_inc", nsteps // 10)))

    ffields = collect_forcing_fields(frc, grid)
    ffields_frc = frc
    b0 = diag.compute_budgets(st, calv)
    b_prev = b0
    melt_total = melt_interval = 0.0      # kg, accumulated on the device
    reads = 0                             # host reads in the loop
    t_wall = time.time()
    # the mpp_clock analog (icebergs_framework.F90:896-908): the loop's
    # phases are spans of the tracer; with ``clocks`` each also takes the
    # device's time from CUDA events, read as they complete (nothing in
    # the loop waits for the card), and the table is printed at the end
    if clocks:
        trace.reset()
        traced = trace.configure(enabled=True, device=device.type == "cuda")
    # the interval sources and sinks of the category budget tables
    acc = diag.IntervalBudget()
    for n in range(nsteps):
        with trace.span("Icebergs-interface"):
            if a68_data is not None:
                # the hourly frames (driver:368-385): ns2 advances by
                # dt/3600 a step; half-hour steps blend the velocities of
                # two frames, SSH takes the floor frame
                ns2 = 1.0 + n * cfg.dt / 3600.0
                if cfg.dt == 3600.0 or float(ns2).is_integer():
                    frc = a68io.forcing_at_hour(a68_data,
                                                start_ind + int(ns2) - 2)
                else:
                    fnew = a68io.forcing_at_hour(
                        a68_data, start_ind + math.ceil(ns2) - 2)
                    frc = frc.replace(
                        ua=0.5 * (frc.ua + fnew.ua),
                        va=0.5 * (frc.va + fnew.va),
                        uo=0.5 * (frc.uo + fnew.uo),
                        vo=0.5 * (frc.vo + fnew.vo), ssh=a68io.forcing_at_hour(
                            a68_data, start_ind + int(ns2) - 2).ssh)

        def call_step(s):
            if cfg.footloose:
                # a per-step stream keyed on the berg ids keeps restarts
                # and layouts reproducible
                return step(s, frc, fl_uniforms=fl_uniforms(n),
                            current_yearday=torch.full(
                                (), n * ibdt / 86400., dtype=torch.float32,
                                device=device))
            return step(s, frc)

        with trace.span("Icebergs-step"):
            st_prev = st
            st, diags = call_step(st)
            # the increase_ibuffer analog
            # (icebergs_framework.F90:3710-3747): when a spawn found no free
            # slot, the frozen MTS pair list or the contact search's
            # fallback overflowed, grow what ran out, rebuild the step and
            # re-run it from the pre-step state: an overflow is corrected,
            # never only counted
            for _ in range(3):
                ov = _overflows(diags, cfg, mts_pair_cap is not None)
                if ov is None:
                    break
                fl_ov, pair_ov, fused_ov, p1_ov = ov.tolist()
                reads += 1
                fused_ov += p1_ov
                if fl_ov == 0 and pair_ov == 0 and fused_ov == 0:
                    break
                if fl_ov > 0:
                    newcap = max(2 * st_prev.capacity,
                                 st_prev.capacity + 4 * fl_ov)
                    print(f"KID-TPU driver: slot pool exhausted at step "
                          f"{n + 1} ({fl_ov} spawns denied) — growing "
                          f"capacity {st_prev.capacity} -> {newcap}",
                          flush=True)
                    st_prev = grow_capacity(st_prev, newcap)
                    buf = tio.grow_traj_buffer(buf, newcap)
                    if bond_buf is not None:
                        bond_buf = tio.grow_traj_buffer(
                            bond_buf, newcap * cfg.max_bonds)
                if pair_ov > 0:
                    mts_pair_cap = 2 * mts_pair_cap
                    print(f"KID-TPU driver: MTS pair list overflowed at "
                          f"step {n + 1} ({pair_ov} pairs) — growing "
                          f"pair cap to {mts_pair_cap}", flush=True)
                if fused_ov > 0:
                    # the exact-search contract: dropped candidates grow
                    # the fallback compaction cap and the step re-runs
                    fused_fb_cap = min(4 * fused_fb_cap, st_prev.capacity)
                    print(f"KID-TPU driver: contact fallback cap overran "
                          f"at step {n + 1} ({fused_ov} dropped) — growing "
                          f"to {fused_fb_cap}", flush=True)
                step = build_step(mts_pair_cap, fused_fb_cap)
                st, diags = call_step(st_prev)
        with trace.span("Icebergs-diagnostics"):
            if cfg.debug_iceberg_with_id > 0:
                # monitor_a_berg (icebergs_framework.F90:4245-4269)
                from .diagnostics import monitor_a_berg
                monitor_a_berg(st, cfg.debug_iceberg_with_id,
                               label=f"step {n + 1}")
                reads += 1
            if diags.floating_melt is not None:
                m = ((diags.floating_melt * grid.area).sum().double()
                     * cfg.dt)
                melt_total = melt_total + m
                melt_interval = melt_interval + m
            if ffields_frc is not frc:        # recomputed on a forcing swap
                ffields = collect_forcing_fields(frc, grid)
                ffields_frc = frc
            dstate = dmgr.send_data(dstate, collect_step_fields(
                diags, st=st, cfg=cfg, grid=grid, forcing_fields=ffields,
                extra={"stored_ice": calv.stored_ice,
                       "stored_heat": calv.stored_heat,
                       "running_mean_calving": calv.rmean_calving,
                       "running_mean_calving_hflx":
                           calv.rmean_calving_hflx}))
        if (n + 1) % traj_every == 0 and not cfg.ignore_traj:
            with trace.span("Icebergs-traj record"):
                day = (n + 1) * ibdt / 86400.0
                buf = tio.record_posn(buf, st, cfg, day=day, year=0)
                if cfg.save_bond_traj:
                    bond_buf = tio.record_bonds(bond_buf, st, cfg, day=day)
        acc.add_step(diags, grid, ibdt)
        if verbose and (n + 1) % verbose_every == 0:
            b_now = diag.compute_budgets(st, calv)
            diag.report_budget(f"hr {((n + 1) * ibdt) / 3600.:.0f}",
                               b_prev, b_now, verbose_every * ibdt,
                               melt_kg=float(melt_interval))
            diag.report_full_budget(
                f"hr {((n + 1) * ibdt) / 3600.:.0f}", b_prev, b_now, acc)
            reads += 1
            acc.reset()
            b_prev = b_now
            melt_interval = 0.0
        if verbose and (n + 1) % progress_every == 0:
            print(f"step {n + 1}/{nsteps} bergs={int(diags.nbergs)} "
                  f"wall={time.time() - t_wall:.1f}s", flush=True)
            reads += 1
        if cfg.debug and (n + 1) % verbose_every == 0:
            diag.check_state(st, grid, cfg, label=f"step {n + 1}")
            reads += 1
        if cfg.halo_debugging and (n + 1) % verbose_every == 0:
            diag.dump_halo_state(st, label=f"step {n + 1}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_loop = time.time() - t_wall

    b1 = diag.compute_budgets(st, calv)
    diag.report_budget("driver", b0, b1, nsteps * ibdt,
                       melt_kg=float(melt_total))
    cs, nb = diag.berg_chksum(st)
    print(f"KID-TPU, bergs_chksum: write_restart berg chksum="
          f"{int(cs)} #={int(nb)}")

    os.makedirs(output_dir, exist_ok=True)
    t_io = time.time()
    with trace.span("Icebergs-I/O write"):
        written = []
        if drv.get("saverestart", False):
            written.append("icebergs.res.nc")
            rio.write_restart_bergs(os.path.join(output_dir, written[-1]),
                                    st, cfg)
            if cfg.iceberg_bonds_on:
                written.append("bonds_iceberg.res.nc")
                rio.write_restart_bonds(os.path.join(output_dir, written[-1]),
                                        st, cfg)
            written.append("calving.res.nc")
            rio.write_restart_calving(os.path.join(output_dir, written[-1]),
                                      calv, grid)
        if not cfg.ignore_traj:
            written.append(cfg.traj_name)
            tio.write_trajectories(os.path.join(output_dir, cfg.traj_name),
                                   buf, cfg)
        if cfg.save_bond_traj:
            written.append(cfg.bond_traj_name)
            tio.write_trajectories(
                os.path.join(output_dir, cfg.bond_traj_name), bond_buf, cfg)
        written.append("icebergs_history.nc")
        dmgr.flush(dstate, os.path.join(output_dir, written[-1]),
                   time_value=nsteps * ibdt / 86400.)
    if clocks:
        trace.report()
        trace.configure(**traced)
    t_io = time.time() - t_io
    secs = time.time() - t_wall
    sim_days = nsteps * ibdt / 86400.
    if sim_days > 0:
        # the reference driver's timing line (icebergs_driver.F90:355-366)
        print(f"KID-TPU driver: {secs / sim_days:.1f} s per simulated "
              f"day ({sim_days:.2f} days)")
    print(f"KID-TPU driver: {nsteps} steps in {secs:.1f}s "
          f"({nsteps / max(secs, 1e-9):.2f} steps/s)")
    if report is not None:
        report.update(
            steps=nsteps, loop_s=t_loop, io_s=t_io, host_reads=reads,
            files={f: os.path.getsize(os.path.join(output_dir, f))
                   for f in written})
    return st


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nml", required=True)
    p.add_argument("--input-dir", default=".")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--capacity", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda, or cpu)")
    p.add_argument("--neighbor-window", default="auto",
                   choices=("auto", "full", "quadrant"),
                   help="contact candidate window (auto: quadrant when "
                        "the pair cutoff is below half a cell)")
    p.add_argument("--mts-pair-cap", type=int, default=None,
                   help="compact MTS substep contacts to this many pairs "
                        "(size >= same-conglomerate neighbor pairs)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"),
                   help="model precision (float64 = the reference's -r8)")
    p.add_argument("--substep-kernel", default="auto",
                   choices=("auto", "scan", "vmem"),
                   help="MTS substep loop: auto = K4 on CUDA in float32 "
                        "when the bond topology qualifies, the scan "
                        "otherwise; vmem = K4 (its plain version on the "
                        "CPU)")
    p.add_argument("--clocks", action="store_true",
                   help="per-phase clock table at the end of the run "
                        "(mpp_clock analog): host and device ms a phase")
    a = p.parse_args(argv)
    run(a.nml, a.input_dir, a.output_dir, a.capacity,
        neighbor_window=a.neighbor_window, mts_pair_cap=a.mts_pair_cap,
        dtype=a.dtype, substep_kernel=a.substep_kernel, clocks=a.clocks,
        device=a.device)


if __name__ == "__main__":
    main()

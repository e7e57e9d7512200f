"""The port's MTS scan substep path (``icebergs_tpu_torch/mts.py``)
against the JAX package's: the substep contact masks, the frozen pair
list (``_pair_keep_mask``, ``compact_conglom_pairs``, ``auto_pair_cap``,
``_pair_contact_masks``), one substep's forces (DEM and not), the
implicit inner acceleration, and whole outer steps of
``evolve_icebergs_mts`` through the scan: the K4 flag set, the reference
defaults (dense and with a pair list), outer-step fracture, Part 1 on
the candidate tables against the fused search, the DEM beam tests, MTS
without DEM (explicit, and implicit with force convergence), the step
entry with ``mts_pair_cap`` and ``mts_neighbor_mode="tables"``, and the
golden ``mts_dem_bonded`` scenario.  The world is that of
``tests/test_torch_dem_forces.py``: three bonded 6x6 conglomerates in
128 slots.

The JAX functions run op by op (``jax.disable_jit``), which keeps
XLA:CPU from contracting multiply-adds.  Integers and counters (ids,
cells, bond tables, ``broken_bonds``, ``conv_iters``,
``pair_overflow``, ``skin_dropped``, the pair list) must be exact.
Floats: each test states its tolerance; the one source of difference
left is torch's CPU float32 ``sqrt``, which rounds near-halfway roots 1
ulp low (``tests/test_torch_dem_forces.py``), and what the stiff
substeps (k = 5e6 at dtf 10 s) make of such an ulp over 12 substeps.
The port's scan against the port's K4 plain version: within 5e-6 of
scale, the JAX package's own gate between its kernel and its scan
(``tests/test_dem_vmem.py:103-109``), with ``broken_bonds`` equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import mts as jmts
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.model import make_multi_step as jax_multi
from icebergs_tpu.ops import dem_vmem as jvmem
from icebergs_tpu.ops import forces as jforces

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import mts as tmts
from icebergs_tpu_torch.diag import berg_chksum
from icebergs_tpu_torch.ops import forces as tforces

from test_torch_dem_forces import (CPU, close, eager, jax_cfg, leaves,
                                   moved_state, port_cfg, tstate, world)
from test_golden_chksums import scenario_mts_bonded

torch.set_num_threads(1)
INTS = ("alive", "id_cnt", "ine", "jne", "bond_idx", "bond_broken",
        "n_bonds", "conglom_id")
FLOATS = ("lon", "lat", "uvel", "vvel", "uvel_old", "vvel_old", "axn",
          "ayn", "bxn", "byn", "axn_fast", "ayn_fast", "ang_vel",
          "ang_accel", "rot", "xi", "yj", "bond_length", "bond_tangd1",
          "bond_tangd2", "bond_rel_rotation", "bond_nstress",
          "bond_sstress")
DEFAULTS = dict(use_broken_bonds_for_substep_contact=False,
                break_bonds_on_sub_steps=False, fracture_criterion="none")


def _nbr(st, cfg):
    return eager(jforces.build_neighbor_tables, st, world()[0], cfg,
                 max_per_cell=16, ncells_radius=2)


def _tnbr(nbr):
    return tforces.NeighborTables(*(torch.as_tensor(np.array(x))
                                    for x in nbr))


def _t(x):
    return torch.as_tensor(np.array(x))


def assert_state(ts, js, atol_scale, rtol=1e-5, fields=FLOATS):
    T, J = ibp.to_numpy(ts), leaves(js)
    for name in INTS:
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    live = J["alive"]
    for name in fields:
        close(T[name][live], J[name][live], name, rtol, atol_scale)


def test_contact_masks_match_jax():
    """The dense substep contact mask (same conglomerate, no unbroken
    bond, open slots) over the (N, 400) candidates, exactly."""
    cfg = jax_cfg(**DEFAULTS)
    st = moved_state()
    nbr = _nbr(st, cfg)
    j = np.asarray(eager(jmts._contact_masks, st, nbr, cfg))
    t = tmts._contact_masks(tstate(st), _tnbr(nbr), port_cfg(cfg)).numpy()
    assert j.sum() > 0
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("skin,criterion,cap", [
    (4.0, "stress", 16384), (4.0, "none", 16384), (0.0, "none", 16384),
    (4.0, "stress", 256), (0.0, "none", 2048)],
    ids=["skin_stress", "skin_none", "no_skin", "pair_overflow",
         "row_overflow"])
def test_pair_list_matches_jax(skin, criterion, cap):
    """``_pair_keep_mask``, ``compact_conglom_pairs`` (pairs, validity,
    overflow, skin drops), ``auto_pair_cap`` and the per-substep
    ``_pair_contact_masks`` exactly, with and without the skin and the
    fracture-release term, and past each stage's capacity."""
    cfg = jax_cfg(mts_pair_skin=skin, fracture_criterion=criterion,
                  use_broken_bonds_for_substep_contact=False,
                  break_bonds_on_sub_steps=False)
    tcfg = port_cfg(cfg)
    st = moved_state()
    if cap == 2048:                      # more rows than the row stage
        st = jax.tree.map(lambda a: jnp.concatenate([a] * 12), st)
        st = st.replace(conglom_id=jnp.where(st.alive, 1, 0))
    ts = tstate(st)
    nbr = _nbr(st, cfg) if cap != 2048 else eager(
        jforces.build_neighbor_tables, st, world()[0], cfg,
        max_per_cell=80, ncells_radius=2)
    tnbr = _tnbr(nbr)
    jk, jd = eager(jmts._pair_keep_mask, st, nbr, cfg, cfg.dt)
    tk, td = tmts._pair_keep_mask(ts, tnbr, tcfg, tcfg.dt)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert int(td) == int(jd)
    assert (int(jd) > 0) == (skin > 0)
    j = eager(jmts.compact_conglom_pairs, st, nbr, cap, cfg=cfg, dt=cfg.dt)
    t = tmts.compact_conglom_pairs(ts, tnbr, cap, cfg=tcfg, dt=tcfg.dt)
    for name, a, b in zip(("me", "other", "pvalid", "overflow",
                           "skin_dropped"), t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert (int(j[3]) > 0) == (cap in (256, 2048))
    assert tmts.auto_pair_cap(ts, tnbr, tcfg) == jmts.auto_pair_cap(
        st, nbr, cfg)
    jm = eager(jmts._pair_contact_masks, st, *j[:3], cfg)
    tm = tmts._pair_contact_masks(ts, *t[:3], tcfg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.asarray(jm).sum() > 0


@pytest.mark.parametrize("case", ["broken_bonds", "pairs", "dense",
                                  "beam1", "beam2", "no_dem"])
def test_substep_forces_match_jax(case):
    """One substep's accelerations and bond bookkeeping: contact through
    broken bonds only, through the pair list, through the dense table,
    the beam tests' loads, and MTS without DEM (``calculate_force`` bonds
    and contacts through K7's plain version).  Within ``rtol 1e-6`` plus
    2e-6 of scale (the bond lengths' CPU sqrt ulps)."""
    kw = {} if case == "broken_bonds" else dict(DEFAULTS)
    if case.startswith("beam"):
        kw["dem_beam_test"] = int(case[-1])
    if case == "no_dem":
        kw.update(dem=False)
    cfg = jax_cfg(**kw)
    tcfg = port_cfg(cfg)
    st = moved_state()
    st = st.replace(start_lon=st.lon)
    ts = tstate(st)
    nbr = _nbr(st, cfg)
    pairs = tpairs = None
    if case == "pairs":
        pairs = eager(jmts.compact_conglom_pairs, st, nbr, 16384, cfg=cfg,
                      dt=cfg.dt)[:3]
        tpairs = tuple(_t(x) for x in pairs)
    jst = eager(jdem_static, st) if cfg.dem else None
    ja = eager(jmts._substep_forces, st, nbr, cfg, 10.0, pairs=pairs,
               part_static=jst)
    ta = tmts._substep_forces(ts, _tnbr(nbr), tcfg, 10.0, pairs=tpairs)
    live = np.asarray(st.alive)
    for k in range(3):
        close(ta[k].numpy()[live], np.asarray(ja[k])[live], str(k))
    assert np.abs(np.asarray(ja[0])[live]).max() > 0
    if cfg.dem:
        close(ta[3].nstress, ja[3].nstress, "nstress")
    else:
        assert ta[3] is None and ja[3] is None


def jdem_static(st):
    from icebergs_tpu.ops import dem as jdem
    return jdem.bond_partner_static(st)


def test_inner_accel_implicit_matches_jax():
    """The implicit inner acceleration (accel_mts, mts_part=3: the bond
    and same-conglomerate groups through K7's plain version, the 2x2
    solve twice), MTS without DEM; within ``rtol 1e-6`` plus 2e-6 of
    scale."""
    cfg = jax_cfg(dem=False, explicit_inner_mts=False, **DEFAULTS)
    st = moved_state()
    nbr = _nbr(st, cfg)
    ax_in, ay_in = st.uvel * 1e-4, st.vvel * -1e-4
    j = eager(jmts._inner_accel_implicit, st, nbr, cfg, 10.0, ax_in, ay_in)
    t = tmts._inner_accel_implicit(tstate(st), _tnbr(nbr), port_cfg(cfg),
                                   10.0, _t(ax_in), _t(ay_in))
    for k, (a, b) in enumerate(zip(t, j)):
        close(a, b, str(k))
    assert np.abs(np.asarray(j[2])).max() > 0


def _evolve(cfg, st, **kw):
    grid, frc, _ = world()
    js, jd = eager(jmts.evolve_icebergs_mts, st, grid, frc, cfg, **kw)
    tkw = {k: v for k, v in kw.items() if k != "substep_sync"}
    ts, td = tmts.evolve_icebergs_mts(
        tstate(st), ibp.grid_from_numpy(leaves(grid), device=CPU),
        ibp.forcing_from_numpy(leaves(frc), device=CPU), port_cfg(cfg),
        **tkw)
    assert td.conv_iters == int(jd.conv_iters) >= 1
    assert int(td.broken_bonds) == int(jd.broken_bonds)
    assert int(td.skin_dropped) == int(jd.skin_dropped)
    if jd.pair_overflow is None:
        assert td.pair_overflow is None
    else:
        assert int(td.pair_overflow) == int(jd.pair_overflow)
    return ts, td, js, jd


@pytest.mark.parametrize("jitter,flags,tol", [
    (40.0, {}, 2e-5),
    (2.0, {"short_step_mts_grounding": True, "use_grounding_torque": True,
           "frac_thres_n": 1.8e5}, 2e-3)], ids=["fracturing", "elastic"])
def test_evolve_scan_k4_flags_matches_jax(jitter, flags, tol):
    """One outer step through the scan on the K4 flag set
    (``tests/test_dem_vmem.py:110-117``'s two regimes; Part 1 on the
    tables), against the JAX scan, and the port's scan against the
    port's K4 plain version within 5e-6 of scale with ``broken_bonds``
    equal.  Against JAX: the fracturing world within ``tol`` of scale;
    the elastic world, where nearly cancelling bond forces give the
    accelerations, within 2e-3 (``tests/test_torch_dem.py``'s bound)."""
    cfg = jax_cfg(**flags)
    st = world(jitter=jitter)[2]
    ts, td, js, jd = _evolve(cfg, st, neighbor_mode="tables")
    if jitter > 10:
        assert int(jd.broken_bonds) > 0
    assert_state(ts, js, tol)
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, 128)
    grid, frc, _ = world()
    tk, tkd = tmts.evolve_icebergs_mts(
        tstate(st), ibp.grid_from_numpy(leaves(grid), device=CPU),
        ibp.forcing_from_numpy(leaves(frc), device=CPU), port_cfg(cfg),
        neighbor_mode="tables", substep_kernel="vmem", vmem_deltas=deltas,
        vmem_block_n=128)
    assert int(tkd.broken_bonds) == int(td.broken_bonds)
    K, T = ibp.to_numpy(tk), ibp.to_numpy(ts)
    for name in INTS:
        np.testing.assert_array_equal(T[name], K[name], err_msg=name)
    for name in FLOATS:
        close(T[name], K[name], name, 0., 5e-6)


def test_vmem_without_deltas_raises():
    """Asking for K4 without its bond deltas raises rather than running
    the substeps as the scan."""
    grid, frc, st = world()
    with pytest.raises(ValueError, match="vmem_deltas"):
        tmts.evolve_icebergs_mts(
            tstate(st), ibp.grid_from_numpy(leaves(grid), device=CPU),
            ibp.forcing_from_numpy(leaves(frc), device=CPU),
            port_cfg(jax_cfg()), substep_kernel="vmem")


@pytest.mark.parametrize("regime",["dense", "pair_list", "outer_fracture",
                                    "beam1", "beam2"])
def test_evolve_scan_matches_jax(regime):
    """One outer step through the scan outside the K4 flag set: the
    reference's defaults (no per-substep fracture, contact over the
    frozen same-conglomerate candidates) dense and through the pair
    list, the outer-step fracture (``break_bonds_dem`` before Part 2),
    and the beam tests (their end and centre loads).  Within ``rtol
    1e-5`` plus 1e-4 of scale: the bonds stay elastic here, and the stiff
    substeps grow the CPU sqrt ulps of the bond lengths to ~2e-5 of scale
    (worst read, ``vvel``)."""
    kw = dict(DEFAULTS)
    ekw = dict(neighbor_mode="tables")
    if regime == "pair_list":
        ekw["pair_cap"] = 16384
    if regime == "outer_fracture":
        kw.update(fracture_criterion="stress", frac_thres_n=1.e3)
        ekw["pair_cap"] = 16384
    if regime.startswith("beam"):
        kw.update(dem_beam_test=int(regime[-1]))
    cfg = jax_cfg(**kw)
    st = world()[2]
    # the previous substeps' bond stresses, which the outer-step fracture
    # reads before Part 2: the same on both lanes of a bond, about 1 in
    # 20 past the threshold
    bi = np.asarray(st.bond_idx)
    me = np.broadcast_to(np.arange(bi.shape[0])[:, None], bi.shape)
    ns = np.random.RandomState(5).uniform(0., 1.05e3, (bi.shape[0],) * 2)
    ns = ns[np.minimum(me, bi), np.maximum(me, bi)]
    st = st.replace(start_lon=st.lon,
                    bond_nstress=jnp.asarray(ns, jnp.float32))
    ts, td, js, jd = _evolve(cfg, st, **ekw)
    if regime == "outer_fracture":
        assert int(jd.broken_bonds) > 0
    if regime == "pair_list":
        assert int(jd.pair_overflow) == 0 and int(jd.skin_dropped) > 0
    assert_state(ts, js, 1e-4)


def test_tables_part1_matches_fused():
    """Part 1's cross-conglomerate group on the candidate tables (K7's
    plain version at M = 400) against the fused search (K2's plain
    version), both in the port: the refreshed collision sums within
    ``rtol 1e-5`` plus 1e-6 of scale (K7 and the fused group sum a row's
    pairs in different orders), and one outer step each within ``rtol
    1e-5`` plus 2e-5; then the tables run against JAX's."""
    cfg = jax_cfg()
    tcfg = port_cfg(cfg)
    grid, frc, st = world()
    ts = tstate(st)
    tgrid = ibp.grid_from_numpy(leaves(grid), device=CPU)
    nbr = tforces.build_neighbor_tables(ts, tgrid, tcfg, max_per_cell=16,
                                        ncells_radius=2)
    assert nbr.cand_idx.shape[1] == 400
    moved = ts.replace(uvel_old=ts.uvel_old * 0.5 + 0.01,
                       vvel_old=ts.vvel_old * -0.5)
    tab = tforces.make_ia_fn(ts, nbr, tcfg, mts_part=1,
                             return_refresh=True)(moved)(ts.uvel * 0.5,
                                                         ts.vvel * 0.5)
    from icebergs_tpu_torch.ops.fused_contact import make_ia_fn_fused_mts1
    fused, stats = make_ia_fn_fused_mts1(ts, tgrid, tcfg, block_n=16,
                                         window=512, fallback_cap=128)
    fus = fused(moved)(ts.uvel * 0.5, ts.vvel * 0.5)
    assert int(stats.n_fallback) > 0 and int(stats.overflow) == 0
    live = ts.alive.numpy()
    assert (tab.IA_x.numpy()[live] != 0).sum() > 0
    for name in tab._fields:
        close(getattr(tab, name).numpy()[live],
              getattr(fus, name).numpy()[live], name, 1e-5, 1e-6)
    ts1, td, js, jd = _evolve(cfg, st, neighbor_mode="tables")
    tf, tfd = tmts.evolve_icebergs_mts(
        ts, tgrid, ibp.forcing_from_numpy(leaves(frc), device=CPU), tcfg,
        neighbor_mode="fused", fused_kw=dict(block_n=16, window=512))
    assert td.p1_overflow is None and int(tfd.p1_overflow) == 0
    assert tfd.conv_iters == td.conv_iters
    assert int(tfd.broken_bonds) == int(td.broken_bonds)
    F, T = ibp.to_numpy(tf), ibp.to_numpy(ts1)
    for name in INTS:
        np.testing.assert_array_equal(F[name], T[name], err_msg=name)
    for name in FLOATS:
        close(F[name][live], T[name][live], name, 1e-5, 2e-5)
    assert_state(ts1, js, 2e-5)


@functools.lru_cache(maxsize=None)
def _kid_world(hexagonal=False):
    """``tests/test_mts_collision.py``'s input_MTS_KID.nml world (two
    bonded 2x2 conglomerates in a converging jet) with square elements,
    or with the namelist's own hexagonal ones, cut to 12 substeps of a
    600 s step."""
    from test_mts_collision import mts_kid_config
    cfg = mts_kid_config().replace(hexagonal_icebergs=hexagonal, dt=600.,
                                   mts_sub_steps=12)
    grid = ibt.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    frc = ibt.uniform_forcing(20, 20, sst=-2.0)
    xc = 1000. * np.arange(21)[:, None] * np.ones((1, 21))
    yc = 1000. * np.arange(21)[None, :] * np.ones((21, 1))
    vo = np.where((xc > 10e3) | (xc <= 0.) | (yc == 10e3), 0.,
                  np.where(yc > 10e3, -0.2, 0.2))
    frc = frc.replace(vo=jnp.asarray(vo, jnp.float32))
    side = 400.0
    lon, lat = [], []
    for (cx, cy) in ((5000., 9300.), (5000., 10700.)):
        for dx in (-side / 2, side / 2):
            for dy in (-side / 2, side / 2):
                lon.append(cx + dx)
                lat.append(cy + dy)
    n = len(lon)
    rng = np.random.RandomState(4)
    st = ibt.create_bergs(32, lon=lon, lat=lat,
                          uvel=rng.uniform(-0.05, 0.05, n),
                          vvel=np.where(np.arange(n) < 4, 0.1, -0.1),
                          mass=850. * 100 * side * side, thickness=100.,
                          width=side, length=side, mass_scaling=1.,
                          id_cnt=np.arange(n) + 1)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    st = jforces.initialize_bonds_host(
        st, cfg.replace(length_for_manually_initialize_bonds=side * 1.2))
    return cfg, grid, frc, st


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["explicit", "implicit"])
def test_mts_without_dem_matches_jax(explicit):
    """The input_MTS_KID.nml flag set (no DEM, contact_distance with its
    own contact spring, force convergence) for two outer steps: explicit
    inner substeps (``calculate_force`` bonds and same-conglomerate
    contacts through K7's plain version, explicit damping) and implicit
    ones iterated to convergence (one host read an iteration, counted
    in ``inner_conv_iters``).  Integers and iteration counts exact;
    floats within ``rtol 1e-5`` plus 1e-5 of scale."""
    _kid_steps(explicit, False)


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["explicit", "implicit"])
def test_mts_without_dem_hexagons_matches_jax(explicit):
    """The same two outer steps with input_MTS_KID.nml's hexagonal
    elements (``hexagonal_icebergs=.true.``: every contact at the
    hexagonal interaction radius sqrt(A / (2 sqrt 3))), at the same
    tolerances.  The Part-1 iteration counts are exact in float64 (x64
    on in JAX); in float32 within one: the namelist's tolerance, 1e-8,
    lies below float32's resolution, so the last iteration's norm is a
    matter of ulps (one outer step here takes 8 in JAX, 7 in the port,
    the states within 1.3e-7 of scale)."""
    from test_torch_hex_steps import _f64
    cfg, grid, frc, st = _kid_world(True)
    jax.config.update("jax_enable_x64", True)
    try:
        g64, f64, s64 = (type(x)(**leaves(x))
                         for x in (_f64(grid), _f64(frc), _f64(st)))
        cfg = cfg.replace(explicit_inner_mts=explicit)
        js = s64
        jits = []
        for _ in range(2):
            js, jd = eager(jmts.evolve_icebergs_mts, js, g64, f64, cfg)
            jits.append(int(jd.conv_iters))
    finally:
        jax.config.update("jax_enable_x64", False)
    ts = tstate(s64)
    assert ts.lon.dtype == torch.float64
    tgrid = ibp.grid_from_numpy(leaves(g64), device=CPU)
    tfrc = ibp.forcing_from_numpy(leaves(f64), device=CPU)
    for n in range(2):
        ts, td = tmts.evolve_icebergs_mts(ts, tgrid, tfrc, port_cfg(cfg))
        assert td.conv_iters == jits[n]
    _kid_steps(explicit, True, conv_slack=1)


def _kid_steps(explicit, hexagonal, conv_slack=0):
    cfg, grid, frc, st = _kid_world(hexagonal)
    assert cfg.hexagonal_icebergs == hexagonal
    cfg = cfg.replace(explicit_inner_mts=explicit)
    tcfg = port_cfg(cfg)
    ibp.check_ported(tcfg)
    tgrid = ibp.grid_from_numpy(leaves(grid), device=CPU)
    tfrc = ibp.forcing_from_numpy(leaves(frc), device=CPU)
    js, ts = st, tstate(st)
    iters = 0
    for _ in range(2):
        js, jd = eager(jmts.evolve_icebergs_mts, js, grid, frc, cfg)
        ts, td = tmts.evolve_icebergs_mts(ts, tgrid, tfrc, tcfg)
        assert abs(td.conv_iters - int(jd.conv_iters)) <= conv_slack
        iters += td.inner_conv_iters
    assert (iters > 12) == (not explicit)
    T = ibp.to_numpy(ts)
    assert np.abs(T["axn_fast"][T["alive"]]).max() > 0
    assert_state(ts, js, 1e-5, fields=FLOATS[:12] + ("xi", "yj"))


def test_make_step_tables_pair_cap_matches_jax():
    """Two coupling steps through ``make_multi_step`` with
    ``mts_neighbor_mode="tables"``, ``mts_pair_cap`` and the reference's
    substep defaults on both sides, the dynamics alone (the JAX step
    under ``jax.jit``, as it runs): ``contact_overflow`` carries
    ``pair_overflow`` (0, and the maximum the call returns); the state
    within the whole-step tolerance of ``tests/test_torch_mts.py``
    (XLA:CPU's multiply-adds in the interpolation and the pair terms,
    grown over 12 stiff substeps: worst read 2.1e-4 of scale,
    ``ayn_fast``)."""
    cfg = jax_cfg(**DEFAULTS)
    grid, frc, st = world()
    kw = dict(mts_neighbor_mode="tables", mts_pair_cap=8192,
              with_thermo=False, with_spread=False)
    jst, jov, _, _ = jax_multi(grid, cfg, 2, with_stats=True, **kw)(st, frc)
    multi = ibp.make_multi_step(
        ibp.grid_from_numpy(leaves(grid), device=CPU), port_cfg(cfg), 2,
        with_stats=True, **kw)
    tst, tov, _, _ = multi(tstate(st), ibp.forcing_from_numpy(leaves(frc),
                                                              device=CPU))
    assert int(tov) == int(jov) == 0
    d = multi.step_diags[0]
    assert int(d.contact_overflow) == 0 and int(d.skin_dropped) > 0
    assert d.p1_overflow is None and d.conv_iters >= 1
    assert_state(tst, jst, 2e-3, 1e-4)


def test_golden_mts_bonded_matches_jax():
    """``tests/test_golden_chksums.py``'s ``mts_dem_bonded`` scenario
    (10 MTS steps of 20 substeps with the reference's substep defaults:
    dense same-conglomerate contacts, no fracture) through the port.
    The golden checksum 2691562076 is the jitted JAX run's.  The port
    gives 2691562088, which is also what the same JAX scenario gives op
    by op (``jax.disable_jit``; 78 s on the CPU, too slow to run here):
    under ``jax.jit`` XLA:CPU contracts the table interpolation's
    multiply-adds (``uo`` 1 ulp off at the first step, ROADMAP.md Queue
    3), and the checksum hashes every bit.  So the port is held to
    2691562088 bit for bit, and to the jitted run with integers exact and
    floats within ``rtol 1e-5`` plus 1e-6 of scale (worst read: 1.4e-7,
    ``uvel``)."""
    from test_golden_chksums import GOLDEN
    import json
    js = scenario_mts_bonded()
    cs, n = jax.jit(__import__("icebergs_tpu").diag.berg_chksum)(js)
    with open(GOLDEN) as f:
        assert json.load(f)["mts_dem_bonded"] == {"chksum": int(cs),
                                                  "n": int(n)}
    cfg = ibt.IcebergsConfig(
        grid_is_latlon=False, Lx=-1., use_f_plane=True, lat_ref=0., dt=60.,
        Runge_not_Verlet=False, mts=True, mts_sub_steps=20,
        explicit_inner_mts=True, dem=True, dem_spring_coef=5.e6,
        dem_damping_coef=1.0, iceberg_bonds_on=True,
        interactive_icebergs_on=True, spring_coef=1.e-5,
        contact_spring_coef=1.e-7, contact_distance=1000., max_bonds=4,
        allow_bergs_to_roll=False, manually_initialize_bonds=True,
        manually_initialize_bonds_from_radii=True)
    tgrid = ibp.make_uniform_grid(16, 16, 0., 0., 2000., 2000.,
                                  grid_is_latlon=False, device=CPU)
    tfrc = ibp.uniform_forcing(16, 16, uo=0.1, sst=-2., device=CPU)
    side = 800.
    lon = [16000. - side / 2] * 2 + [16000. + side / 2] * 2
    lat = [16000. - side / 2, 16000. + side / 2] * 2
    ts = ibp.create_bergs(16, lon=lon, lat=lat, thickness=100., width=side,
                          length=side, mass=850. * 100 * side * side,
                          mass_scaling=1., id_cnt=np.arange(4) + 1,
                          device=CPU)
    i, j, xi, yj = ibp.pos_to_cell(tgrid, ts.lon, ts.lat, -1.)
    ts = tforces.initialize_bonds_host(ts.replace(ine=i, jne=j, xi=xi,
                                                  yj=yj), port_cfg(cfg))
    ts = ibp.make_multi_step(tgrid, port_cfg(cfg), 10,
                             with_thermo=False)(ts, tfrc)
    tcs, tn = berg_chksum(ts)
    assert int(tn) == int(n) == 4
    assert int(tcs) == 2691562088
    T, J = ibp.to_numpy(ts), leaves(js)
    for name in ("alive", "id_cnt", "ine", "jne", "bond_idx", "bond_broken",
                 "n_bonds"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    live = J["alive"]
    for name in ("lon", "lat", "uvel", "vvel", "axn_fast", "ayn_fast",
                 "bxn", "xi", "yj", "uo", "bond_length", "ang_vel", "rot"):
        close(T[name][live], J[name][live], name, 1e-5, 1e-6)

"""The port's MTS/DEM coupling step against the JAX package, module by
module and as a whole, on four bonded 6x6 conglomerates (3 km elements,
the iKID flag set of ``tools/bench_dem_1m.py`` with dt 120 s and 12
substeps) placed so that the Part-1 cross-conglomerate search engages:
one pair of conglomerates 2 km apart (edge elements with >= 3 partners
take the exact fallback) and two 3.5-3.8 km from their neighbour (one
partner each).  The substep loop runs in K4's plain version on the CPU
and in the Pallas kernel in interpret mode on the JAX side.

Integers, orders, bond tables and every counter (``p1_overflow``,
``contact_fallback``, ``broken_bonds``, ``conv_iters``) must match
exactly.  Float tolerances are stated per test with their reason.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.model import make_multi_step as jax_multi
from icebergs_tpu.mts import evolve_icebergs_mts as jax_evolve_mts
from icebergs_tpu.ops import dem_vmem as jvmem
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.ops import pallas_interp as jinterp
from icebergs_tpu.ops import spread as jspread
from icebergs_tpu.ops import thermo as jthermo
from icebergs_tpu.ops.fused_contact import make_ia_fn_fused_mts1 as jax_mts1
from icebergs_tpu.ops.pallas_prepass import contact_extract_sorted_g

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import mts as tmts
from icebergs_tpu_torch.ops import extract, interp_table, spread, thermo
from icebergs_tpu_torch.ops.dem_substeps import (analyze_bond_deltas,
                                                 pack_conglomerates_blocked)
from icebergs_tpu_torch.ops.fused_contact import (contact_features,
                                                  make_ia_fn_fused_mts1)
from icebergs_tpu_torch.ops.sorted import sort_state_by_cell

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX = 32
DXY, R = 7000.0, 1500.0
SIDE = 6
BLOCK = 128
K2_BN, K2_WINDOW = 16, 512


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


_BASE = dict(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=-55.0,
        dt=120.0, Runge_not_Verlet=False, mts=True, mts_sub_steps=12,
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
        fused_fallback_cap=256)


def _cfg(**kw):
    return ibt.IcebergsConfig(**{**_BASE, **kw}).normalized(warn=False)


@functools.lru_cache(maxsize=None)
def _world():
    """JAX cfg/grid/forcing and the conglomerate-blocked state (bonded
    from one prototype, as bench_dem_1m builds its world), plus the
    port's copies."""
    cfg = _cfg()
    per = SIDE * SIDE
    px, py = np.meshgrid(np.arange(SIDE) * 2 * R, np.arange(SIDE) * 2 * R,
                         indexing="ij")
    px, py = px.ravel(), py.ravel()
    proto = ibt.create_bergs(64, lon=px, lat=py, mass=1., thickness=200.,
                             width=2 * R, length=2 * R, mass_scaling=1.,
                             max_bonds=6)
    proto = jforces.initialize_bonds_host(proto, cfg)
    pbond = np.asarray(proto.bond_idx)[:per]
    pblen = np.asarray(proto.bond_length)[:per]

    ext = 2 * R * (SIDE - 1)              # 15 km lattice extent
    x0 = 2 * DXY
    origins = [(x0, x0), (x0 + ext + 2e3, x0),            # 2 km gap
               (x0 + ext + 2e3, x0 + ext + 3.5e3),         # 3.5 km above
               (x0 + 2 * ext + 5.8e3, x0)]                 # 3.8 km right
    rng = np.random.RandomState(7)
    nu = len(origins)
    n = nu * per
    lon = np.concatenate([px + ox for ox, _ in origins])
    lat = np.concatenate([py + oy for _, oy in origins])
    lon = lon + rng.uniform(-40., 40., n)
    lat = lat + rng.uniform(-40., 40., n)
    depth = 150. + 60. * np.sin(np.arange(NX)[:, None] / 3.) \
        * np.cos(np.arange(NX)[None, :] / 4.)
    grid = ibt.make_uniform_grid(NX, NX, 0., 0., DXY, DXY,
                                 grid_is_latlon=False, ocean_depth=depth)
    frc = ibt.uniform_forcing(NX, NX, uo=0.25, vo=0.05, ua=5.0, sst=-2.0,
                              sss=34.0)
    cap = 256
    st = ibt.create_bergs(cap, lon=lon, lat=lat,
                          uvel=rng.uniform(-0.1, 0.1, n),
                          vvel=rng.uniform(-0.1, 0.1, n),
                          mass=850. * 200. * (2 * R) ** 2, thickness=200.,
                          width=2 * R, length=2 * R, mass_scaling=1.0,
                          id_cnt=np.arange(n) + 1, max_bonds=6)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    bond_idx = np.full((cap, 6), -1, np.int32)
    bond_len = np.zeros((cap, 6), np.float32)
    cong = np.zeros(cap, np.int32)
    offs = (np.arange(nu) * per)[:, None, None]
    bond_idx[:n] = np.where(pbond[None] >= 0, pbond[None] + offs,
                            -1).reshape(n, 6)
    bond_len[:n] = np.broadcast_to(pblen[None], (nu, per, 6)).reshape(n, 6)
    cong[:n] = np.repeat(np.arange(nu) + 1, per)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj,
                    bond_idx=jnp.asarray(bond_idx),
                    bond_length=jnp.asarray(bond_len),
                    conglom_id=jnp.asarray(cong))
    st = jforces.count_bonds(st)
    st = jvmem.pack_conglomerates_blocked(st, BLOCK)
    port = (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU))
    return cfg, grid, frc, st, port


def _tstate(js):
    return ibp.state_from_numpy(_leaves(js), device=CPU)


def _close(t, j, rtol, atol_scale, name=""):
    j = np.asarray(j, np.float64)
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, rtol=rtol,
                               atol=atol_scale * scale, err_msg=name)


@pytest.mark.parametrize("extra", [
    {},
    {"dt": 600.0, "mts_sub_steps": 60},          # tools/bench_dem_1m.py
    {"mts_sub_steps": -1, "hexagonal_icebergs": True, "max_bonds": 8},
])
def test_config_normalized_matches_jax(extra):
    """``normalized`` and the derived substep count / bond shape agree
    with the JAX package's on the DEM config."""
    kw = {**_BASE, **extra}
    j = ibt.IcebergsConfig(**kw).normalized(warn=False)
    t = ibp.IcebergsConfig(**kw).normalized(warn=False)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert {k: td[k] for k in jd} == jd
    assert t.n_sub_steps == j.n_sub_steps > 0
    assert t.n_max_bonds_shape == j.n_max_bonds_shape


@pytest.mark.parametrize("kw,item", [
    (dict(dem=False), 16),
    (dict(dem=False, explicit_inner_mts=False), 16),
    (dict(use_broken_bonds_for_substep_contact=False), 16),
    (dict(break_bonds_on_sub_steps=False), 16),
    (dict(fracture_criterion="none", break_bonds_on_sub_steps=False), 16),
    (dict(dem_beam_test=2), 16),
    (dict(grid_is_latlon=True), 11),
])
def test_unported_mts_settings_raise(kw, item):
    """Every MTS setting that was ROADMAP.md item 16's or item 11's is
    served: it passes ``check_ported`` and one outer step runs on the CPU
    through the scan substeps (Part 1 on the candidate tables), every
    live float finite.  The lat-lon case (item 11) places the world at
    60 S in degrees (metres through the metric factors at 60 S; the grid
    keeps its cell sizes in metres), so the outer step runs the lat-lon
    metric and Coriolis by latitude on every path."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    ibp.check_ported(tcfg)
    tcfg = tcfg.replace(**kw)
    ibp.check_ported(tcfg)
    ts0 = _tstate(st)
    if item == 11:
        tcfg = tcfg.replace(Lx=360., use_f_plane=False)
        ky = 180. / (3.141592653589793 * 6360000.)
        kx = 2. * ky                              # 1 / cos(60 degrees)
        tgrid = tgrid.replace(lon0=tgrid.lon0 * kx, dlon=tgrid.dlon * kx,
                              lonc=tgrid.lonc * kx,
                              lat0=tgrid.lat0 * ky - 60.,
                              dlat=tgrid.dlat * ky,
                              latc=tgrid.latc * ky - 60.)
        ts0 = ts0.replace(lon=ts0.lon * kx, lon_old=ts0.lon_old * kx,
                          lat=ts0.lat * ky - 60.,
                          lat_old=ts0.lat_old * ky - 60.)
    ts, d = tmts.evolve_icebergs_mts(ts0, tgrid, tfrc, tcfg)
    assert d.conv_iters >= 1 and int(d.broken_bonds) >= 0
    live = ts.alive
    for name in ("lon", "lat", "uvel", "vvel", "axn_fast", "ang_vel"):
        assert bool(torch.isfinite(getattr(ts, name)[live]).all()), name
    assert int(live.sum()) == int(np.asarray(st.alive).sum())


def test_world_layout():
    """The port packs the JAX world's unbonded-order state into the same
    blocked layout, with the same delta set."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, BLOCK)
    assert st.capacity == 2 * BLOCK and deltas
    assert analyze_bond_deltas(_tstate(st).bond_idx, BLOCK) == deltas
    # already blocked: packing again is the identity
    again = ibp.to_numpy(pack_conglomerates_blocked(_tstate(st), BLOCK))
    for name, v in _leaves(st).items():
        np.testing.assert_array_equal(again[name], v, err_msg=name)


@functools.lru_cache(maxsize=None)
def _sorted():
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    ts, cs = sort_state_by_cell(_tstate(st), tgrid)
    PT, key_s = contact_features(ts, tgrid, tcfg, exclude_same_group=True)
    return ts, cs, PT, key_s


def test_extract_grouped_matches_jax():
    """K2's plain version with the conglomerate filter at radius 2 (5
    strips), window 512, against ``contact_extract_sorted_g`` in
    interpret mode: bad flags exact, counts, min/max slots and partner
    features bit for bit on good blocks."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    ts, cs, PT, key_s = _sorted()
    out, bad = extract.extract_sorted(PT, key_s, cs, tgrid, tcfg,
                                      block_n=K2_BN, window=K2_WINDOW,
                                      radius=2, exclude_same_group=True)
    jout, jbad = jax.jit(functools.partial(
        contact_extract_sorted_g, grid=grid, cfg=cfg, block_n=K2_BN,
        window=K2_WINDOW, radius=2, exclude_same_group=True,
        interpret=True))(jnp.asarray(PT.numpy()), jnp.asarray(key_s.numpy()),
                         jnp.asarray(cs.numpy()))
    out, bad = out.numpy(), bad.numpy()
    jout, jbad = np.asarray(jout), np.asarray(jbad)
    np.testing.assert_array_equal(bad, jbad)
    good = ~bad & ts.alive.numpy()
    np.testing.assert_array_equal(out[:, good], jout[:, good])
    cnt = out[extract.EX_CNT][good]
    assert (cnt >= 3).sum() > 0 and (cnt == 1).sum() > 0
    # without the filter every row engages its own conglomerate
    own = extract.extract_sorted(PT, key_s, cs, tgrid, tcfg, block_n=K2_BN,
                                 window=K2_WINDOW, radius=2)[0].numpy()
    assert (own[extract.EX_CNT][good] > cnt).all()


def _changed(st):
    """The state with the *_old velocities moved (a convergence
    iterate)."""
    return st.replace(uvel_old=st.uvel_old * 0.5 + 0.01,
                      vvel_old=st.vvel_old * -0.5)


@functools.lru_cache(maxsize=None)
def _jax_mts1():
    cfg, grid, frc, st, _ = _world()

    @jax.jit
    def run(s):
        refresh, stats = jax_mts1(s, grid, cfg, block_n=K2_BN,
                                  window=K2_WINDOW, fallback_cap=128,
                                  interpret=True)
        return refresh(_changed(s))(s.uvel * 0.5, s.vvel * 0.5), stats

    return run(st)


def test_mts1_closure_matches_jax():
    """The Part-1 collision group: search (K2 on a sorted view, K1
    transports), normal pairs on origin-frame partner slots, the exact
    strip fallback, and one ``refresh`` with moved velocities.  Stats
    exact; IA within rtol 1e-5 and 1e-6 of scale (XLA:CPU fuses
    multiply-adds in the pair terms)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    jia, jstats = _jax_mts1()
    ts = _tstate(st)
    refresh, stats = make_ia_fn_fused_mts1(ts, tgrid, tcfg, block_n=K2_BN,
                                           window=K2_WINDOW,
                                           fallback_cap=128)
    ia = refresh(_changed(ts))(ts.uvel * 0.5, ts.vvel * 0.5)
    assert int(stats.overflow) == int(jstats.overflow) == 0
    assert int(stats.n_fallback) == int(jstats.n_fallback) > 0
    live = np.asarray(st.alive)
    engaged = np.asarray(jia.IA_x)[live] != 0.
    assert engaged.sum() > 0
    for name in ia._fields:
        _close(getattr(ia, name).numpy()[live],
               np.asarray(getattr(jia, name))[live], 1e-5, 1e-6, name)


@functools.lru_cache(maxsize=None)
def _jax_interp():
    cfg, grid, frc, st, _ = _world()
    return jax.jit(lambda s: jinterp.interp_to_bergs_table(
        s, grid, frc, cfg)[0])(st)


def test_interp_quad_od_matches_jax():
    """The 89-row slot table (64 + 25 quad-od rows) bit for bit; the
    per-berg environment and the quadratic ocean depth within rtol 1e-6
    and 1e-6 of scale (XLA:CPU fuses the stencil's multiply-adds)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    tbl = interp_table.interp_cell_table(tgrid, tfrc, tcfg, with_quad_od=True)
    jtbl = jax.jit(lambda: jinterp.interp_cell_table(
        grid, frc, cfg, with_quad_od=True))()
    assert tbl.shape[0] == 89
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jtbl))
    js = _jax_interp()
    t2, _ = interp_table.interp_to_bergs_table(_tstate(st), tgrid, tfrc,
                                               tcfg)
    live = np.asarray(st.alive)
    od = np.asarray(js.od)[live]
    assert np.ptp(od) > 10.
    for name in ("uo", "vo", "ua", "va", "ssh_x", "ssh_y", "sst", "od"):
        _close(getattr(t2, name).numpy()[live],
               np.asarray(getattr(js, name))[live], 1e-6, 1e-6, name)


@pytest.mark.parametrize("mixed", [False, True])
def test_bonded_thermo_matches_jax(mixed):
    """Thermodynamics with bonds on: ``N_bonds`` from the state (mixed
    melting weights basal against side melt by it).  Deferred melt
    columns and the state within rtol 1e-5 and 2e-5 of scale (pow / exp
    round differently in XLA:CPU and torch)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    cfg = cfg.replace(use_mixed_melting=mixed)
    tcfg = tcfg.replace(use_mixed_melting=mixed)
    js = _jax_interp()
    nb = np.asarray(js.n_bonds).copy()
    nb[::3] = np.minimum(nb[::3], 2.)          # some elements half bonded
    js = js.replace(n_bonds=jnp.asarray(nb))
    jst, jm = jthermo.thermodynamics(js, grid, frc, cfg,
                                     defer_cell_cols=True)
    tst, tm = thermo.thermodynamics(_tstate(js), tgrid, tfrc, tcfg)
    live = np.asarray(js.alive)
    assert len(tm.deferred_cols) == 14
    for k, (t, j) in enumerate(zip(tm.deferred_cols, jm.deferred_cols)):
        _close(t.numpy()[live], np.asarray(j)[live], 1e-5, 2e-5, f"col{k}")
    for name in ("mass", "thickness", "width", "length", "mass_of_bits"):
        _close(getattr(tst, name).numpy()[live],
               np.asarray(getattr(jst, name))[live], 1e-5, 2e-5, name)
    assert int(tm.nbergs_melted) == int(jm.nbergs_melted)


def test_spread_unsorted_matches_jax():
    """Spreading on the unsorted slab (one (cell, id) payload order, the
    rows moved by K1, K3 over them) with the 14 deferred melt columns,
    against ``create_gridded_icebergs_fields(key_alive=...)``: every
    gridded field within 1e-6 of its scale (K3 adds a cell's rows in
    sequence; XLA's selection matmul in another order)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    js = _jax_interp()
    jst, jm = jthermo.thermodynamics(js, grid, frc, cfg,
                                     defer_cell_cols=True)
    jsp, jx = jspread.create_gridded_icebergs_fields(
        jst, grid, frc, cfg, extra_cell_cols=jm.deferred_cols,
        key_alive=js.alive)
    tst, tm = thermo.thermodynamics(_tstate(js), tgrid, tfrc, tcfg)
    tsp, tx = spread.create_gridded_icebergs_fields(
        tst, tgrid, tfrc, tcfg, key_alive=torch.as_tensor(np.array(js.alive)),
        cell_starts=None, extra_cell_cols=tm.deferred_cols)
    assert len(tx) == len(jx) == 14
    for k, (t, j) in enumerate(zip(tx, jx)):
        _close(t.numpy(), j, 0., 1e-6, f"melt field {k}")
    assert np.abs(np.asarray(jsp.mass_on_ocean)).max() > 0
    for name in ("spread_mass", "spread_area", "spread_uvel", "spread_vvel",
                 "ustar_iceberg", "mass_on_ocean", "u_iceberg", "v_iceberg"):
        _close(getattr(tsp, name).numpy(), getattr(jsp, name), 0., 1e-6,
               name)


# floats after whole MTS steps: the substep loop's bond ulps (see
# tests/test_torch_dem.py) reach every kinematic field through 12 stiff
# substeps
STEP_RTOL, STEP_ATOL_SCALE = 1e-4, 2e-3
_STEP_FIELDS = ("lon", "lat", "uvel", "vvel", "uvel_old", "vvel_old",
                "axn", "ayn", "bxn", "byn", "axn_fast", "ayn_fast",
                "ang_vel", "rot", "xi", "yj", "od", "bond_length",
                "bond_nstress")


def _assert_state(tst, jst):
    T, J = ibp.to_numpy(tst), _leaves(jst)
    for name in ("alive", "id_cnt", "ine", "jne", "bond_idx", "bond_broken",
                 "n_bonds", "conglom_id"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    live = J["alive"]
    for name in _STEP_FIELDS:
        _close(T[name][live], J[name][live], STEP_RTOL, STEP_ATOL_SCALE,
               name)


@pytest.mark.parametrize("converge", [True, False])
def test_evolve_mts_matches_jax(converge):
    """One MTS cycle: Part 1 with or without force convergence, Part 2,
    K4, the walk.  ``conv_iters``, ``broken_bonds`` and ``p1_overflow``
    exact."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    cfg = cfg.replace(force_convergence=converge)
    tcfg = tcfg.replace(force_convergence=converge)
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, BLOCK)
    js = _jax_interp()
    jst, jd = jax.jit(functools.partial(
        jax_evolve_mts, grid=grid, frc=frc, cfg=cfg, neighbor_mode="fused",
        substep_kernel="vmem", vmem_deltas=deltas, vmem_block_n=BLOCK,
        vmem_interpret=True))(js)
    tst, td = tmts.evolve_icebergs_mts(_tstate(js), tgrid, tfrc, tcfg,
                                       neighbor_mode="fused",
                                       substep_kernel="vmem",
                                       vmem_deltas=deltas,
                                       vmem_block_n=BLOCK)
    assert td.conv_iters == int(jd.conv_iters) >= (2 if converge else 0)
    assert int(td.broken_bonds) == int(jd.broken_bonds)
    assert int(td.p1_overflow) == int(jd.p1_overflow) == 0
    assert int(td.p1_fallback) > 0
    _assert_state(tst, jst)


def test_slice_matches_jax():
    """Two MTS coupling steps through ``make_multi_step`` on both sides
    (table interpolation with quad od, the MTS cycle, bonded
    thermodynamics, unsorted spreading with the 14 melt fields).
    Overflow and fallback counters exact, the Part-1 fallback of step 1
    equal to the JAX group's; state per slot within the step tolerance,
    the coupler accumulator within 2e-3 of its scale."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, BLOCK)
    kw = dict(mts_substep_kernel="vmem", mts_vmem_deltas=deltas,
              mts_vmem_block_n=BLOCK)
    jst, jov, jfb, jacc = jax_multi(grid, cfg, 2, with_stats=True,
                                    mts_vmem_interpret=True, **kw)(st, frc)
    multi = ibp.make_multi_step(tgrid, tcfg, 2, with_stats=True, **kw)
    tst, tov, tfb, tacc = multi(_tstate(st), tfrc)
    assert int(tov) == int(jov) == 0
    assert int(tfb) == int(jfb)
    d1 = multi.step_diags[0]
    jstats = jax.jit(lambda s: jax_mts1(s, grid, cfg, fallback_cap=256,
                                        interpret=True)[1])(st)
    assert int(d1.p1_fallback) == int(jstats.n_fallback) > 0
    assert [d.conv_iters for d in multi.step_diags] >= [1, 1]
    _assert_state(tst, jst)
    _close(tacc.numpy(), jacc, 0., STEP_ATOL_SCALE, "coupler accumulator")


def test_slice_a68_matches_jax():
    """One MTS coupling step with ``A68_test``: the step reads the
    environment through ``interp_flds`` with the A68 test's analytic
    depth (0 east of and above the displaced origin, 1000 m elsewhere),
    as the JAX ``make_step`` does, instead of the table; tolerances of
    ``test_slice_matches_jax``."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    kw = dict(A68_test=True, A68_xdisp=float(np.median(np.asarray(
        st.lon)[np.asarray(st.alive)])) - 360., A68_ydisp=0.)
    cfg, tcfg = cfg.replace(**kw), tcfg.replace(**kw)
    ibp.check_ported(tcfg)
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, BLOCK)
    mkw = dict(mts_substep_kernel="vmem", mts_vmem_deltas=deltas,
               mts_vmem_block_n=BLOCK)
    jst, jov, jfb, jacc = jax_multi(grid, cfg, 1, with_stats=True,
                                    mts_vmem_interpret=True, **mkw)(st, frc)
    multi = ibp.make_multi_step(tgrid, tcfg, 1, with_stats=True, **mkw)
    tst, tov, tfb, tacc = multi(_tstate(st), tfrc)
    assert int(tov) == int(jov) == 0
    assert int(tfb) == int(jfb)
    od = tst.od.numpy()[tst.alive.numpy()]
    assert (od == 0.).any() and (od == 1000.).any()
    _assert_state(tst, jst)
    _close(tacc.numpy(), jacc, 0., STEP_ATOL_SCALE, "coupler accumulator")

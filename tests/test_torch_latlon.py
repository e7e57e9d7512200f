"""The lat-lon branches of the contact kernels K2 and K5, of the DEM
substep kernel K4 and of the step, against the JAX package.

The world is a regular lat-lon grid near 60 S (cells of 0.02 x 0.01
degrees, ~1.05 x 1.11 km) with bergs of ~150 m, some in knots of three
or more partners; positions are in degrees, and every pair is measured
in metres through the metric factors at its mean latitude.

- K2's plain version (the fused3 search, the grouped MTS Part-1 search
  and the pair epilogue) against ``contact_extract_sorted_g(interpret=
  True)``, and K5's against ``contact_prepass_sorted(interpret=True)``:
  bad flags, counts and partner slots exact, features bit for bit.
- K4's plain version against ``part3_substeps_vmem(interpret=True)`` on
  a lat-lon ``tests/test_dem_vmem.py``-style world, at rest and jittered.
- Coriolis by latitude in ``accel`` and ``thermo``, and
  ``_advance_position`` above 89 degrees (the polar tangent plane).
- Whole steps: the persistent fused3 lane and per-step ``fused`` and
  ``buckets`` over 4 steps, ``IcebergsModel.run`` on the lat-lon worlds
  of ``tests/test_api.py`` and ``tests/test_calving.py``, and one MTS
  outer step on ``tools/run_a68.py``'s flag set, regular and
  curvilinear.

Tolerances are stated per test.  XLA:CPU contracts multiply-adds, and
its float32 ``cos`` / ``sin`` and torch's CPU ones need not round alike
(ROADMAP.md Queue 3); integers and counters are exact throughout.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import pallas_prepass as jprep
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import extract
from icebergs_tpu_torch.ops import prepass as tprep
from icebergs_tpu_torch.ops.fused_contact import contact_features

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX, NY, CAP = 64, 16, 2048
LON0, LAT0, DLON, DLAT = 20., -62., 0.02, 0.01


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


def _port(cfg, grid, st=None):
    out = (ibp.config_from_dict(dataclasses.asdict(cfg)),
           ibp.grid_from_numpy(_leaves(grid), device=CPU))
    if st is not None:
        out = out + (ibp.state_from_numpy(_leaves(st), device=CPU),)
    return out


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = ibt.IcebergsConfig(grid_is_latlon=True, Lx=360., use_f_plane=False,
                             dt=600., Runge_not_Verlet=False,
                             interactive_icebergs_on=True)
    grid = ibt.make_uniform_grid(NX, NY, LON0, LAT0, DLON, DLAT,
                                 grid_is_latlon=True)
    return cfg, grid


@functools.lru_cache(maxsize=None)
def _world(seed=3):
    """A cell-sorted JAX state: 1900 bergs, 20 knots of 6 within ~100 m,
    conglomerate ids shared by each knot."""
    cfg, grid = _setup()
    rng = np.random.RandomState(seed)
    n = 1900
    lon = rng.uniform(LON0 + 0.04, LON0 + NX * DLON - 0.04, n)
    lat = rng.uniform(LAT0 + 0.02, LAT0 + NY * DLAT - 0.02, n)
    cong = np.arange(n) + 1
    for k in range(20):
        c = rng.uniform([LON0 + 0.1, LAT0 + 0.04],
                        [LON0 + NX * DLON - 0.1, LAT0 + NY * DLAT - 0.04])
        lon[6 * k:6 * k + 6] = c[0] + rng.uniform(-0.002, 0.002, 6)
        lat[6 * k:6 * k + 6] = c[1] + rng.uniform(-0.001, 0.001, 6)
        cong[6 * k:6 * k + 6] = cong[6 * k]
    st = ibt.create_bergs(CAP, lon=lon, lat=lat,
                          uvel=rng.uniform(-.3, .3, n),
                          vvel=rng.uniform(-.3, .3, n),
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=rng.uniform(120., 180., n),
                          mass_scaling=1., id_cnt=np.arange(n) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, 360.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, lon_old=st.lon,
                    lat_old=st.lat,
                    conglom_id=jnp.asarray(np.r_[cong, np.zeros(CAP - n)],
                                           st.conglom_id.dtype))
    return jax_sort(st, grid)


# (block_n, window, radius, exclude_same_group, epilogue)
K2_CASES = {"fused3": (128, 160, 1, False, False),
            "grouped": (64, 288, 2, True, False),
            "epilogue": (128, 160, 1, False, True)}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_latlon_plain_matches_jax(case):
    """K2's lat-lon branch: bad flags exact, and on good blocks every row
    bit for bit (the epilogue's P11-P22 and spring sums within rtol 1e-5
    and 1e-6 of scale: in interpret mode XLA:CPU fuses their
    ``rx*rx + ry*ry`` into one FMA, ROADMAP.md Queue 3)."""
    bn, window, radius, group, epi = K2_CASES[case]
    cfg, grid = _setup()
    js, jcs = _world()
    tcfg, tgrid, tst = _port(cfg, grid, js)
    PT, key_s = contact_features(tst, tgrid, tcfg, group)
    cs = torch.as_tensor(np.array(jcs))
    out, bad = extract.extract_sorted(PT, key_s, cs, tgrid, tcfg,
                                      block_n=bn, window=window,
                                      radius=radius,
                                      exclude_same_group=group,
                                      epilogue=epi)
    jout, jbad = jax.jit(functools.partial(
        jprep.contact_extract_sorted_g, grid=grid, cfg=cfg, block_n=bn,
        window=window, interpret=True, radius=radius,
        exclude_same_group=group, epilogue=epi))(
        jnp.asarray(PT.numpy()), jnp.asarray(key_s.numpy()),
        jnp.asarray(np.asarray(jcs)))
    jout, jbad = np.asarray(jout), np.asarray(jbad)
    out, bad = out.numpy(), bad.numpy()
    np.testing.assert_array_equal(bad, jbad)
    good = ~bad
    live = good & np.asarray(js.alive)
    cnt = out[extract.EX_CNT][live]
    assert (cnt >= 3).sum() >= (0 if group else 60) and (cnt == 1).sum() > 0
    if not epi:
        np.testing.assert_array_equal(out[:, good], jout[:, good])
        return
    fused_rows = [extract.EX_IAX, extract.EX_IAY] + [
        b + k for b in (extract.EX_F1, extract.EX_F2) for k in (2, 3, 4)]
    for r in range(extract.EX_NOUT):
        t, j = out[r, good], jout[r, good]
        if r in fused_rows:
            np.testing.assert_allclose(t, j, rtol=1e-5,
                                       atol=1e-6 * np.abs(j).max(),
                                       err_msg=f"row {r}")
        else:
            np.testing.assert_array_equal(t, j, err_msg=f"row {r}")


@pytest.mark.parametrize("group", [False, True], ids=["fused", "grouped"])
def test_k5_latlon_plain_matches_jax(group):
    """K5's lat-lon branch: counts, partner slots and bad flags exact."""
    cfg, grid = _setup()
    js, jcs = _world()
    tcfg, tgrid, tst = _port(cfg, grid, js)
    kw = dict(block_n=128, window=160, radius=2 if group else 1,
              exclude_same_group=group)
    P, key = tprep.prepass_features(tst, tgrid, tcfg, group)
    cnt, pmin, pmax, bad = tprep.contact_prepass_sorted(
        P, key, torch.as_tensor(np.array(jcs)), tgrid, tcfg, **kw)
    jcnt, jpmin, jpmax, jbad = jprep.contact_prepass_sorted(
        None, jcs, grid, cfg, interpret=True, P=jnp.asarray(P.numpy()),
        key=jnp.asarray(key.numpy()), **kw)
    for name, t, j in (("cnt", cnt, jcnt), ("pmin", pmin, jpmin),
                       ("pmax", pmax, jpmax), ("bad_block", bad, jbad)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    live = np.asarray(js.alive) & ~bad.numpy()
    assert (cnt.numpy()[live] >= 3).sum() >= (0 if group else 60)
    assert (cnt.numpy()[live] == 1).sum() > 0


# ---------------------------------------------------------------------------
# K4 on a lat-lon grid
# ---------------------------------------------------------------------------

LAT_DEM = -60.


def _to_degrees(x, y, lon0=40., lat0=LAT_DEM):
    """Metres east / north of (lon0, lat0) to degrees, through the metric
    factors at each point's latitude (float64)."""
    k = np.pi / 180. * 6360000.
    lat = lat0 + y / k
    return lon0 + x / (k * np.cos(np.radians(lat))), lat


@functools.lru_cache(maxsize=None)
def _dem_world(jitter):
    """``tests/test_torch_dem.py``'s six 5x5 conglomerates at 3 km
    spacing, placed near 60 S in degrees and bonded on the lat-lon grid
    by the JAX package (one bond pair broken), packed in 128-slot
    blocks."""
    from icebergs_tpu.ops import dem_vmem as jvmem
    from icebergs_tpu.ops import forces as jforces
    from test_torch_dem import _cfg, _unbonded
    cfg = _cfg(grid_is_latlon=True, Lx=360., use_f_plane=False)
    _, st = _unbonded((5, 5, 5, 5, 5, 5), jitter, 3, 256)
    lon, lat = _to_degrees(np.asarray(st.lon, np.float64),
                           np.asarray(st.lat, np.float64))
    f32 = st.lon.dtype
    st = st.replace(lon=jnp.asarray(lon, f32), lat=jnp.asarray(lat, f32),
                    lon_old=jnp.asarray(lon, f32),
                    lat_old=jnp.asarray(lat, f32))
    st = jforces.initialize_bonds_host(st, cfg)
    bb = np.asarray(st.bond_broken).copy()
    bi = np.asarray(st.bond_idx)
    p = bi[0, 0]
    bb[0, 0] = 1
    bb[p, bi[p] == 0] = 1
    st = jforces.count_bonds(st.replace(bond_broken=jnp.asarray(bb)))
    st = jvmem.pack_conglomerates_blocked(st, 128)
    return st.replace(axn_fast=st.uvel * 1e-3, ayn_fast=st.vvel * -1e-3,
                      ang_vel=st.uvel * 1e-5)


@pytest.mark.parametrize("jitter,flags", [
    (40.0, {}),
    (2.0, {"short_step_mts_grounding": True, "use_grounding_torque": True,
           "frac_thres_n": 1.8e5}),
], ids=["fracturing", "elastic"])
def test_k4_latlon_plain_matches_jax(jitter, flags):
    """K4's lat-lon branch (drift in degrees, bond and contact metric at
    the pair's mean latitude) against ``part3_substeps_vmem(interpret=
    True)``: integers exact, floats within the 2e-3 of scale that
    ``tests/test_torch_dem.py`` states for the Cartesian world (XLA:CPU
    contracts the bond length's multiply-add)."""
    from icebergs_tpu.ops import dem_vmem as jvmem
    from icebergs_tpu_torch.ops import dem_substeps as tdem
    from test_torch_dem import _CHECK, TOL, _cfg
    cfg = _cfg(grid_is_latlon=True, Lx=360., use_f_plane=False, **flags)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    st = _dem_world(jitter)
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, 128)
    assert st.capacity == 256 and deltas
    assert tdem.instantiation(tcfg, st.max_bonds) == (
        "generic" if flags else "dem_ll")
    jst, jnb = jax.jit(lambda s: jvmem.part3_substeps_vmem(
        s, cfg, deltas, block_n=128, interpret=True))(st)
    tst, tnb = tdem.part3_substeps_vmem(
        ibp.state_from_numpy(_leaves(st), device=CPU), tcfg, deltas,
        block_n=128)
    J, T = _leaves(jst), ibp.to_numpy(tst)
    assert int(tnb) == int(jnb)
    if not flags:
        assert int(jnb) > 10
    for name in ("bond_broken", "n_bonds", "alive", "bond_idx"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    moved = np.abs(T["lon"] - _leaves(st)["lon"]).max()
    assert 0. < moved < 1e-2          # degrees
    for name in _CHECK:
        a, b = T[name].astype(np.float64), J[name].astype(np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        err = np.abs(a - b).max() / scale
        assert err <= TOL, (name, err)


# ---------------------------------------------------------------------------
# Coriolis by latitude, the polar tangent plane
# ---------------------------------------------------------------------------

RTOL, ATOL_SCALE = 1e-5, 2e-5
LATS = np.r_[np.linspace(-89.9, 89.9, 41), -60.25, 45.5]


def _close(t, j, name, rtol=RTOL, atol_scale=ATOL_SCALE):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = max(float(np.abs(j).max()), 1e-30) if j.size else 1.
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_scale * scale,
                               err_msg=name)


def test_metric_and_coriolis_by_latitude():
    """The metric factors and the Coriolis parameter at latitudes from
    -89.9 to 89.9: the JAX expressions on the same float32 latitudes
    (``cos`` / ``sin`` within 2 ulp of XLA:CPU's)."""
    from icebergs_tpu import grid as jgrid
    from icebergs_tpu_torch import grid as tgrid
    from icebergs_tpu_torch.ops.accel import coriolis
    lat = np.float32(LATS)
    for fn in ("convert_from_grid_to_meters", "convert_from_meters_to_grid"):
        j = getattr(jgrid, fn)(jnp.asarray(lat), True, 6360000.)
        t = getattr(tgrid, fn)(torch.as_tensor(lat), True, 6360000.)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                       atol=0, err_msg=fn)
    cfg = ibp.IcebergsConfig(grid_is_latlon=True, use_f_plane=False)
    f = coriolis(cfg, torch.as_tensor(lat)).numpy()
    assert f[0] < 0 < f[-3]
    # the JAX package's own accel on bergs moving through still water:
    # water drag and Coriolis, whose sign and size follow latitude
    from icebergs_tpu.ops import accel as jaccel
    from icebergs_tpu.ops.interp import Env as JEnv
    from icebergs_tpu_torch.ops import accel as taccel
    from icebergs_tpu_torch.ops.interp import Env as TEnv
    rng = np.random.RandomState(3)
    n = lat.size
    zero = np.zeros(n, np.float32)
    env = dict(uo=zero, vo=zero, ui=zero, vi=zero, ua=zero, va=zero,
               ssh_x=zero, ssh_y=zero, sst=zero, sss=zero + 34., cn=zero,
               hi=zero, od=zero + 4000.)
    kw = dict(lat=lat, mass=zero + 850. * 200. * 2e3 * 3e3,
              thickness=zero + 200., width=zero + 2e3, length=zero + 3e3,
              n_bonds=np.zeros(n, np.int32),
              uvel=np.float32(rng.uniform(-.5, .5, n)),
              vvel=np.float32(rng.uniform(-.5, .5, n)),
              axn_in=np.float32(rng.uniform(-1e-5, 1e-5, n)),
              ayn_in=np.float32(rng.uniform(-1e-5, 1e-5, n)),
              loc_dx=zero + 1e4)
    kw.update(uvel0=kw["uvel"], vvel0=kw["vvel"])
    jcfg = ibt.IcebergsConfig(grid_is_latlon=True, use_f_plane=False)
    j = jax.jit(lambda e, k: jaccel.accel(jcfg, None, env=JEnv(**e),
                                          dt=3600., **k))(
        {k: jnp.asarray(v) for k, v in env.items()},
        {k: jnp.asarray(v) for k, v in kw.items()})
    t = taccel.accel(cfg, None, env=TEnv(**{k: torch.as_tensor(v)
                                            for k, v in env.items()}),
                     dt=3600., **{k: torch.as_tensor(v)
                                  for k, v in kw.items()})
    for name in ("ax", "ay", "axn", "ayn", "bxn", "byn"):
        _close(getattr(t, name).numpy(), getattr(j, name), name)
    # the f-plane value stays the f-plane value on a lat-lon grid
    fp = coriolis(cfg.replace(use_f_plane=True, lat_ref=-70.),
                  torch.as_tensor(lat)).numpy()
    assert np.unique(fp).size == 1 and fp[0] < 0


def _wide_world(n=120, seed=5):
    """Bergs from 80 S to 80 N on a 36 x 16 grid of 10 x 10 degree cells
    (periodic in longitude, one land column), uniform forcing."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=True, Lx=360., use_f_plane=False,
                             dt=3600., Runge_not_Verlet=False)
    msk = np.ones((36, 16))
    msk[20, :] = 0.
    grid = ibt.make_uniform_grid(36, 16, 0., -80., 10., 10.,
                                 grid_is_latlon=True, msk=msk)
    frc = ibt.uniform_forcing(36, 16, uo=0.3, vo=-0.1, ua=8.0, va=3.0,
                              sst=1.0, sss=34.)
    rng = np.random.RandomState(seed)
    lon = rng.uniform(0.5, 359.5, n)
    lon[:10] = rng.uniform(359.9, 359.999, 10)      # at the seam
    lat = rng.uniform(-79., 79., n)
    st = ibt.create_bergs(256, lon=lon, lat=lat,
                          uvel=rng.uniform(-.5, .5, n),
                          vvel=rng.uniform(-.5, .5, n),
                          mass=850. * 200. * 2e3 * 3e3, thickness=200.,
                          width=2e3, length=3e3, mass_scaling=1.,
                          id_cnt=np.arange(n) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, 360.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    return cfg, grid, frc, st


@pytest.mark.parametrize("rk4", [False, True], ids=["verlet", "rk4"])
def test_step_coriolis_by_latitude_matches_jax(rk4):
    """Two coupling steps (the table interpolation, accel with Coriolis
    at each berg's latitude, Verlet or RK4 through the lat-lon metric,
    the walk periodic in longitude, thermodynamics with the latitude's
    boundary-layer depth) from 80 S to 80 N, bergs at the 0/360 seam:
    cells exact, floats within the file's tolerance."""
    from icebergs_tpu import model as jmodel
    cfg, grid, frc, st = _wide_world()
    cfg = cfg.replace(Runge_not_Verlet=rk4)
    tcfg, tgrid, tst = _port(cfg, grid, st)
    tfrc = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    jstep = jax.jit(jmodel.make_step(grid, cfg))
    tstep = ibp.make_step(tgrid, tcfg)
    js, ts = st, tst
    for _ in range(2):
        js, jd = jstep(js, frc)
        ts, td = tstep(ts, tfrc)
        assert int(td.bounced) == int(jd.bounced)
    J, T = _leaves(js), ibp.to_numpy(ts)
    live = J["alive"]
    for name in ("alive", "ine", "jne"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    for name in ("lon", "lat", "uvel", "vvel", "axn", "ayn", "bxn", "byn",
                 "mass", "thickness", "xi", "yj"):
        _close(T[name][live], J[name][live], name)
    moved = np.abs(T["lon"] - _leaves(st)["lon"])[live]
    assert moved.max() > 1e-3


def test_advance_position_polar_tangent_plane():
    """``_advance_position`` on a lat-lon grid: the metric step below
    89 degrees, the polar tangent plane above (rotpos / rotvec to and
    from the plane), against the JAX function on the same inputs; the
    positions within 1e-5 degrees (arccos near +-1 turns an ulp of its
    argument into ~1e-6)."""
    from icebergs_tpu import dynamics as jdyn
    from icebergs_tpu_torch import dynamics as tdyn
    rng = np.random.RandomState(7)
    n = 64
    lat = np.float32(np.r_[rng.uniform(89.0, 89.99, n // 2),
                           rng.uniform(60., 88.9, n // 2)])
    lon = np.float32(rng.uniform(-180., 180., n))
    u = np.float32(rng.uniform(-0.5, 0.5, n))
    v = np.float32(rng.uniform(-0.5, 0.5, n))
    cfg = ibt.IcebergsConfig(grid_is_latlon=True, Lx=360.)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    jl, jt = jdyn._advance_position(None, cfg, *map(jnp.asarray,
                                                    (lon, lat, u, v)), 3600.)
    tl, tt = tdyn._advance_position(tcfg, *map(torch.as_tensor,
                                               (lon, lat, u, v)), 3600.)
    tang = lat > 89.
    assert tang.sum() > 20
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=1e-5)
    dl = (tl.numpy() - np.asarray(jl) + 180.) % 360. - 180.
    assert np.abs(dl[~tang]).max() <= 1e-5
    # on the plane a longitude's error scales with 1 / colatitude
    assert np.abs(dl[tang] * (90. - lat[tang])).max() <= 1e-5
    assert (np.abs(tl.numpy() - lon)[tang] > 1e-3).all()


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

SKW = dict(fused_block_n=16, fused_fallback_strip_width=128)
MODES = {"fused": {}, "buckets": dict(max_per_cell=80)}


@functools.lru_cache(maxsize=None)
def _step_world():
    """``tests/test_torch_perstep.py``'s clustered world (300 bergs, a
    dense knot, a land strip, the swirl on the index grid) on a 16 x 16
    lat-lon grid of 0.02 x 0.01 degree cells near 62 S, Coriolis by
    latitude."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=True, Lx=360.,
                             use_f_plane=False, dt=600.,
                             Runge_not_Verlet=False,
                             interactive_icebergs_on=True,
                             use_new_predictive_corrective=True)
    msk = np.ones((16, 16))
    msk[12:, :] = 0.
    grid = ibt.make_uniform_grid(16, 16, LON0, LAT0, DLON, DLAT,
                                 grid_is_latlon=True, msk=msk)
    frc = ibt.swirl_forcing(16, 16, 1.0, uo=0.3, ua=5.0, sst=4.0, sss=33.0)
    n = 300
    rng = np.random.RandomState(11)
    x = rng.uniform(4., 12., n)
    y = rng.uniform(4., 12., n)
    k = n // 4
    x[:k] = 7.5 + rng.uniform(-0.12, 0.12, k)
    y[:k] = 7.5 + rng.uniform(-0.12, 0.12, k)
    x[k:k + 20] = 11.9
    st = ibt.create_bergs(512, lon=LON0 + DLON * x, lat=LAT0 + DLAT * y,
                          uvel=rng.uniform(-.3, .3, n),
                          vvel=rng.uniform(-.3, .3, n),
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.,
                          id_cnt=np.arange(n) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, 360.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    tcfg, tgrid, tst = _port(cfg, grid, st)
    return cfg, grid, frc, st, (tcfg, tgrid,
                                ibp.forcing_from_numpy(_leaves(frc),
                                                       device=CPU), tst)


def test_fast_lane_latlon_matches_jax():
    """4 steps of the persistent fused3 lane (K1, K2's lat-lon branch,
    K3) against the JAX ``make_multi_step``, with the tolerance of
    ``tests/test_torch_perstep.py`` (rtol 1e-5 plus 2e-5 of scale;
    counters and cells exact)."""
    from icebergs_tpu import model as jmodel
    from test_torch_perstep import assert_steps_close
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _step_world()
    jout = jax.jit(jmodel.make_persistent_multi_step(
        grid, cfg, 4, True, neighbor_mode="fused3", fused_interpret=True,
        **SKW))(st, frc)
    tout = ibp.make_multi_step(tgrid, tcfg, 4, True, **SKW)(tst, tfrc)
    assert int(tout[1]) == 0 and 0 < int(tout[2]) < 300
    assert_steps_close(tout, jout)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_perstep_latlon_matches_jax(mode):
    """4 per-step ``fused`` (K5's lat-lon branch) and ``buckets`` (the
    pair precompute's metric, K7) steps against the JAX ``make_multi_step
    (persistent=False)``, tolerance as above."""
    from icebergs_tpu import model as jmodel
    from test_torch_perstep import assert_steps_close
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _step_world()
    jout = jmodel.make_multi_step(grid, cfg, 4, True, persistent=False,
                                  neighbor_mode=mode, fused_interpret=True,
                                  **SKW, **MODES[mode])(st, frc)
    tout = ibp.make_multi_step(tgrid, tcfg, 4, True, persistent=False,
                               neighbor_mode=mode, **SKW,
                               **MODES[mode])(tst, tfrc)
    assert int(tout[1]) == 0
    if mode == "fused":
        assert 0 < int(tout[2]) < 300
    assert_steps_close(tout, jout)


def _run_world(case):
    """The lat-lon worlds of ``tests/test_api.py::test_full_pipeline_
    with_calving_and_melt`` (footloose bits, rolling, 6 steps) and
    ``tests/test_calving.py`` (one cell's huge flux, 4 steps)."""
    if case == "pipeline":
        cfg = ibt.IcebergsConfig(grid_is_latlon=True, Lx=360., dt=3600.,
                                 footloose=True, fl_style='fl_bits',
                                 allow_bergs_to_roll=True)
        grid = ibt.make_uniform_grid(12, 12, 0., -65., 0.5, 0.5,
                                     grid_is_latlon=True)
        frc = ibt.uniform_forcing(12, 12, uo=0.2, ua=4.0, sst=3.0, sss=34.)
        calving = np.zeros((14, 14), np.float32)
        calving[3, 3], calving[9, 9] = 4.0e7, 2.0e7
        return cfg, grid, frc, calving, 6, 128
    cfg = ibt.IcebergsConfig(grid_is_latlon=True, Lx=360., dt=3600.0)
    grid = ibt.make_uniform_grid(8, 8, 0.0, -10., 0.5, 0.5,
                                 grid_is_latlon=True)
    frc = ibt.uniform_forcing(8, 8)
    calving = np.zeros((10, 10), np.float32)
    calving[5, 5] = 5.0e7
    return cfg, grid, frc, calving, 4, 64


@pytest.mark.parametrize("case", ["pipeline", "calving"])
def test_run_latlon_matches_jax(case):
    """``IcebergsModel.run`` on a lat-lon grid against the JAX entry
    (calving at cell centres from the four corners, footloose placement
    through the metric, Coriolis by latitude): slots, ids, cells and
    counters exact; floats within ``tests/test_torch_api.py``'s
    tolerance (rtol 1e-5 plus 2e-5 of scale, the melt fields as
    ``MELT_LIMITS``); the budgets close as the JAX test requires."""
    from icebergs_tpu import api as japi
    from icebergs_tpu_torch import api as tapi
    from test_torch_api import INTS, MELT_LIMITS, _jax_fl_uniforms
    cfg, grid, frc, calving, nsteps, cap = _run_world(case)
    jm = japi.IcebergsModel(grid, cfg)
    tcfg, tgrid = _port(cfg, grid)
    tm = tapi.IcebergsModel(tgrid, tcfg, device=CPU)
    js = jm.init_state(ibt.empty_state(cap), seed=3, year=2001, yearday=5.)
    ts = tm.init_state(ibp.empty_state(cap, device=CPU), seed=3, year=2001,
                       yearday=5.)
    tf = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    hflx = np.zeros_like(calving)
    calved = 0
    for _ in range(nsteps):
        unif = (_jax_fl_uniforms(js.key, cfg.fl_style) if cfg.footloose
                else None)
        js, jo = jm.run(js, frc, jnp.asarray(calving), jnp.asarray(hflx))
        ts, to = tm.run(ts, tf, torch.as_tensor(calving),
                        torch.as_tensor(hflx), fl_uniforms=unif)
        for f in ("nbergs", "nbergs_calved", "nbergs_calved_fl",
                  "spawn_overflow", "nbergs_melted", "tickets"):
            t, j = getattr(to, f), getattr(jo, f)
            assert (t is None) == (j is None), f
            assert t is None or int(t) == int(j), f
        calved += int(to.nbergs_calved)
    assert calved > 0 and int(to.nbergs) > 0
    J, T = _leaves(js.bergs), ibp.to_numpy(ts.bergs)
    live = J["alive"]
    for name, t in T.items():
        if name in INTS:
            np.testing.assert_array_equal(t, J[name], err_msg=name)
        elif t.dtype.kind == "f":
            _close(t[live], J[name][live], name)
    for f in ("spread_mass", "spread_area", "ustar_iceberg",
              "mass_on_ocean"):
        _close(getattr(to, f).numpy(), getattr(jo, f), f)
    for f, lim in MELT_LIMITS.items():
        if hasattr(jo, f) and getattr(jo, f) is not None:
            _close(np.asarray(getattr(to, f)), np.asarray(getattr(jo, f)), f,
                   0., lim)
    for f in ("mass", "mass_of_bits", "stored_ice"):
        _close(float(getattr(to.budgets, f)), float(getattr(jo.budgets, f)),
               f)
    if case == "pipeline":
        area = tgrid.area.numpy()
        assert float(to.spread_mass.max()) > 0.
        used = 0.99 * float(calving.sum()) * cfg.dt * nsteps
        b = to.budgets
        lhs = float(b.mass + b.mass_of_bits + b.stored_ice)
        assert lhs < used and np.isfinite(area).all()


def _a68_cfg(regular):
    """``tools/run_a68.py:64-80``'s ``a68_config`` (the a68_test namelist:
    MTS + DEM + contact distance, 18 substeps of a 60 s step), written
    out here."""
    return ibt.IcebergsConfig(
        grid_is_latlon=True, grid_is_regular=regular, Lx=360., dt=60.,
        Runge_not_Verlet=False, mts=True, mts_sub_steps=18,
        explicit_inner_mts=True, dem=True, dem_spring_coef=5.e6,
        dem_damping_coef=1.0, interactive_icebergs_on=True,
        iceberg_bonds_on=True, spring_coef=1.e-5,
        contact_spring_coef=1.e-8, contact_distance=2000.,
        manually_initialize_bonds=True,
        manually_initialize_bonds_from_radii=True,
        allow_bergs_to_roll=False, set_melt_rates_to_zero=True,
        max_bonds=6, hexagonal_icebergs=False).normalized(warn=False)


@functools.lru_cache(maxsize=None)
def _a68_world(regular):
    """Two 4x4 conglomerates of 3 km square elements 8 km apart near
    60 S, converging, on a 16 x 16 grid of 0.125 x 0.0625 degree cells
    (regular, or the same corners as a curvilinear grid), bonded by the
    JAX package on the lat-lon metric."""
    from icebergs_tpu.geometry import (find_cell_local,
                                       pos_within_cell_curvilinear)
    from icebergs_tpu.grid import make_curvilinear_grid
    from icebergs_tpu.ops import forces as jforces
    cfg = _a68_cfg(regular)
    lon0, lat0, dlon, dlat, n = 40., -61., 0.125, 0.0625, 16
    if regular:
        grid = ibt.make_uniform_grid(n, n, lon0, lat0, dlon, dlat,
                                     grid_is_latlon=True)
    else:
        lc, la = np.meshgrid(lon0 + dlon * np.arange(n + 1),
                             lat0 + dlat * np.arange(n + 1), indexing="ij")
        grid = make_curvilinear_grid(lc, la)
    frc = ibt.uniform_forcing(n, n, uo=0.2, vo=0.05, ua=6.0, sst=-1.5,
                              sss=34.)
    x, y = np.meshgrid(np.arange(4) * 3000., np.arange(4) * 3000.,
                       indexing="ij")
    x = np.r_[x.ravel() + 20e3, x.ravel() + 40e3]
    y = np.r_[y.ravel(), y.ravel() + 2e3] + 20e3
    lon, lat = _to_degrees(x, y, lon0, lat0)
    m = x.size
    st = ibt.create_bergs(64, lon=lon, lat=lat,
                          uvel=np.where(np.arange(m) < 16, 0.3, -0.3),
                          vvel=np.zeros(m), mass=850. * 200. * 3000. ** 2,
                          thickness=200., width=3000., length=3000.,
                          mass_scaling=1., id_cnt=np.arange(m) + 1)
    if regular:
        i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, 360.)
    else:
        i, j, _ = find_cell_local(grid, st.lon, st.lat,
                                  jnp.full_like(st.ine, n // 2),
                                  jnp.full_like(st.jne, n // 2), 360.,
                                  radius=n // 2)
        xi, yj, _ = pos_within_cell_curvilinear(grid, st.lon, st.lat, i, j,
                                                360.)
    st = jforces.initialize_bonds_host(st.replace(ine=i, jne=j, xi=xi,
                                                  yj=yj), cfg)
    return cfg, grid, frc, st


@pytest.mark.parametrize("regular", [True, False],
                         ids=["regular", "curvilinear"])
def test_a68_mts_outer_step_matches_jax(regular):
    """One MTS outer step on the A68 flag set (Part 1 through K2's
    lat-lon branch with the conglomerate filter, the scan substeps with
    the DEM metric, ``interp_flds`` on the curvilinear grid, the quad
    walk) against the JAX ``make_step``: cells, bonds and counters
    exact; floats within the whole-MTS-step tolerance of
    ``tests/test_torch_mts.py`` (rtol 1e-4 plus 2e-3 of scale)."""
    from icebergs_tpu import model as jmodel
    cfg, grid, frc, st = _a68_world(regular)
    tcfg, tgrid, tst = _port(cfg, grid, st)
    ibp.check_ported(tcfg)
    tfrc = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    assert (np.asarray(st.bond_idx) >= 0).sum() > 40
    js, jd = jax.jit(jmodel.make_step(grid, cfg, fused_interpret=True))(
        st, frc)
    ts, td = ibp.make_step(tgrid, tcfg)(tst, tfrc)
    for f in ("p1_overflow", "contact_overflow"):
        if getattr(jd, f) is not None:
            assert int(getattr(td, f)) == int(getattr(jd, f)), f
    J, T = _leaves(js), ibp.to_numpy(ts)
    live = J["alive"]
    for name in ("alive", "ine", "jne", "bond_idx", "bond_broken",
                 "n_bonds", "conglom_id"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    for name in ("lon", "lat", "uvel", "vvel", "axn_fast", "ayn_fast",
                 "xi", "yj", "bond_length"):
        _close(T[name][live], J[name][live], name, 1e-4, 2e-3)
    moved = np.abs(T["lon"] - _leaves(st)["lon"])[live]
    assert moved.max() > 1e-4

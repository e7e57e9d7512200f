"""The port's file I/O against the JAX package's (``icebergs_tpu/io``):
the namelist into the config, field by field; the bergs, bonds and
calving restarts byte for byte in both directions (each package reads
what the other wrote into the same state); ``read_ocean_depth``; the
trajectory and bond-trajectory buffers and files; and the mirrors of
``tests/test_io.py``'s round trips and checks.

Tolerance: none.  The same state gives the same bytes (one scipy
writer, one variable order, one type per variable) and the same state
back, bit for bit; a re-localised berg's ``xi`` / ``yj`` come from
:func:`pos_to_cell`, bitwise the JAX function's on these grids.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import icebergs_tpu as ibt
from icebergs_tpu import calving as jcv
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.io import namelist as jnml
from icebergs_tpu.io import restart as jrio
from icebergs_tpu.io import trajectory as jtio
from icebergs_tpu.ops import forces as jforces

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import calving as tcv
from icebergs_tpu_torch import diag as tdiag
from icebergs_tpu_torch.io import namelist as tnml
from icebergs_tpu_torch.io import restart as trio
from icebergs_tpu_torch.io import trajectory as ttio
from icebergs_tpu_torch.ops import forces as tforces

import test_driver
import test_driver_growth

torch.set_num_threads(1)
CPU = torch.device("cpu")

# tests/test_mts_collision.py's configuration (input_MTS_KID.nml) as a
# namelist: every value through the parser's coercions
MTS_KID_NML = """
&icebergs_driver_nml
  ni=20
  nj=20
  ibdt=3600.0
  ibvo=0.2
  collision_test=.true.
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
  traj_name='kid_traj.nc'   ! a string
  initial_mass=8.8e7, 4.1e8, 3.3e9, 1.8e10, 3.8e10, 7.5e10, 1.2e11, 2.2e11, 3.9e11, 7.4e11
  no_such_setting=3
/
"""

NAMELISTS = {"driver": test_driver.NML, "dem": test_driver.DEM_NML,
             "growth_fl": test_driver_growth.NML,
             "growth_fused": test_driver_growth.FUSED_NML,
             "mts_kid": MTS_KID_NML}


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _port(st):
    return ibp.state_from_numpy(_leaves(st), device=CPU)


def _same_state(t, j):
    """Every field of a port state bit for bit the JAX state's."""
    J = _leaves(j)
    for name, v in ibp.to_numpy(t).items():
        np.testing.assert_array_equal(v, J[name], err_msg=name)


@pytest.mark.parametrize("name", sorted(NAMELISTS))
def test_namelist_matches_jax(tmp_path, name):
    path = tmp_path / "input.nml"
    path.write_text(NAMELISTS[name])
    jcfg, jdrv = jnml.config_from_namelist(str(path))
    tcfg, tdrv = tnml.config_from_namelist(str(path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tdrv == jdrv
    assert jnml.parse_namelist_file(str(path)) == \
        tnml.parse_namelist_file(str(path))
    if name == "mts_kid":
        assert tcfg.convergence_tolerance == 1e-8
        assert tcfg.traj_name == "kid_traj.nc"
        assert tcfg.initial_mass[-1] == 7.4e11
        assert tdrv["_unknown"] == {"no_such_setting": 3}
        assert tdrv["collision_test"] is True and tdrv["ni"] == 20


def _world(footloose=True, mts=True, dem=True):
    """``tests/test_io.py``'s world with every variable group on."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0, dt=600.,
                             iceberg_bonds_on=True, dem=dem, mts=mts,
                             footloose=footloose, max_bonds=4)
    grid = ibt.make_uniform_grid(10, 10, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    st = ibt.create_bergs(32, lon=[2500., 2900., 7700.],
                          lat=[2500., 2500., 7100.],
                          mass=[1e8, 2e8, 3e8], thickness=[10., 20., 30.],
                          width=[30., 40., 50.], length=[60., 70., 80.],
                          uvel=[0.1, 0.2, 0.3], mass_scaling=1.,
                          id_cnt=[1, 2, 3], id_ij=[11, 12, 13],
                          max_bonds=4)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    st = jforces.initialize_bonds_host(
        st, cfg.replace(length_for_manually_initialize_bonds=600.))
    return cfg, grid, st


def _random_world(n=150, cap=256, seed=5):
    """A denser, messier world: random fields in every restart variable,
    dead slots between live ones, a halo copy, bonds formed by distance
    with id stamps on some, DEM bond state on all."""
    rng = np.random.RandomState(seed)
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0, dt=600.,
                             iceberg_bonds_on=True, dem=True, mts=True,
                             footloose=True, max_bonds=6)
    grid = ibt.make_uniform_grid(12, 9, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    slots = np.sort(rng.choice(cap, n, replace=False))
    full = {}
    for f in ("lon", "lat"):
        lim = 12000. if f == "lon" else 9000.
        full[f] = rng.uniform(100., lim - 100., n)
    kw = {f: rng.uniform(-1., 1., n) * 10. ** rng.uniform(-3, 9, n)
          for f in ("uvel", "vvel", "axn", "ayn", "bxn", "byn",
                    "start_lon", "start_lat", "start_day", "mass_of_bits",
                    "heat_density", "fl_k", "mass_of_fl_bits",
                    "mass_of_fl_bergy_bits", "axn_fast", "ayn_fast",
                    "bxn_fast", "byn_fast", "ang_vel", "ang_accel", "rot")}
    st = ibt.create_bergs(n, lon=full["lon"], lat=full["lat"],
                          mass=rng.uniform(1e7, 1e10, n),
                          thickness=rng.uniform(10., 300., n),
                          width=rng.uniform(100., 900., n),
                          length=rng.uniform(100., 900., n),
                          mass_scaling=rng.uniform(1., 3., n),
                          start_mass=rng.uniform(1e7, 1e10, n),
                          id_cnt=rng.permutation(n) + 1,
                          id_ij=rng.randint(0, 1 << 20, n),
                          start_year=rng.randint(1990, 2030, n),
                          fl_spawn_count=rng.randint(0, 5, n),
                          static_berg=(rng.rand(n) < .1).astype(float),
                          max_bonds=6, **kw)
    big = ibt.empty_state(cap, max_bonds=6)
    st = big.replace(**{f: getattr(big, f).at[slots].set(getattr(st, f))
                        for f in ("alive", "lon", "lat", "uvel", "vvel",
                                  "mass", "thickness", "width", "length",
                                  "mass_scaling", "start_mass", "id_cnt",
                                  "id_ij", "start_year", "fl_spawn_count",
                                  "static_berg", *kw)})
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    st = st.replace(halo_berg=st.halo_berg.at[slots[7]].set(1.0))
    st = jforces.initialize_bonds_host(
        st, cfg.replace(length_for_manually_initialize_bonds=900.))
    has = np.asarray(st.bond_idx) >= 0
    assert has.sum() > 100
    stamp = has & (rng.rand(*has.shape) < 0.3)
    other = np.maximum(np.asarray(st.bond_idx), 0)
    st = st.replace(
        bond_id_cnt=jnp.asarray(np.where(stamp, np.asarray(st.id_cnt)[other],
                                         0).astype(np.int32)),
        bond_id_ij=jnp.asarray(np.where(stamp, np.asarray(st.id_ij)[other],
                                        0).astype(np.int32)),
        bond_broken=jnp.asarray((has & (rng.rand(*has.shape) < .2))
                                .astype(np.int32)),
        **{f: jnp.asarray(np.where(has, rng.normal(0, 1e4, has.shape), 0.),
                          jnp.float32)
           for f in ("bond_tangd1", "bond_tangd2", "bond_nstress",
                     "bond_sstress", "bond_rel_rotation")})
    return cfg, grid, st


WORLDS = {"test_io": lambda: _world(),
          "plain": lambda: _world(footloose=False, mts=False, dem=False),
          "random": _random_world}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_restart_bergs_bytes_and_reads_match_jax(tmp_path, world):
    cfg, grid, st = WORLDS[world]()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    jp, tp = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jrio.write_restart_bergs(jp, st, cfg)
    trio.write_restart_bergs(tp, _port(st), tcfg)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    cap = st.capacity + 8
    j = jrio.read_restart_bergs(jp, cap, grid, cfg)
    _same_state(trio.read_restart_bergs(tp, cap, tgrid, tcfg), j)
    # the JAX package reads the port's file into the same state
    _same_state(trio.read_restart_bergs(jp, cap, tgrid, tcfg),
                jrio.read_restart_bergs(tp, cap, grid, cfg))
    assert int(j.count()) == int(np.asarray(
        st.alive & (st.halo_berg < 0.5)).sum())


@pytest.mark.parametrize("world", ["test_io", "random"])
def test_restart_bonds_bytes_and_reads_match_jax(tmp_path, world):
    cfg, grid, st = WORLDS[world]()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    jp, tp = str(tmp_path / "jb.nc"), str(tmp_path / "tb.nc")
    jrio.write_restart_bonds(jp, st, cfg)
    trio.write_restart_bonds(tp, _port(st), tcfg)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    bp = str(tmp_path / "bergs.nc")
    jrio.write_restart_bergs(bp, st, cfg)
    jst = jrio.read_restart_bergs(bp, st.capacity, grid, cfg)
    tst = trio.read_restart_bergs(bp, st.capacity, tgrid, tcfg)
    j = jrio.read_restart_bonds(jp, jst, cfg)
    t = trio.read_restart_bonds(tp, tst, tcfg)
    _same_state(t, j)
    assert int((t.bond_idx >= 0).sum()) > 0
    # the records as written re-bond the same partners, by id
    if world == "random":
        ids = np.asarray(st.id_cnt)
        own = np.asarray(st.alive) & (np.asarray(st.halo_berg) < 0.5)
        tid = t.id_cnt.numpy()
        for s in np.nonzero(own)[0][:40]:
            r = int(np.nonzero(tid == ids[s])[0][0])
            want = [ids[o] for o in np.asarray(st.bond_idx)[s] if o >= 0]
            got = [tid[o] for o in t.bond_idx.numpy()[r] if o >= 0]
            assert got == want


def test_restart_bonds_too_many_raises(tmp_path):
    cfg, grid, st = _world()
    path = str(tmp_path / "b.nc")
    jrio.write_restart_bonds(path, st, cfg)
    with netcdf_file(path, "r", mmap=False) as f:
        data = {k: np.asarray(v[:]) for k, v in f.variables.items()}
    data = {k: np.concatenate([v] * 5) for k, v in data.items()}
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    with pytest.raises(ValueError, match="too many bonds"):
        trio._apply_bond_records(_port(st), data, tcfg)


def _calving(grid, seed=2):
    rng = np.random.RandomState(seed)
    calv = jcv.init_calving_state(grid)
    shape = calv.stored_heat.shape
    return calv.replace(
        stored_ice=jnp.asarray(rng.uniform(0, 1e10, calv.stored_ice.shape),
                               jnp.float32),
        stored_heat=jnp.asarray(rng.uniform(0, 1e13, shape), jnp.float32),
        rmean_calving=jnp.asarray(rng.uniform(0, 1e3, shape), jnp.float32),
        rmean_calving_hflx=jnp.asarray(rng.uniform(0, 1e3, shape),
                                       jnp.float32),
        id_counter=jnp.asarray(rng.randint(0, 99, shape), jnp.int32))


def test_restart_calving_bytes_and_reads_match_jax(tmp_path):
    cfg, grid, st = _world()
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    calv = _calving(grid)
    tcalv = tcv.CalvingState(**{k: torch.as_tensor(np.array(v))
                                for k, v in _leaves(calv).items()})
    jp, tp = str(tmp_path / "jc.nc"), str(tmp_path / "tc.nc")
    jrio.write_restart_calving(jp, calv, grid)
    trio.write_restart_calving(tp, tcalv, tgrid)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    j = jrio.read_restart_calving(tp, jcv.init_calving_state(grid), grid)
    t = trio.read_restart_calving(jp, tcv.init_calving_state(tgrid), tgrid)
    for k, v in _leaves(j).items():
        np.testing.assert_array_equal(getattr(t, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("order", ["ij", "ji", "missing", "no_depth"])
def test_read_ocean_depth_matches_jax(tmp_path, order, capsys):
    """``tests/test_io.py:154``'s cases (and the (j, i) file order):
    the padded ocean_depth the JAX function gives, a missing file or
    variable leaving the grid as it is."""
    cfg, grid, st = _world()
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    depth = np.linspace(10., 500., 100).reshape(10, 10) * np.arange(
        1, 11)[None, :]
    path = str(tmp_path / "topog.nc")
    if order != "missing":
        with netcdf_file(path, "w") as f:
            f.createDimension("nx", 10)
            f.createDimension("ny", 10)
            name = "depth" if order != "no_depth" else "other"
            f.createVariable(name, "d", ("nx", "ny"))[:] = (
                depth.T if order == "ji" else depth)
    j = jrio.read_ocean_depth(path, grid)
    jout = capsys.readouterr().out
    t = trio.read_ocean_depth(path, tgrid)
    assert capsys.readouterr().out == jout
    np.testing.assert_array_equal(t.ocean_depth.numpy(),
                                  np.asarray(j.ocean_depth))
    if order in ("ij", "ji"):
        want = depth.T if order == "ji" else depth
        np.testing.assert_allclose(t.ocean_depth.numpy()[1:-1, 1:-1], want,
                                   rtol=1e-6)
    else:
        assert t is tgrid


def test_read_ocean_depth_wrong_shape_raises(tmp_path):
    cfg, grid, st = _world()
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    path = str(tmp_path / "topog.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("nx", 7)
        f.createVariable("depth", "d", ("nx", "nx"))[:] = np.ones((7, 7))
    with pytest.raises(ValueError, match="does not match"):
        trio.read_ocean_depth(path, tgrid)


def test_restart_roundtrip_bergs_and_bonds(tmp_path):
    """``tests/test_io.py:41`` on the port."""
    cfg, grid, st = _world()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tst = _port(st)
    bpath, kpath = str(tmp_path / "b.nc"), str(tmp_path / "k.nc")
    trio.write_restart_bergs(bpath, tst, tcfg)
    trio.write_restart_bonds(kpath, tst, tcfg)
    st2 = trio.read_restart_bergs(bpath, 32, tgrid, tcfg)
    assert int(st2.count()) == 3
    for f in ("lon", "lat", "uvel", "mass", "thickness", "width", "length"):
        np.testing.assert_array_equal(getattr(st2, f).numpy()[:3],
                                      getattr(tst, f).numpy()[:3])
    np.testing.assert_array_equal(st2.ine.numpy()[:3], tst.ine.numpy()[:3])
    st2 = trio.read_restart_bonds(kpath, st2, tcfg)
    assert int(st2.bond_idx[0, 0]) == 1 and int(st2.bond_idx[1, 0]) == 0
    assert int(st2.n_bonds[2]) == 0
    labs = st2.conglom_id.numpy()
    assert labs[0] == labs[1] != labs[2]


def test_restart_roundtrip_calving(tmp_path):
    """``tests/test_io.py:66`` on the port."""
    cfg, grid, st = _world()
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    calv = tcv.init_calving_state(tgrid)
    si, sh, idc = (calv.stored_ice.clone(), calv.stored_heat.clone(),
                   calv.id_counter.clone())
    si[3, 4, 2], sh[3, 4], idc[3, 4] = 7.5e9, 1.0e13, 17
    calv = calv.replace(stored_ice=si, stored_heat=sh, id_counter=idc)
    path = str(tmp_path / "calving.res.nc")
    trio.write_restart_calving(path, calv, tgrid)
    c2 = trio.read_restart_calving(path, tcv.init_calving_state(tgrid),
                                   tgrid)
    assert float(c2.stored_ice[3, 4, 2]) == float(np.float32(7.5e9))
    assert float(c2.stored_heat[3, 4]) == float(np.float32(1.0e13))
    assert float(c2.rmean_calving.abs().sum()) == 0.
    assert int(c2.id_counter[3, 4]) == 17


def test_read_restart_warns_outside_grid(tmp_path, capsys):
    cfg, grid, st = _world(footloose=False, mts=False, dem=False)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    small = ibp.make_uniform_grid(5, 5, 0., 0., 1000., 1000.,
                                  grid_is_latlon=False, device=CPU)
    path = str(tmp_path / "b.nc")
    jrio.write_restart_bergs(path, st, cfg)
    t = trio.read_restart_bergs(path, 32, small, tcfg)
    err = capsys.readouterr().err
    assert "1/3 restart bergs lie outside the grid" in err
    assert int(t.ine.max()) == 4
    with pytest.raises(ValueError, match="capacity"):
        trio.read_restart_bergs(path, 2, small, tcfg)


SCHEMAS = {"short": dict(save_short_traj=True),
           "fl": dict(save_short_traj=False, save_fl_traj=True),
           "full": dict(save_short_traj=False, save_fl_traj=False),
           "by_class": dict(save_short_traj=True, traj_area_thres=1.0,
                            save_nonfl_traj_by_class=True,
                            save_traj_by_class_start_mass_thres_s=5e8,
                            save_traj_by_class_start_mass_thres_n=5e8)}


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_trajectory_buffer_and_file_match_jax(tmp_path, schema):
    """Two samples, a drain, a third sample appended: the buffers bit
    for bit and the files byte for byte; a grown buffer keeps its
    rows."""
    cfg, grid, st = _random_world(seed=7)
    cfg = cfg.replace(iceberg_bonds_on=False, **SCHEMAS[schema])
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tst = _port(st)
    jb = jtio.init_traj_buffer(st.capacity, nsamples=3, cfg=cfg)
    tb = ttio.init_traj_buffer(st.capacity, nsamples=3, cfg=tcfg,
                               device=CPU)
    for day, dlon in ((1.5, 0.), (2.5, 100.)):
        jb = jtio.record_posn(jb, st.replace(lon=st.lon + dlon), cfg,
                              day=day, year=2000)
        tb = ttio.record_posn(tb, tst.replace(lon=tst.lon + dlon), tcfg,
                              day=day, year=2000)
    assert list(tb.data) == list(jb.data)
    for k in jb.data:
        np.testing.assert_array_equal(tb.data[k].numpy(),
                                      np.asarray(jb.data[k]), err_msg=k)
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    assert tb.cursor == int(jb.cursor) == 2
    jp, tp = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    nj, jb = jtio.write_trajectories(jp, jb, cfg)
    nt, tb = ttio.write_trajectories(tp, tb, tcfg)
    assert nt == nj > 0
    assert not tb.valid.any() and tb.cursor == 0
    jb = jtio.record_posn(jb, st, cfg, day=3.5, year=2040)
    tb = ttio.record_posn(tb, tst, tcfg, day=3.5, year=2040)
    jtio.write_trajectories(jp, jb, cfg)
    ttio.write_trajectories(tp, tb, tcfg)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    grown = ttio.grow_traj_buffer(tb, st.capacity + 64)
    assert grown.valid.shape == (3, st.capacity + 64)
    np.testing.assert_array_equal(grown.valid[:, :st.capacity].numpy(),
                                  tb.valid.numpy())
    assert ttio.grow_traj_buffer(tb, 8) is tb


def test_bond_trajectory_matches_jax(tmp_path):
    cfg, grid, st = _random_world(seed=3)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    jb = jtio.init_bond_traj_buffer(st.capacity, st.max_bonds, nsamples=2)
    tb = ttio.init_bond_traj_buffer(st.capacity, st.max_bonds, nsamples=2,
                                    device=CPU)
    jb = jtio.record_bonds(jb, st, cfg, day=1.0)
    tb = ttio.record_bonds(tb, _port(st), tcfg, day=1.0)
    for k in jb.data:
        np.testing.assert_array_equal(tb.data[k].numpy(),
                                      np.asarray(jb.data[k]), err_msg=k)
    jp, tp = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    nj, _ = jtio.write_trajectories(jp, jb, cfg)
    nt, _ = ttio.write_trajectories(tp, tb, tcfg)
    assert nt == nj > 100
    assert open(jp, "rb").read() == open(tp, "rb").read()
    grown = ttio.grow_traj_buffer(tb, (st.capacity + 2) * st.max_bonds)
    assert grown.valid.shape[1] == (st.capacity + 2) * st.max_bonds


def test_bond_trajectory_buffer_and_write(tmp_path):
    """``tests/test_io.py:101`` on the port."""
    cfg, grid, st = _world()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tst = _port(st)
    buf = ttio.init_bond_traj_buffer(tst.capacity, tst.max_bonds,
                                     nsamples=2, device=CPU)
    buf = ttio.record_bonds(buf, tst, tcfg, day=1.0)
    path = str(tmp_path / "bond_trajectories.nc")
    n, buf = ttio.write_trajectories(path, buf, tcfg)
    assert n == 2
    with netcdf_file(path, "r", mmap=False) as f:
        fc = np.asarray(f.variables["first_id_cnt"][:])
        oc = np.asarray(f.variables["other_id_cnt"][:])
    assert sorted(zip(fc.tolist(), oc.tolist())) == [(1, 2), (2, 1)]


def test_trajectory_buffer_and_write(tmp_path):
    """``tests/test_io.py:115`` on the port."""
    cfg, grid, st = _world()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg.replace(
        save_short_traj=True)))
    tst = _port(st)
    buf = ttio.init_traj_buffer(tst.capacity, nsamples=4, cfg=tcfg,
                                device=CPU)
    buf = ttio.record_posn(buf, tst, tcfg, day=1.5, year=2000)
    buf = ttio.record_posn(buf, tst.replace(lon=tst.lon + 100.), tcfg,
                           day=2.5, year=2000)
    path = str(tmp_path / "iceberg_trajectories.nc")
    n, buf = ttio.write_trajectories(path, buf, tcfg)
    assert n == 6
    with netcdf_file(path, "r", mmap=False) as f:
        lon = np.asarray(f.variables["lon"][:])
        day = np.asarray(f.variables["day"][:])
    assert lon.shape == (6,)
    assert set(np.round(day, 2)) == {1.5, 2.5}
    buf = ttio.record_posn(buf, tst, tcfg, day=3.5, year=2000)
    n, buf = ttio.write_trajectories(path, buf, tcfg)
    with netcdf_file(path, "r", mmap=False) as f:
        assert np.asarray(f.variables["lon"][:]).shape == (9,)


def test_config_normalized_coercions():
    """``tests/test_io.py:166`` on the port's config."""
    cfg = ibp.IcebergsConfig(mts=True, Runge_not_Verlet=True).normalized(
        warn=False)
    assert cfg.Runge_not_Verlet is False
    cfg = ibp.IcebergsConfig(dem=True).normalized(warn=False)
    assert cfg.explicit_inner_mts and cfg.iceberg_bonds_on
    with pytest.raises(ValueError):
        ibp.IcebergsConfig(use_broken_bonds_for_substep_contact=True
                           ).normalized(warn=False)


def test_bond_reciprocity_check():
    """``tests/test_io.py:179`` on the port."""
    cfg, grid, st = _world()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tst = _port(st)
    assert int(tforces.check_bond_reciprocity(tst)) == 0
    bi = tst.bond_idx.clone()
    bi[1, 0] = -1
    bad = tforces.count_bonds(tst.replace(bond_idx=bi))
    assert int(tforces.check_bond_reciprocity(bad)) == 1
    probs = tdiag.check_state(bad, tgrid, tcfg, fatal=False)
    assert any("non-reciprocal" in p for p in probs)


def test_debug_write_and_stop(tmp_path):
    """debugwriteandstop writes the JAX package's restart file and
    stops."""
    cfg, grid, st = _world()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    jp, tp = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    with pytest.raises(RuntimeError, match="state dumped"):
        tdiag.debug_write_and_stop(_port(st), tcfg, path=tp)
    jrio.write_restart_bergs(jp, st, cfg)
    assert open(jp, "rb").read() == open(tp, "rb").read()

"""The port's tiled restart and trajectory files (``io/restart.py``'s and
``io/trajectory.py``'s tiled parts) against the JAX package's, on the
worlds of ``tests/test_io.py:208-303`` and ``tests/test_traj_sharded.py``.

For the same tiled state (the JAX package's ``shard_state`` and the
port's, which place the bergs in the same slots) every file is byte for
byte the JAX package's: the restarts ``icebergs.res.nc.NNNN`` at
``io_layout`` 1 and 2, with the bond files ``bonds_icebergs.res.nc.NNNN``
of a bonded world whose pair straddles a tile edge, and the
trajectories ``path.NNNN`` of a halo-filled state (the halo copies not
recorded).  The files read back into one untiled state with every
restart field of the global state bit for bit and the bonds matched by
id across the edge; the 4-tile recording of 3 tiled steps is the untiled
recording of the same steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.io import restart as jrio
from icebergs_tpu.io import trajectory as jtio
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.parallel import domain as jdd

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.io import restart as rio
from icebergs_tpu_torch.io import trajectory as tio
from icebergs_tpu_torch.ops import forces as tforces
from icebergs_tpu_torch.parallel import domain as dd
from scipy.io import netcdf_file

import torch_parallel_worlds as W

torch.set_num_threads(1)
IO_CFG = dict(grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=30.0,
              dt=600.0, halo=2)
BONDS_CFG = dict(IO_CFG, iceberg_bonds_on=True, dem=True, mts=True,
                 max_bonds=4)


def restart_world(bonded: bool):
    """test_io.py's worlds (32 x 8 cells of 5 km, 4 tiles): 17 bergs from
    RandomState(4), or 4 bergs bonded in pairs, one pair straddling the
    tile edge at 16 cells, with DEM bond state set.  Returns numpy
    inputs: ``(cfg keywords, berg keywords, bond length)``."""
    if not bonded:
        rng = np.random.RandomState(4)
        n = 17
        return IO_CFG, dict(
            lon=rng.uniform(2 * W.DXY, (W.NX - 2) * W.DXY, n),
            lat=rng.uniform(W.DXY, (W.NY - 1) * W.DXY, n),
            mass=rng.uniform(1e8, 9e8, n), thickness=30., width=70.,
            length=90., mass_scaling=1.0, id_cnt=np.arange(n) + 1), None
    return BONDS_CFG, dict(
        lon=np.array([3.2, 3.3, 15.9, 16.1]) * W.DXY,
        lat=np.array([4.0] * 4) * W.DXY, mass=1e9, thickness=30.,
        width=300., length=300., mass_scaling=1.0,
        id_cnt=np.arange(4) + 1, max_bonds=4), 1.2 * W.DXY


def jax_state(bonded):
    cfg_kw, bk, blen = restart_world(bonded)
    cfg = ibt.IcebergsConfig(**cfg_kw)
    grid = ibt.make_uniform_grid(W.NX, W.NY, 0., 0., W.DXY, W.DXY,
                                 grid_is_latlon=False)
    st = ibt.create_bergs(64, **bk)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    if bonded:
        st = jforces.initialize_bonds_host(
            st, cfg.replace(length_for_manually_initialize_bonds=blen))
        st = st.replace(bond_tangd1=jnp.where(st.bond_idx >= 0, 0.5, 0.),
                        bond_nstress=jnp.where(st.bond_idx >= 0, 7.0, 0.))
    return cfg, st


def port_state(bonded):
    cfg_kw, bk, blen = restart_world(bonded)
    cfg = ibp.IcebergsConfig(**cfg_kw)
    grid = ibp.make_uniform_grid(W.NX, W.NY, 0., 0., W.DXY, W.DXY,
                                 grid_is_latlon=False, device=W.CPU)
    st = W.bergs(grid, bk.pop("lon"), bk.pop("lat"), capacity=64, **bk)
    if bonded:
        st = tforces.initialize_bonds_host(
            st, cfg.replace(length_for_manually_initialize_bonds=blen))
        has = st.bond_idx >= 0
        st = st.replace(bond_tangd1=torch.where(has, 0.5, 0.),
                        bond_nstress=torch.where(has, 7.0, 0.))
    return cfg, grid, st


def files_equal(a, b):
    return open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX package's tiled files: the restarts of both worlds at
    io_layout 1 and 2, and the trajectories of the halo-filled drift
    world, written from its sharded states on 4 devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    root = tmp_path_factory.mktemp("jax")
    mesh = Mesh(np.array(jax.devices()[:4]), (jdd.AXIS,))
    for bonded in (False, True):
        cfg, st = jax_state(bonded)
        world = jdd.make_sharded_world(cfg, mesh, nx=W.NX, ny=W.NY, lon0=0.,
                                       lat0=0., dlon=W.DXY, dlat=W.DXY)
        st_s = jdd.shard_state(world, st, local_capacity=32)
        for layout in (1, 2):
            d = root / f"b{int(bonded)}l{layout}"
            d.mkdir()
            jrio.write_restart_bergs_tiled(str(d / "icebergs.res.nc"), st_s,
                                           cfg, io_layout=layout)
    cfg, st = traj_world_jax()
    world = jdd.make_sharded_world(cfg, mesh, nx=16, ny=8, lon0=0., lat0=0.,
                                   dlon=1000., dlat=1000.)
    st_s, _ = jdd.make_halo_fill(world, exchange_width=16)(
        jdd.shard_state(world, st, local_capacity=32))
    bufs = jtio.init_traj_buffer_tiled((4,), 32, nsamples=4, cfg=cfg)
    for k in range(2):
        bufs = jtio.record_posn_tiled(bufs, st_s, cfg, day=k + 1., year=0)
    jtio.write_trajectories_tiled(str(root / "traj.nc"), bufs, cfg)
    return root


@pytest.mark.parametrize("bonded", [False, True])
@pytest.mark.parametrize("layout", [1, 2])
def test_tiled_restart_matches_jax(tmp_path, jax_files, bonded, layout):
    """Each tile (or io_layout group) file byte for byte the JAX package's;
    read back, every restart field of every berg equals the global
    state's, and the bonds are matched by id across the edge."""
    cfg, grid, st = port_state(bonded)
    w = W.tiled_world(cfg, (4,), W.NX, W.NY, W.DXY)
    ts = dd.shard_state(w, st, 32)
    base = str(tmp_path / "icebergs.res.nc")
    paths = rio.write_restart_bergs_tiled(base, ts, cfg, io_layout=layout)
    assert len(paths) == 4 // layout
    jdir = jax_files / f"b{int(bonded)}l{layout}"
    for p in paths:
        name = p.rsplit("/", 1)[1]
        assert files_equal(p, jdir / name), name
        if bonded:
            assert files_equal(tmp_path / f"bonds_{name}",
                               jdir / f"bonds_{name}"), name
    back = rio.read_restart_bergs_tiled(base, 64, grid, cfg, device=W.CPU)
    if bonded:
        back = rio.read_restart_bonds_tiled(base, back, cfg)
    a, b = W.owned_by_id(st), W.owned_by_id(back)
    n = 4 if bonded else 17
    assert a["lon"].shape == b["lon"].shape == (n,)
    W.assert_bitwise(b, a, [f for _, f, _ in rio.BERG_VARS
                            if f not in W.FRAME])
    if bonded:
        slot = {int(c): s for s, c in zip(np.nonzero(back.alive.numpy())[0],
                                          back.id_cnt.numpy()[
                                              back.alive.numpy()])}
        bidx = back.bond_idx.numpy()
        assert bidx[slot[1], 0] == slot[2] and bidx[slot[2], 0] == slot[1]
        assert bidx[slot[3], 0] == slot[4] and bidx[slot[4], 0] == slot[3]
        assert back.n_bonds.numpy()[list(slot.values())].tolist() == [1.] * 4
        assert float(back.bond_nstress[slot[3], 0]) == 7.0


def traj_world_jax():
    cfg = ibt.IcebergsConfig(**W.DRIFT)
    grid = ibt.make_uniform_grid(16, 8, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    lon, lat = traj_positions()
    st = ibt.create_bergs(64, lon=lon, lat=lat, mass=1e8, thickness=20.,
                          width=60., length=60., mass_scaling=1.,
                          id_cnt=np.arange(len(lon)) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    return cfg, st.replace(ine=i, jne=j, xi=xi, yj=yj)


def traj_positions():
    """test_traj_sharded.py's 12 bergs (RandomState(7)) on 16 x 8 cells
    of 1 km."""
    rng = np.random.RandomState(7)
    return rng.uniform(1e3, 15e3, 12), rng.uniform(1e3, 7e3, 12)


def traj_world():
    cfg = ibp.IcebergsConfig(**W.DRIFT)
    grid = ibp.make_uniform_grid(16, 8, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, device=W.CPU)
    frc = ibp.uniform_forcing(16, 8, uo=1.0, sst=2., device=W.CPU)
    st = W.bergs(grid, *traj_positions(), mass=1e8, thickness=20.,
                 width=60., length=60., id_cnt=np.arange(12) + 1)
    return cfg, grid, frc, st


def test_tiled_trajectory_matches_jax(tmp_path, jax_files):
    """The 4 tiles' trajectory files of a halo-filled state (2 samples)
    byte for byte the JAX package's: each berg recorded once, by its
    owner."""
    cfg, grid, frc, st = traj_world()
    w = W.tiled_world(cfg, (4,), 16, 8, 1000.)
    ts, _ = dd.make_halo_fill(w, 16)(dd.shard_state(w, st, 32))
    assert sum(int((t.alive & (t.halo_berg >= 0.5)).sum()) for t in ts) > 0
    bufs = tio.init_traj_buffer_tiled(w.ring, 32, 4, cfg, device=W.CPU)
    for k in range(2):
        bufs = tio.record_posn_tiled(bufs, ts, cfg, day=k + 1., year=0)
    total, bufs = tio.write_trajectories_tiled(str(tmp_path / "traj.nc"),
                                               bufs, cfg)
    assert total == 2 * 12
    assert not any(bool(b.valid.any()) for b in bufs)
    for k in range(4):
        name = f"traj.nc.{k:04d}"
        assert files_equal(tmp_path / name, jax_files / name), name


def test_tiled_trajectory_matches_untiled(tmp_path):
    """test_traj_sharded.py: 3 steps of the 4-tile step recorded by tile,
    against the untiled steps' recording: the same entries, bit for bit
    (the tiled step is the untiled one's bits)."""
    cfg, grid, frc, st = traj_world()
    step1 = ibp.make_step(grid, cfg, with_thermo=False)
    buf = tio.init_traj_buffer(st.capacity, 4, cfg, device=W.CPU)
    s1 = st
    for k in range(3):
        s1, _ = step1(s1, frc)
        buf = tio.record_posn(buf, s1, cfg, day=k + 1., year=0)
    n1, _ = tio.write_trajectories(str(tmp_path / "ref.nc"), buf, cfg)
    w = W.tiled_world(cfg, (4,), 16, 8, 1000.)
    fs, ts = W.shard(w, frc, st, 32)
    step = dd.make_sharded_step(w, with_thermo=False, exchange_width=16)
    bufs = tio.init_traj_buffer_tiled((4,), 32, 4, cfg, device=W.CPU)
    for k in range(3):
        ts, nb, _, _ = step(ts, fs)
        bufs = tio.record_posn_tiled(bufs, ts, cfg, day=k + 1., year=0)
    total, _ = tio.write_trajectories_tiled(str(tmp_path / "traj.nc"), bufs,
                                            cfg)
    assert int(nb) == 12 and total == n1 == 3 * 12

    def load(paths):
        cols = {}
        for p in paths:
            with netcdf_file(str(p), "r", mmap=False) as f:
                for k, v in f.variables.items():
                    cols.setdefault(k, []).append(np.asarray(v[:]))
        cols = {k: np.concatenate(v) for k, v in cols.items()}
        o = np.lexsort((cols["day"], cols["id_cnt"]))
        return {k: v[o] for k, v in cols.items()}
    a = load([tmp_path / f"traj.nc.{k:04d}" for k in range(4)])
    b = load([tmp_path / "ref.nc"])
    assert set(a) == set(b)
    for k in b:
        assert np.array_equal(a[k], b[k]), k

"""The rest of the JAX package's public API in the port
(``icebergs_tpu/__init__.py:13-36``): every top-level name, and
``step_dynamics`` (interpolation and evolve, ``tests/test_dynamics.py:37``'s
use), ``interp_to_bergs`` and ``forcing_from_arrays`` (the halo padding
of the centre fields) against the JAX functions on the same inputs.

Tolerance: ``forcing_from_arrays`` and ``interp_to_bergs``' integer and
pass-through fields bit for bit; the interpolated and evolved floats
within ``tests/test_torch_step.py``'s ``rtol 1e-5`` plus 2e-5 of scale
(XLA:CPU contracts the bilinear multiply-adds, ROADMAP.md Queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell

import icebergs_tpu_torch as ibp

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def test_top_level_names():
    import icebergs_tpu
    for name in icebergs_tpu.__all__:
        assert hasattr(ibp, name), name
        assert name in ibp.__all__, name
    assert ibp.NCLASSES == ibt.NCLASSES == 10


@pytest.mark.parametrize("padded", [False, True])
def test_forcing_from_arrays_matches_jax(padded):
    rng = np.random.RandomState(4)
    nx, ny = 7, 5
    cn = (nx + 2, ny + 2) if padded else (nx, ny)
    kw = {k: rng.normal(size=(nx + 1, ny + 1))
          for k in ("uo", "vo", "ui", "vi", "ua", "va")}
    kw.update({k: rng.normal(size=cn)
               for k in ("ssh", "sst", "sss", "cn", "hi")})
    j = ibt.forcing_from_arrays(**kw)
    t = ibp.forcing_from_arrays(**kw, device=CPU)
    for k, v in _leaves(j).items():
        tv = getattr(t, k)
        assert tv.dtype == torch.float32 and tv.shape == v.shape, k
        np.testing.assert_array_equal(tv.numpy(), v, err_msg=k)
    assert t.sst.shape == (nx + 2, ny + 2)


def _world(n=40, seed=3):
    rng = np.random.RandomState(seed)
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1., use_f_plane=True,
                             lat_ref=45., dt=600., Runge_not_Verlet=False)
    grid = ibt.make_uniform_grid(12, 10, 0., 0., 2000., 2000.,
                                 grid_is_latlon=False)
    grid = grid.replace(ocean_depth=grid.ocean_depth * 0. + 800.)
    frc = ibt.forcing_from_arrays(
        uo=rng.uniform(-.3, .3, (13, 11)), vo=rng.uniform(-.3, .3, (13, 11)),
        ui=np.zeros((13, 11)), vi=np.zeros((13, 11)),
        ua=rng.uniform(-8, 8, (13, 11)), va=rng.uniform(-8, 8, (13, 11)),
        ssh=rng.uniform(-.1, .1, (12, 10)), sst=rng.uniform(-1, 3, (12, 10)),
        sss=np.full((12, 10), 33.), cn=np.zeros((12, 10)),
        hi=np.zeros((12, 10)))
    st = ibt.create_bergs(64, lon=rng.uniform(3000., 21000., n),
                          lat=rng.uniform(3000., 17000., n),
                          mass=rng.uniform(1e8, 1e10, n),
                          thickness=rng.uniform(50., 250., n),
                          width=rng.uniform(200., 900., n),
                          length=rng.uniform(200., 900., n),
                          uvel=rng.uniform(-.2, .2, n), mass_scaling=1.,
                          id_cnt=np.arange(n) + 1)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    return cfg, grid, frc, st


def _port(cfg, grid, frc, st):
    return (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))


def _same(t, j, exact=()):
    J, T = _leaves(j), ibp.to_numpy(t)
    alive = J["alive"]
    for name, v in T.items():
        if v.dtype.kind != "f" or name in exact:
            np.testing.assert_array_equal(v, J[name], err_msg=name)
        else:
            b = J[name][alive].astype(np.float64)
            scale = np.abs(b).max() if b.size else 0.
            np.testing.assert_allclose(v[alive], b, rtol=RTOL,
                                       atol=ATOL_SCALE * scale,
                                       err_msg=name)


def test_interp_to_bergs_matches_jax():
    cfg, grid, frc, st = _world()
    j = ibt.interp_to_bergs(st, grid, frc, cfg)
    tcfg, tgrid, tfrc, tst = _port(cfg, grid, frc, st)
    t = ibp.interp_to_bergs(tst, tgrid, tfrc, tcfg)
    _same(t, j, exact=("lon", "lat", "uvel", "vvel", "mass", "xi", "yj",
                       "od"))


def test_step_dynamics_matches_jax():
    """Three steps of interpolation and evolve, as
    ``tests/test_dynamics.py:37`` drives ``step_dynamics``."""
    cfg, grid, frc, st = _world()
    tcfg, tgrid, tfrc, tst = _port(cfg, grid, frc, st)
    for _ in range(3):
        jo = ibt.step_dynamics(st, grid, frc, cfg)
        to = ibp.step_dynamics(tst, tgrid, tfrc, tcfg)
        st, tst = jo.state, to.state
        assert int(to.tickets) == int(jo.tickets)
        assert int(to.bounced) == int(jo.bounced)
    _same(tst, st)
    assert float(tst.lon.numpy()[0]) != float(_world()[3].lon[0])

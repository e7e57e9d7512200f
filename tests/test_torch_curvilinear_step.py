"""Curvilinear grids in the port's stepping path (``grid_is_regular=
False``): the quad-cell walk over ``calc_xiyj``, mirroring
``tests/test_curvilinear_step.py`` (rotation equivariance over 40 steps,
the land bounce), and whole steps against the JAX ``make_step`` on the
30-degree rotated grid and on ``make_tripolar_grid(24, 18)``.

Parity tolerance: cells and counters exact; floats within ``rtol 1e-5``
plus 2e-5 of each field's scale (``tests/test_torch_step.py``'s, for
XLA:CPU's contracted multiply-adds and its float32 ``cos`` / ``sin``).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import model as jmodel
from icebergs_tpu.geometry import (find_cell_local,
                                   pos_within_cell_curvilinear)
from icebergs_tpu.grid import make_curvilinear_grid, make_tripolar_grid

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import geometry as tgeo

torch.set_num_threads(1)
CPU = torch.device("cpu")
N, DXY = 20, 1000.0
TH = math.radians(30.0)
RTOL, ATOL_SCALE = 1e-5, 2e-5


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


def rot(x, y, th=TH):
    c, s = math.cos(th), math.sin(th)
    return c * x - s * y, c * y + s * x


def _rotated(msk=None):
    xc = np.arange(N + 1) * DXY
    X, Y = np.meshgrid(xc, xc, indexing="ij")
    return rot(X, Y), msk


def _port_cfg(cfg):
    return ibp.config_from_dict(dataclasses.asdict(cfg))


def _cfgs():
    cfg = ibp.IcebergsConfig(grid_is_latlon=False, Lx=-1.0,
                             use_f_plane=True, lat_ref=40.0, dt=600.0,
                             Runge_not_Verlet=True)
    return cfg, cfg.replace(grid_is_regular=False)


def _bergs_at(grid, x, y, curvilinear, Lx=-1.0, cap=16, **kw):
    """Port bergs at (x, y), located by the regular formula or the local
    quad search."""
    n = len(x)
    kw = {**dict(mass=8.5e8, thickness=40., width=100., length=250.,
                 mass_scaling=1.0, id_cnt=np.arange(n) + 1), **kw}
    st = ibp.create_bergs(cap, lon=x, lat=y, device=CPU, **kw)
    if curvilinear:
        i, j, found = tgeo.find_cell_local(
            grid, st.lon, st.lat, torch.full_like(st.ine, grid.nx // 2),
            torch.full_like(st.jne, grid.ny // 2), Lx,
            radius=max(grid.nx, grid.ny) // 2)
        assert bool(found[st.alive].all())
        xi, yj, _ = tgeo.pos_within_cell_curvilinear(grid, st.lon, st.lat,
                                                     i, j, Lx)
        return st.replace(ine=i, jne=j, xi=xi, yj=yj)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, Lx)
    return st.replace(ine=i, jne=j, xi=xi, yj=yj)


def test_rotation_equivariant_trajectory():
    """40 RK4 steps on a 30-degree rotated Cartesian grid with rotated
    forcing give the rotated trajectory of the regular grid's run, and
    the curvilinear run keeps every berg in its cell."""
    cfg, cfg_c = _cfgs()
    grid_r = ibp.make_uniform_grid(N, N, 0., 0., DXY, DXY,
                                   grid_is_latlon=False, device=CPU)
    (Xr, Yr), _ = _rotated()
    grid_c = ibp.make_curvilinear_grid(Xr, Yr, device=CPU)
    uo, ua = (0.5, 0.2), (4.0, -2.0)
    frc_r = ibp.uniform_forcing(N, N, uo=uo[0], vo=uo[1], ua=ua[0],
                                va=ua[1], sst=2.0, sss=33., device=CPU)
    uor, vor = rot(*uo)
    uar, var = rot(*ua)
    frc_c = ibp.uniform_forcing(N, N, uo=uor, vo=vor, ua=uar, va=var,
                                sst=2.0, sss=33., device=CPU)
    x0 = y0 = 10.2 * DXY
    st_r = _bergs_at(grid_r, [x0], [y0], False)
    xr0, yr0 = rot(x0, y0)
    st_c = _bergs_at(grid_c, [xr0], [yr0], True)
    step_r = ibp.make_step(grid_r, cfg)
    step_c = ibp.make_step(grid_c, cfg_c)
    for _ in range(40):
        st_r, _ = step_r(st_r, frc_r)
        st_c, _ = step_c(st_c, frc_c)
        ok = tgeo.is_point_in_cell(grid_c, st_c.lon, st_c.lat, st_c.ine,
                                   st_c.jne, -1.0)
        assert bool(ok[st_c.alive].all())
    xe, ye = rot(float(st_r.lon[0]), float(st_r.lat[0]))
    np.testing.assert_allclose(float(st_c.lon[0]), xe, atol=2.0)
    np.testing.assert_allclose(float(st_c.lat[0]), ye, atol=2.0)
    ue, ve = rot(float(st_r.uvel[0]), float(st_r.vvel[0]))
    np.testing.assert_allclose(float(st_c.uvel[0]), ue, atol=1e-3)
    np.testing.assert_allclose(float(st_c.vvel[0]), ve, atol=1e-3)


def test_curvilinear_walk_bounces_at_land():
    """A berg driven east at a land wall on the rotated grid bounces
    (the posn_eps pushback) and never enters land."""
    _, cfg_c = _cfgs()
    (Xr, Yr), _ = _rotated()
    msk = np.ones((N, N))
    msk[12:, :] = 0.0
    grid_c = ibp.make_curvilinear_grid(Xr, Yr, msk=msk, device=CPU)
    uor, vor = rot(1.0, 0.0)
    frc_c = ibp.uniform_forcing(N, N, uo=uor, vo=vor, sst=2.0, sss=33.,
                                device=CPU)
    st = _bergs_at(grid_c, *map(lambda v: [v], rot(11.5 * DXY, 10.5 * DXY)),
                   True)
    step = ibp.make_step(grid_c, cfg_c, with_thermo=False)
    bounced = 0
    for _ in range(60):
        st, d = step(st, frc_c)
        bounced += int(d.bounced)
    assert int(st.ine[0]) <= 11 and bounced > 0
    ok = tgeo.is_point_in_cell(grid_c, st.lon, st.lat, st.ine, st.jne, -1.0)
    assert bool(ok[st.alive].all())


def _jax_located(grid, st, Lx, n):
    i, j, found = find_cell_local(grid, st.lon, st.lat,
                                  jnp.full_like(st.ine, grid.nx // 2),
                                  jnp.full_like(st.jne, grid.ny // 2), Lx,
                                  radius=max(grid.nx, grid.ny) // 2)
    assert bool(np.asarray(found)[:n].all())
    xi, yj, _ = pos_within_cell_curvilinear(grid, st.lon, st.lat, i, j, Lx)
    return st.replace(ine=i, jne=j, xi=xi, yj=yj)


@functools.lru_cache(maxsize=None)
def _parity_world(case):
    """The rotated 20 x 20 grid with a land wall (Cartesian, RK4,
    contacts), or ``make_tripolar_grid(24, 18)`` with its two polar cells
    on land (lat-lon, Verlet, Coriolis by latitude) with bergs on the
    lat-lon rows and across the cap; 64 bergs each."""
    rng = np.random.RandomState(9)
    n = 64
    if case == "rotated":
        cfg = ibt.IcebergsConfig(grid_is_latlon=False, grid_is_regular=False,
                                 Lx=-1.0, use_f_plane=True, lat_ref=40.0,
                                 dt=600.0, Runge_not_Verlet=True,
                                 interactive_icebergs_on=True)
        (Xr, Yr), _ = _rotated()
        msk = np.ones((N, N))
        msk[15:, :] = 0.
        grid = make_curvilinear_grid(Xr, Yr, msk=msk)
        x, y = rot(rng.uniform(3e3, 14e3, n), rng.uniform(3e3, 17e3, n))
        uo, ua = rot(0.5, 0.2), rot(4.0, -2.0)
        frc = ibt.uniform_forcing(N, N, uo=uo[0], vo=uo[1], ua=ua[0],
                                  va=ua[1], sst=2.0, sss=33.)
        Lx, w = -1.0, 400.
    else:
        cfg = ibt.IcebergsConfig(grid_is_latlon=True, grid_is_regular=False,
                                 Lx=360., dt=1800.0, Runge_not_Verlet=False,
                                 use_f_plane=False)
        nx, ny = 24, 18
        msk = np.ones((nx, ny))
        msk[nx // 4 - 1:nx // 4 + 1, ny - 1] = 0.
        msk[3 * nx // 4 - 1:3 * nx // 4 + 1, ny - 1] = 0.
        grid = make_tripolar_grid(nx, ny, msk=msk)
        lonc, latc = np.asarray(grid.lonc), np.asarray(grid.latc)
        ci = rng.randint(0, nx, n)
        cj = rng.randint(0, ny - 2, n)
        xi, yj = rng.uniform(0.1, 0.9, n), rng.uniform(0.1, 0.9, n)
        x = ((1 - xi) * (1 - yj) * lonc[ci, cj] + xi * (1 - yj)
             * lonc[ci + 1, cj] + xi * yj * lonc[ci + 1, cj + 1]
             + (1 - xi) * yj * lonc[ci, cj + 1])
        y = ((1 - xi) * (1 - yj) * latc[ci, cj] + xi * (1 - yj)
             * latc[ci + 1, cj] + xi * yj * latc[ci + 1, cj + 1]
             + (1 - xi) * yj * latc[ci, cj + 1])
        frc = ibt.uniform_forcing(nx, ny, uo=0.4, vo=0.15, ua=6.0, sst=2.0,
                                  sss=33.)
        Lx, w = 360., 2000.
    st = ibt.create_bergs(128, lon=x, lat=y, mass=850. * 100. * w * w,
                          thickness=100., width=w, length=w,
                          mass_scaling=1.0, id_cnt=np.arange(n) + 1,
                          uvel=rng.uniform(-.2, .2, n),
                          vvel=rng.uniform(-.2, .2, n))
    st = _jax_located(grid, st, Lx, n)
    port = (_port_cfg(cfg), ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))
    return cfg, grid, frc, st, Lx, port


@pytest.mark.parametrize("case", ["rotated", "tripolar"])
def test_curvilinear_steps_match_jax(case):
    """6 coupling steps through ``make_step`` (the table interpolation,
    the quad walk, thermodynamics, spreading; on the rotated grid the
    fused3 contacts too) against the JAX ``make_step``; every live berg
    stays in its cell."""
    cfg, grid, frc, st, Lx, (tcfg, tgrid, tfrc, tst) = _parity_world(case)
    jstep = jax.jit(jmodel.make_step(grid, cfg, fused_interpret=True))
    tstep = ibp.make_step(tgrid, tcfg)
    js, ts = st, tst
    for _ in range(6):
        js, jd = jstep(js, frc)
        ts, td = tstep(ts, tfrc)
        assert int(td.bounced) == int(jd.bounced)
        assert int(td.nbergs) == int(jd.nbergs)
    J, T = _leaves(js), ibp.to_numpy(ts)
    live = J["alive"]
    for name in ("alive", "ine", "jne"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    for name in ("lon", "lat", "uvel", "vvel", "xi", "yj", "axn", "ayn",
                 "mass"):
        j = J[name][live].astype(np.float64)
        np.testing.assert_allclose(T[name][live], j, rtol=RTOL,
                                   atol=ATOL_SCALE * np.abs(j).max(),
                                   err_msg=name)
    ok = tgeo.is_point_in_cell(tgrid, ts.lon, ts.lat, ts.ine, ts.jne, Lx)
    assert bool(ok[ts.alive].all())
    assert np.abs(T["lon"] - _leaves(st)["lon"])[live].max() > 0.

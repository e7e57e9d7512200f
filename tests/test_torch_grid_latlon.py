"""The port's grid builders and metric factors against the JAX package:
the lat-lon metric at latitudes from -89.9 to 89.9, ``make_curvilinear_
grid`` on a rotated box and ``make_tripolar_grid(24, 18)`` (corners bit
for bit, the haversine ``dx`` / ``dy`` / ``area`` and the centre
latitude, the tripolar fold pairing), ``center_at`` and ``pos_to_cell``
across the periodic seam at ``Lx = 360``.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import grid as jgrid

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import grid as tgrid

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _same_grid(t, j):
    """Every field of the port's grid equals the JAX grid's bit for bit
    (both round float64 numpy once to float32); the tile metadata is an
    untiled grid's in both (the JAX offsets None, the port's 0; the
    port's global origin None)."""
    assert (t.nx, t.ny) == (j.nx, j.ny)
    for f in dataclasses.fields(t):
        if f.name in ("nx", "ny"):
            continue
        if f.name in ("lon0g", "lat0g"):
            assert getattr(t, f.name) is None
            continue
        if isinstance(getattr(t, f.name), int):
            assert getattr(t, f.name) == (getattr(j, f.name) or 0), f.name
            continue
        np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                      np.asarray(getattr(j, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("fn", ["convert_from_grid_to_meters",
                                "convert_from_meters_to_grid"])
def test_metric_factors_match_jax(fn):
    """dx/dlon, dy/dlat and their reciprocals from -89.9 to 89.9 degrees:
    the product PI_180 Rearth folded once, the reciprocals correctly
    rounded (bit for bit where ``cos`` rounds alike; within 2 ulp
    otherwise); ones on a Cartesian grid."""
    lat = np.float32(np.linspace(-89.9, 89.9, 1799))
    for Re in (6360000., 6363827.):
        j = getattr(jgrid, fn)(jnp.asarray(lat), True, Re)
        t = getattr(tgrid, fn)(torch.as_tensor(lat), True, Re)
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]),
                                   rtol=2.4e-7, atol=0)
        assert t[0].dtype == torch.float32
    one = getattr(tgrid, fn)(torch.as_tensor(lat), False, 6360000.)
    assert all(bool((x == 1.).all()) for x in one)


def test_pair_separation_is_the_metric_product():
    """``pair_separation`` is ``(lon1 - lon2) * dx_dlon(mean lat)`` and
    ``(lat1 - lat2) * dy_dlat`` bit for bit, and the plain differences
    on a Cartesian grid."""
    rng = np.random.RandomState(0)
    a = [torch.as_tensor(np.float32(rng.uniform(-80., 80., 64)))
         for _ in range(4)]
    dx, dy = tgrid.convert_from_grid_to_meters(0.5 * (a[1] + a[3]), True,
                                               6360000.)
    rx, ry = tgrid.pair_separation(*a, True, 6360000.)
    assert torch.equal(rx, (a[0] - a[2]) * dx)
    assert torch.equal(ry, (a[1] - a[3]) * dy)
    rx, ry = tgrid.pair_separation(*a, False, 6360000.)
    assert torch.equal(rx, a[0] - a[2]) and torch.equal(ry, a[1] - a[3])


def test_uniform_latlon_grid_matches_jax():
    j = ibt.make_uniform_grid(24, 12, 350., -75., 0.5, 0.25,
                              grid_is_latlon=True)
    t = ibp.make_uniform_grid(24, 12, 350., -75., 0.5, 0.25,
                              grid_is_latlon=True, device=CPU)
    _same_grid(t, j)


def test_curvilinear_rotated_box_matches_jax():
    """A 20 x 20 Cartesian box of 1 km cells rotated by 30 degrees, and a
    masked distorted lat-lon patch."""
    th = math.radians(30.)
    xc = np.arange(21) * 1000.
    X, Y = np.meshgrid(xc, xc, indexing="ij")
    Xr = math.cos(th) * X - math.sin(th) * Y
    Yr = math.cos(th) * Y + math.sin(th) * X
    _same_grid(ibp.make_curvilinear_grid(Xr, Yr, device=CPU),
               jgrid.make_curvilinear_grid(Xr, Yr))
    ii, jj = np.meshgrid(np.arange(7.), np.arange(6.), indexing="ij")
    lon = 20. + ii + 0.25 * np.sin(jj * 0.7)
    lat = -60. + jj + 0.2 * np.cos(ii * 0.5)
    msk = np.ones((6, 5))
    msk[2, 3] = 0.
    od = np.arange(30.).reshape(6, 5)
    _same_grid(ibp.make_curvilinear_grid(lon, lat, msk=msk, ocean_depth=od,
                                         device=CPU),
               jgrid.make_curvilinear_grid(lon, lat, msk=msk,
                                           ocean_depth=od))


@pytest.mark.parametrize("kw", [dict(), dict(lat0=-80.),
                                dict(lat0=40., lon0=80.)],
                         ids=["default", "southern", "shifted"])
def test_tripolar_grid_matches_jax(kw):
    """``make_tripolar_grid(24, 18)``: every field bit for bit, and the
    fold pairing corner(i, ny) == corner(nx - i, ny) on the sphere."""
    t = ibp.make_tripolar_grid(24, 18, device=CPU, **kw)
    _same_grid(t, jgrid.make_tripolar_grid(24, 18, **kw))
    lonc = t.lonc.double().numpy()
    latc = t.latc.double().numpy()
    nx, ny = 24, 18

    def xyz(i):
        lo, la = np.radians(lonc[i, ny]), np.radians(latc[i, ny])
        return np.array([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                         np.sin(la)])

    for i in range(nx + 1):
        np.testing.assert_allclose(xyz(i), xyz(nx - i), atol=1e-6)
    # the cap's meridional cells have the lat-lon rows' extent, roughly
    dy = t.dy[1:-1, 1:-1].numpy()
    assert dy.min() > 0. and dy.max() / dy.min() < 3.


def test_center_at_matches_jax():
    g = ibp.make_tripolar_grid(24, 18, device=CPU)
    jg = jgrid.make_tripolar_grid(24, 18)
    rng = np.random.RandomState(1)
    i = rng.randint(-1, 25, 50)
    j = rng.randint(-1, 19, 50)
    for name in ("dx", "area", "lat_center", "msk"):
        np.testing.assert_array_equal(
            tgrid.center_at(getattr(g, name), torch.as_tensor(i),
                            torch.as_tensor(j)).numpy(),
            np.asarray(jgrid.center_at(getattr(jg, name), jnp.asarray(i),
                                       jnp.asarray(j))), err_msg=name)


def test_pos_to_cell_across_the_seam():
    """A global 1-degree grid from 0 E: positions either side of the
    0/360 seam, written as 359.x, -0.x, 360.x and 719.x, land in the
    same cells with the same (xi, yj) as the JAX ``pos_to_cell`` at
    ``Lx = 360``."""
    j = ibt.make_uniform_grid(360, 20, 0., -70., 1., 1., grid_is_latlon=True)
    t = ibp.make_uniform_grid(360, 20, 0., -70., 1., 1., grid_is_latlon=True,
                              device=CPU)
    rng = np.random.RandomState(2)
    base = np.r_[rng.uniform(359., 360., 20), rng.uniform(0., 1., 20)]
    lon = np.float32(np.r_[base, base - 360., base + 360., 180.5])
    lat = np.float32(rng.uniform(-69.5, -50.5, lon.size))
    ti, tj, txi, tyj = tgrid.pos_to_cell(t, torch.as_tensor(lon),
                                         torch.as_tensor(lat), 360.)
    ji, jj, jxi, jyj = jgrid.pos_to_cell(j, jnp.asarray(lon),
                                         jnp.asarray(lat), 360.)
    for a, b in ((ti, ji), (tj, jj), (txi, jxi), (tyj, jyj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    i = ti.numpy()
    assert (i[:20] == 359).all() and (i[20:40] == 0).all()
    assert (i[:40] == i[40:80]).all() and (i[:40] == i[80:120]).all()


def test_cos_ulp_is_the_libraries():
    """Whose ulp the metric factors' tolerance is: on the float32 angles
    PI_180 * lat of the latitudes above, torch's CPU ``cos`` and XLA:CPU's
    are each within one ulp of the correctly rounded value (float64 cos
    rounded once), and neither is it everywhere (torch's misses more
    often), so dx/dlon can differ by an ulp between the packages
    (ROADMAP.md Queue 3).  The metric's other operations are the JAX
    package's: with the correctly rounded cos both give the same bits."""
    lat = np.float32(np.linspace(-89.9, 89.9, 1799))
    x = np.float32(lat * np.float32(np.pi / 180.))
    exact = np.cos(x.astype(np.float64)).astype(np.float32)
    t = torch.cos(torch.as_tensor(x)).numpy()
    j = np.asarray(jnp.cos(jnp.asarray(x)))
    for v in (t, j):
        ulps = np.abs(v.view(np.int32).astype(np.int64)
                      - exact.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
    assert (t != exact).sum() > 0 and (j != exact).sum() > 0
    k = 3.141592653589793 / 180. * 6360000.
    cr = torch.as_tensor(exact) * k
    jr = jnp.asarray(exact) * k
    np.testing.assert_array_equal(cr.numpy(), np.asarray(jr))


def test_grid_from_numpy_carries_curvilinear():
    """``grid_from_numpy`` carries a JAX curvilinear / tripolar grid
    across field for field (the JAX grid's tile metadata is dropped)."""
    j = jgrid.make_tripolar_grid(24, 18, lat0=-80.)
    d = {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
         for f in dataclasses.fields(j) for v in [getattr(j, f.name)]}
    t = ibp.grid_from_numpy({k: v for k, v in d.items() if v is not None},
                            device=CPU)
    _same_grid(t, j)
    _same_grid(ibp.make_tripolar_grid(24, 18, lat0=-80., device=CPU), j)

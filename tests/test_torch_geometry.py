"""The port's curvilinear geometry (``icebergs_tpu_torch.geometry``)
against ``icebergs_tpu.geometry``, function for function as
``tests/test_geometry.py`` exercises it: the inverse bilinear map, the
point-in-cell boundaries, the local search, the bilinear identity at
corners and the pentagon test, each on the same inputs in both packages;
and the pentagon test on the polar cells of a small tripolar grid.
Booleans and cells must match exactly; ``(xi, yj)`` within 1e-6 (the
quadratic solve's float32 arithmetic is the JAX one term for term, but
XLA:CPU contracts its multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import torch

from icebergs_tpu import geometry as jgeo
from icebergs_tpu.grid import bilin_corner as jbilin
from icebergs_tpu.grid import make_curvilinear_grid as jcurv
from icebergs_tpu.grid import make_tripolar_grid as jtri

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import geometry as tgeo
from icebergs_tpu_torch.grid import bilin_corner as tbilin

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _distorted(nx=6, ny=5):
    """``tests/test_geometry.py``'s smoothly distorted quad grid, in both
    packages."""
    ii, jj = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    lon = ii + 0.25 * np.sin(jj * 0.7)
    lat = jj + 0.2 * np.cos(ii * 0.5) + 20.0
    return jcurv(lon, lat), ibp.make_curvilinear_grid(lon, lat, device=CPU)


def _pair(x, dtype=np.float32):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.as_tensor(x)


def test_calc_xiyj_inverts_forward_bilinear():
    jg, tg = _distorted()
    rng = np.random.RandomState(1)
    ji, ti = _pair(rng.randint(0, 6, 30), np.int32)
    jj, tj = _pair(rng.randint(0, 5, 30), np.int32)
    jxi, txi = _pair(rng.uniform(0.02, 0.98, 30))
    jyj, tyj = _pair(rng.uniform(0.02, 0.98, 30))
    jx = jbilin(jg.lonc, ji, jj, jxi, jyj, False)
    jy = jbilin(jg.latc, ji, jj, jxi, jyj, False)
    tx = tbilin(tg.lonc, ti, tj, txi, tyj, False)
    ty = tbilin(tg.latc, ti, tj, txi, tyj, False)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6)
    for Lx in (-1.0, 360.):
        a = jgeo.pos_within_cell_curvilinear(jg, jx, jy, ji, jj, Lx)
        b = tgeo.pos_within_cell_curvilinear(tg, torch.as_tensor(
            np.array(jx)), torch.as_tensor(np.array(jy)), ti, tj, Lx)
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=1e-6)
        np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), atol=1e-6)
        np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
        assert bool(b[2].all())
        np.testing.assert_allclose(b[0].numpy(), txi.numpy(), atol=1e-2)


def test_calc_xiyj_degenerate_branches():
    """A parallelogram (a == 0: the linear root) and points on the cell
    edges, where the fallback ladder picks xi."""
    x1, x2, x3, x4 = 0., 2., 3., 1.
    y1, y2, y3, y4 = 0., 0., 1., 1.
    px = np.float32([0.5, 1.5, 2.0, 0.0, 3.0, 1.2])
    py = np.float32([0.5, 0.2, 1.0, 0.0, 1.0, 0.0])
    corners = [np.full_like(px, v) for v in (x1, x2, x3, x4, y1, y2, y3,
                                             y4)]
    a = jgeo.calc_xiyj(*map(jnp.asarray, corners), jnp.asarray(px),
                       jnp.asarray(py), -1.)
    b = tgeo.calc_xiyj(*map(torch.as_tensor, corners), torch.as_tensor(px),
                       torch.as_tensor(py), -1.)
    for u, v in zip(b, a):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-6)


def test_is_point_in_cell_boundaries():
    jg, tg = _distorted()
    i, j = np.array([2]), np.array([2])
    half = np.float32([0.5])
    x = tbilin(tg.lonc, torch.as_tensor(i), torch.as_tensor(j),
               torch.as_tensor(half), torch.as_tensor(half), False)
    y = tbilin(tg.latc, torch.as_tensor(i), torch.as_tensor(j),
               torch.as_tensor(half), torch.as_tensor(half), False)
    for di, dj, expect in ((0, 0, True), (1, 0, False), (0, 1, False)):
        t = tgeo.is_point_in_cell(tg, x, y, torch.as_tensor(i + di),
                                  torch.as_tensor(j + dj), -1.0)
        jv = jgeo.is_point_in_cell(jg, jnp.asarray(x.numpy()),
                                   jnp.asarray(y.numpy()),
                                   jnp.asarray(i + di), jnp.asarray(j + dj),
                                   -1.0)
        assert bool(t[0]) == bool(jv[0]) == expect
    # every corner and edge midpoint of a cell, against the JAX tie rules
    rng = np.random.RandomState(3)
    ii = rng.randint(1, 5, 40)
    jj = rng.randint(1, 4, 40)
    xi = np.float32(rng.choice([0., 0.5, 1.], 40))
    yj = np.float32(rng.choice([0., 0.5, 1.], 40))
    x = tbilin(tg.lonc, torch.as_tensor(ii), torch.as_tensor(jj),
               torch.as_tensor(xi), torch.as_tensor(yj), False)
    y = tbilin(tg.latc, torch.as_tensor(ii), torch.as_tensor(jj),
               torch.as_tensor(xi), torch.as_tensor(yj), False)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            t = tgeo.is_point_in_cell(tg, x, y, torch.as_tensor(ii + di),
                                      torch.as_tensor(jj + dj), -1.0)
            jv = jgeo.is_point_in_cell(jg, jnp.asarray(x.numpy()),
                                       jnp.asarray(y.numpy()),
                                       jnp.asarray(ii + di),
                                       jnp.asarray(jj + dj), -1.0)
            np.testing.assert_array_equal(t.numpy(), np.asarray(jv))


def test_find_cell_local():
    jg, tg = _distorted()
    rng = np.random.RandomState(4)
    i = rng.randint(0, 6, 40)
    j = rng.randint(0, 5, 40)
    xi = np.float32(rng.uniform(0.05, 0.95, 40))
    yj = np.float32(rng.uniform(0.05, 0.95, 40))
    x = tbilin(tg.lonc, torch.as_tensor(i), torch.as_tensor(j),
               torch.as_tensor(xi), torch.as_tensor(yj), False)
    y = tbilin(tg.latc, torch.as_tensor(i), torch.as_tensor(j),
               torch.as_tensor(xi), torch.as_tensor(yj), False)
    i0 = np.clip(i + rng.randint(-2, 3, 40), 0, 5)
    j0 = np.clip(j + rng.randint(-2, 3, 40), 0, 4)
    t = tgeo.find_cell_local(tg, x, y, torch.as_tensor(i0),
                             torch.as_tensor(j0), -1.0, radius=2)
    jv = jgeo.find_cell_local(jg, jnp.asarray(x.numpy()),
                              jnp.asarray(y.numpy()), jnp.asarray(i0),
                              jnp.asarray(j0), -1.0, radius=2)
    for a, b in zip(t, jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(t[2].all())
    np.testing.assert_array_equal(t[0].numpy(), i)
    np.testing.assert_array_equal(t[1].numpy(), j)


def test_find_cell_by_search_host():
    jg, tg = _distorted()
    rng = np.random.RandomState(5)
    x = np.float32(rng.uniform(0.3, 5.7, 12))
    y = np.float32(rng.uniform(20.4, 24.6, 12))
    t = tgeo.find_cell_by_search_host(tg, x, y, -1.0)
    jv = jgeo.find_cell_by_search_host(jg, x, y, -1.0)
    for a, b in zip(t, jv):
        np.testing.assert_array_equal(a, b)
    assert t[2].sum() >= 10


def test_bilin_corner_identity():
    jg, tg = _distorted()
    for xy, ij in ((0., (2, 3)), (1., (3, 4))):
        v = tbilin(tg.lonc, torch.as_tensor([2]), torch.as_tensor([3]),
                   torch.as_tensor([xy]), torch.as_tensor([xy]), False)
        assert float(v[0]) == float(tg.lonc[ij])
        assert float(v[0]) == float(jbilin(jg.lonc, jnp.asarray([2]),
                                           jnp.asarray([3]),
                                           jnp.asarray([xy]),
                                           jnp.asarray([xy]), False)[0])


def test_sum_sign_dot_prod5_pentagon():
    th = np.linspace(0, 2 * np.pi, 6)[:-1] + 0.3
    px, py = np.float32(np.cos(th)), np.float32(np.sin(th))
    pts = np.float32([[0.05, -0.02], [1.5, 0.0], [0.0, 0.0], [0.9, 0.1]])
    for x, y in pts:
        jargs, targs = [], []
        for k in range(5):
            jargs += [jnp.asarray([px[k]]), jnp.asarray([py[k]])]
            targs += [torch.as_tensor([px[k]]), torch.as_tensor([py[k]])]
        a = jgeo.sum_sign_dot_prod5(*jargs, jnp.asarray([x]),
                                    jnp.asarray([y]), -1.0)
        b = tgeo.sum_sign_dot_prod5(*targs, torch.as_tensor([x]),
                                    torch.as_tensor([y]), -1.0)
        assert bool(a[0]) == bool(b[0])
    assert bool(tgeo.sum_sign_dot_prod5(
        *targs, torch.as_tensor([0.05]), torch.as_tensor([-0.02]), -1.0)[0])


def test_tripolar_cap_cells():
    """Every cell of the top row of a small tripolar grid (the two polar
    cells among them, degenerate quads that hold no point: the JAX
    builder's note keeps them on land) and of the cap's third row from
    the top, periodic in 360: ``is_point_in_cell`` on points in and
    around each cell, and ``sum_sign_dot_prod5`` on the cell with its
    north edge split at a fifth vertex raised half a cell (the pentagon
    of the polar cells), against the JAX functions."""
    nx, ny = 24, 18
    jg, tg = jtri(nx, ny), ibp.make_tripolar_grid(nx, ny, device=CPU)
    lonc, latc = tg.lonc.numpy(), tg.latc.numpy()
    rng = np.random.RandomState(6)
    hits4 = hits5 = total = 0
    for jp in (ny - 1, ny - 3):
        for ip in range(nx):
            ii = torch.full((32,), ip)
            jj = torch.full((32,), jp)
            xi = torch.as_tensor(np.float32(rng.uniform(-0.5, 1.5, 32)))
            yj = torch.as_tensor(np.float32(rng.uniform(-0.5, 1.5, 32)))
            x = tbilin(tg.lonc, ii, jj, xi, yj, False)
            y = tbilin(tg.latc, ii, jj, xi, yj, False)
            t = tgeo.is_point_in_cell(tg, x, y, ii, jj, 360.)
            jv = jgeo.is_point_in_cell(jg, jnp.asarray(x.numpy()),
                                       jnp.asarray(y.numpy()),
                                       jnp.asarray(ii.numpy()),
                                       jnp.asarray(jj.numpy()), 360.)
            np.testing.assert_array_equal(t.numpy(), np.asarray(jv))
            sw, se = (ip, jp), (ip + 1, jp)
            ne, nw = (ip + 1, jp + 1), (ip, jp + 1)
            top = (0.5 * (lonc[ne] + lonc[nw]),
                   0.5 * (latc[ne] + latc[nw])
                   + 0.5 * (latc[nw] - latc[sw]))
            jargs, targs = [], []
            for cxk, cyk in [(lonc[sw], latc[sw]), (lonc[se], latc[se]),
                             (lonc[ne], latc[ne]), top,
                             (lonc[nw], latc[nw])]:
                v = np.full(32, cxk, np.float32), np.full(32, cyk,
                                                          np.float32)
                jargs += [jnp.asarray(v[0]), jnp.asarray(v[1])]
                targs += [torch.as_tensor(v[0]), torch.as_tensor(v[1])]
            a = jgeo.sum_sign_dot_prod5(*jargs, jnp.asarray(x.numpy()),
                                        jnp.asarray(y.numpy()), 360.)
            b = tgeo.sum_sign_dot_prod5(*targs, x, y, 360.)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            hits4 += int(t.sum())
            hits5 += int(b.sum())
            total += 32
    assert 0 < hits4 < total and 0 < hits5 < total

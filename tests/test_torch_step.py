"""The port's coupling step against the JAX package: the table
interpolation, the Verlet step with its land-bounce walk, the basal-melt
solve, and the whole persistent fast-lane step (4 steps, without and with
contacts) on the clustered world of ``tests/test_fused_contact.py``.

Tolerance (floats, per berg id): ``rtol 1e-5`` plus 2e-5 of each field's
largest magnitude.  XLA:CPU contracts multiply-adds into FMAs (the
bilinear interpolation already differs by 1 ulp on about a quarter of
the bergs at step 1), and torch and XLA round sin / cos / pow
differently; over 4 steps the contact springs amplify those ulps through
``crit - r``.  Integers, permutations and counters must match exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import dynamics as jdyn
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.model import make_persistent_multi_step as jax_multi
from icebergs_tpu.ops import pallas_interp as jinterp
from icebergs_tpu.ops import thermo as jthermo
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import dynamics as tdyn
from icebergs_tpu_torch.diag import berg_chksum
from icebergs_tpu_torch.ops import interp_table as tinterp
from icebergs_tpu_torch.ops import thermo as tthermo

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


@functools.lru_cache(maxsize=None)
def _world():
    """``_world(300, seed=11, cluster=True)`` of test_fused_contact.py
    (16x16 grid of 1 km cells, a dense knot) under the fast-lane config
    of bench.py (Verlet, f-plane, contacts, melt, rolling, table interp,
    pallas spreading), with the benchmark's swirl forcing and a strip of
    land so the walk bounces."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0,
                             use_f_plane=True, lat_ref=30., dt=600.,
                             Runge_not_Verlet=False,
                             interactive_icebergs_on=True,
                             use_new_predictive_corrective=True)
    msk = np.ones((16, 16))
    msk[12:, :] = 0.
    grid = ibt.make_uniform_grid(16, 16, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, msk=msk)
    frc = ibt.swirl_forcing(16, 16, 1000., uo=0.3, ua=5.0, sst=4.0,
                            sss=33.0)
    n = 300
    rng = np.random.RandomState(11)
    lon = rng.uniform(4e3, 12e3, n)
    lat = rng.uniform(4e3, 12e3, n)
    k = n // 4
    lon[:k] = 7.5e3 + rng.uniform(-120., 120., k)
    lat[:k] = 7.5e3 + rng.uniform(-120., 120., k)
    lon[k:k + 20] = 11.9e3                  # against the land strip
    st = ibt.create_bergs(512, lon=lon, lat=lat,
                          uvel=rng.uniform(-.3, .3, n),
                          vvel=rng.uniform(-.3, .3, n),
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.,
                          id_cnt=np.arange(n) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    port = (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU))
    return cfg, grid, frc, st, port


def assert_state_close(t_st, j_st, fields=None):
    """Per berg id: integers exact, floats within the stated tolerance."""
    T, J = ibp.to_numpy(t_st), _leaves(j_st)
    np.testing.assert_array_equal(T["alive"], J["alive"])
    live = J["alive"]
    for name in fields or T:
        t, j = T[name], J[name]
        if t.dtype.kind != "f":
            np.testing.assert_array_equal(t[live], j[live], err_msg=name)
            continue
        t, j = t[live], j[live]
        scale = max(float(np.abs(j).max()), 1e-30)
        np.testing.assert_allclose(t, j, rtol=RTOL,
                                   atol=ATOL_SCALE * scale, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_interp():
    cfg, grid, frc, _, _ = _world()
    return jax.jit(lambda s: jinterp.interp_to_bergs_table(s, grid, frc,
                                                           cfg))


def test_interp_table_matches_jax():
    """Slot table and walk anchors bitwise; the per-berg environment
    within 1 ulp-level tolerance (XLA fuses the bilinear terms)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    js, _ = jax_sort(st, grid)
    np.testing.assert_array_equal(
        tinterp.interp_cell_table(tgrid, tfrc, tcfg).numpy(),
        np.asarray(jax.jit(lambda: jinterp.interp_cell_table(
            grid, frc, cfg))()))
    j2, (jm25, jm81) = _jax_interp()(js)
    t2, (tm25, tm81) = tinterp.interp_to_bergs_table(
        ibp.state_from_numpy(_leaves(js), device=CPU), tgrid, tfrc, tcfg)
    np.testing.assert_array_equal(tm25.numpy(), np.asarray(jm25))
    np.testing.assert_array_equal(tm81.numpy(), np.asarray(jm81))
    assert_state_close(t2, j2, ("uo", "vo", "ui", "vi", "ua", "va",
                                "ssh_x", "ssh_y", "sst", "sss", "cn", "hi",
                                "od"))


@pytest.mark.parametrize("anchors", ["table", "grid"])
def test_verlet_walk_matches_jax(anchors):
    """accel + Verlet + the land-bounce walk on the same environment,
    with the table's 9x9 anchor rows or (``with_interp=False``) without
    them: the JAX package then walks on 5x5 anchors, the port gathers
    the 9x9 rows from the grid."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    js, _ = jax_sort(st, grid)
    js, (m25, m81) = _jax_interp()(js)
    pre = (m25, m81) if anchors == "table" else None
    jout = jax.jit(lambda s, m: jdyn.evolve_icebergs(
        s, grid, frc, cfg, m25_pre=m))(js, pre)
    tst = ibp.state_from_numpy(_leaves(js), device=CPU)
    tout = tdyn.evolve_icebergs(
        tst, tgrid, tfrc, tcfg,
        m25_pre=None if pre is None else (torch.as_tensor(np.array(m25)),
                                          torch.as_tensor(np.array(m81))))
    assert_state_close(tout.state, jout.state)
    assert int(tout.bounced) == int(jout.bounced) > 0
    assert int(tout.tickets) == int(jout.tickets)


def test_walk_compaction_is_bitwise():
    """The mover-compacted walk equals the dense walk bit for bit."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    tst, (_, m81) = tinterp.interp_to_bergs_table(tst, tgrid, tfrc, tcfg)
    rng = np.random.RandomState(2)
    lon = tst.lon + torch.as_tensor(rng.uniform(-2500, 2500, tst.capacity),
                                    dtype=torch.float32)
    lat = tst.lat + torch.as_tensor(rng.uniform(-2500, 2500, tst.capacity),
                                    dtype=torch.float32)
    fx, fy = tdyn._frac_coords(tgrid, lon, lat)
    args = (tgrid, lon, lat, tst.ine, tst.jne, fx, fy, m81)
    dense = tdyn._walk4(*args)
    compact = tdyn._walk4_compact(*args)
    assert int(dense[-1].sum()) > 0
    for d, c in zip(dense, compact):
        assert torch.equal(d, c)


def test_thermodynamics_matches_jax():
    """Deferred melt columns and the updated state after the sort and
    the interpolation.  The melt laws use pow / cos / sqrt, which round
    differently in XLA:CPU and torch: floats within the file's
    tolerance."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    js, _ = jax_sort(st, grid)
    js, _ = _jax_interp()(js)
    js = js.replace(mass_of_bits=js.mass * 1e-3)
    jst, jm = jthermo.thermodynamics(js, grid, frc, cfg,
                                     defer_cell_cols=True)
    tst, tm = tthermo.thermodynamics(
        ibp.state_from_numpy(_leaves(js), device=CPU), tgrid, tfrc, tcfg)
    assert len(tm.deferred_cols) == len(jm.deferred_cols) == 14
    live = np.asarray(js.alive)
    for t, j in zip(tm.deferred_cols, jm.deferred_cols):
        j = np.asarray(j)[live]
        np.testing.assert_allclose(t.numpy()[live], j, rtol=RTOL,
                                   atol=ATOL_SCALE * max(np.abs(j).max(),
                                                         1e-30))
    assert_state_close(tst, jst)
    assert int(tm.nbergs_melted) == int(jm.nbergs_melted)


@pytest.mark.parametrize("three_eq", [True, False])
def test_find_basal_melt_matches_jax(three_eq):
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, use_f_plane=True,
                             lat_ref=-70., const_gamma=False)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.RandomState(4)
    n = 64
    args = [rng.uniform(0., .5, n), rng.uniform(-70, -60, n),
            rng.uniform(33., 35., n), rng.uniform(-1.5, 4., n),
            rng.uniform(50., 400., n)]
    args = [a.astype(np.float32) for a in args]
    j = jthermo.find_basal_melt(cfg, *map(jnp.asarray, args), three_eq)
    t = tthermo.find_basal_melt(tcfg, *map(torch.as_tensor, args), three_eq)
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                               atol=1e-5 * np.abs(j).max())


@functools.lru_cache(maxsize=None)
def _jax_slice(with_ia):
    cfg, grid, frc, st, _ = _world()
    return jax_multi(grid, cfg, 4, True, with_ia=with_ia,
                     fused_block_n=16, fused_fallback_strip_width=128)(
        st, frc)


@pytest.mark.parametrize("with_ia", [False, True])
def test_persistent_step_matches_jax(with_ia):
    """4 fast-lane steps.  Block size 16 (the world's 16-column grid
    makes 128-row blocks span too many cells, so every berg would take
    the fallback); strip width 128 covers the knot."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    jst, jov, jfb, jacc = _jax_slice(with_ia)
    multi = ibp.make_persistent_multi_step(
        tgrid, tcfg, 4, True, with_ia=with_ia, fused_block_n=16,
        fused_fallback_strip_width=128)
    tst, tov, tfb, tacc = multi(
        ibp.state_from_numpy(_leaves(st), device=CPU), tfrc)
    assert int(tov) == int(jov) == 0
    assert int(tfb) == int(jfb)
    if with_ia:
        assert 0 < int(tfb) < 300
    assert_state_close(tst, jst)
    jacc = np.asarray(jacc)
    np.testing.assert_allclose(tacc.numpy(), jacc, rtol=0,
                               atol=ATOL_SCALE * np.abs(jacc).max())
    key = np.where(ibp.to_numpy(tst)["alive"],
                   tst.jne.numpy() * 16 + tst.ine.numpy(), 256)
    assert np.all(np.diff(key) >= 0), "the returned slab is cell-sorted"
    total, n = berg_chksum(tst)
    assert int(n) == 300

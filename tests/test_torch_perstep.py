"""Whole coupling steps of the per-step path and of the persistent lane's
``fused`` / kernel-interpolation variant against the JAX package.

The clustered world of ``tests/test_torch_step.py`` (300 bergs on a
16x16 grid, a dense knot, a land strip, swirl forcing) runs 4 steps of
``make_multi_step(persistent=False)`` with the ``fused3``, ``fused`` and
``buckets`` neighbour modes (the port's buckets evaluate through K7, the
JAX package's through its XLA twin, since its kernel has no interpret
flag there), and 4 steps of ``make_persistent_multi_step`` with
``neighbor_mode="fused"`` and ``interp_mode="kernel"`` (K5 and K6).
Compared per berg id: ``alive``, ``ine``, ``jne`` and the overflow and
fallback counters exact, floats within ``rtol 1e-5`` plus 2e-5 of each
field's scale (the tolerance of ``tests/test_torch_step.py``: XLA:CPU
contracts multiply-adds and the contact springs amplify those ulps).
The port's ``fused`` (K5) and ``fused3`` (K2) steps agree bit for bit,
as the JAX package's ``_check_v3`` asserts of its two closures.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import model as jmodel
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell

import icebergs_tpu_torch as ibp

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5
KW = dict(fused_block_n=16, fused_fallback_strip_width=128)
MODES = {"fused3": {}, "fused": {},
         "buckets": dict(max_per_cell=80)}   # the knot holds 75 bergs


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


@functools.lru_cache(maxsize=None)
def _world():
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
    lon[k:k + 20] = 11.9e3
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
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))
    return cfg, grid, frc, st, port


def _by_id(d):
    """Alive rows of every per-berg leaf, ordered by id."""
    alive = d["alive"]
    order = np.lexsort((d["id_ij"][alive], d["id_cnt"][alive]))
    return {k: v[alive][order] for k, v in d.items()
            if isinstance(v, np.ndarray) and v.shape[:1] == alive.shape}


def assert_steps_close(t_out, j_out):
    (tst, tov, tfb, tacc), (jst, jov, jfb, jacc) = t_out, j_out
    assert (int(tov), int(tfb)) == (int(jov), int(jfb))
    T, J = ibp.to_numpy(tst), _leaves(jst)
    assert int(T["alive"].sum()) == int(J["alive"].sum())
    T, J = _by_id(T), _by_id(J)
    for name, t in T.items():
        j = J[name]
        if t.dtype.kind != "f":
            np.testing.assert_array_equal(t, j, err_msg=name)
            continue
        scale = max(float(np.abs(j).max()), 1e-30) if j.size else 1.
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL_SCALE * scale,
                                   err_msg=name)
    jacc = np.asarray(jacc)
    np.testing.assert_allclose(tacc.numpy(), jacc, rtol=0,
                               atol=ATOL_SCALE * np.abs(jacc).max())


@functools.lru_cache(maxsize=None)
def _port_perstep(mode):
    _, _, _, _, (tcfg, tgrid, tfrc, tst) = _world()
    return ibp.make_multi_step(tgrid, tcfg, 4, True, persistent=False,
                               neighbor_mode=mode, **KW,
                               **MODES[mode])(tst, tfrc)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_perstep_matches_jax(mode):
    cfg, grid, frc, st, _ = _world()
    jout = jmodel.make_multi_step(grid, cfg, 4, True, persistent=False,
                                  neighbor_mode=mode, fused_interpret=True,
                                  **KW, **MODES[mode])(st, frc)
    tout = _port_perstep(mode)
    assert int(tout[1]) == 0
    if mode != "buckets":
        assert 0 < int(tout[2]) < 300
    assert_steps_close(tout, jout)


def test_perstep_fused_equals_fused3():
    a, b = _port_perstep("fused"), _port_perstep("fused3")
    for x, y in zip(a[1:3], b[1:3]):
        assert int(x) == int(y)
    A, B = ibp.to_numpy(a[0]), ibp.to_numpy(b[0])
    for name in A:
        np.testing.assert_array_equal(A[name], B[name], err_msg=name)
    assert torch.equal(a[3], b[3])


def test_persistent_fused_kernel_interp_matches_jax():
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _world()
    kcfg = cfg.replace(interp_mode="kernel")
    jout = jax.jit(jmodel.make_persistent_multi_step(
        grid, kcfg, 4, True, neighbor_mode="fused", fused_interpret=True,
        **KW))(st, frc)
    tout = ibp.make_persistent_multi_step(
        tgrid, tcfg.replace(interp_mode="kernel"), 4, True,
        neighbor_mode="fused", **KW)(tst, tfrc)
    assert int(tout[1]) == 0 and 0 < int(tout[2]) < 300
    assert_steps_close(tout, jout)
    key = np.where(ibp.to_numpy(tout[0])["alive"],
                   tout[0].jne.numpy() * 16 + tout[0].ine.numpy(), 256)
    assert np.all(np.diff(key) >= 0), "the returned slab is cell-sorted"

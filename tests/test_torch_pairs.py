"""K7 and the bucket search against the JAX package.

* K7's plain version (``forces.eval_pair_ia``, which
  ``pairs.eval_pair_ia_kernel`` runs for CPU tensors) against
  ``eval_pair_ia_pallas`` in interpret mode on the same pair slabs (the
  world's bucket tables, and synthetic slabs with every pair active),
  with the pmag scaling on and off: ``rtol 1e-5`` (the JAX package's own
  kernel tolerance, ``tests/test_pallas_pairs.py``; the interpret-mode
  body contracts multiply-adds and sums in another order).
* ``bin_bergs`` and ``build_neighbor_tables`` (full and quadrant
  windows): exact.
* The port's ``make_ia_fn`` (every group through K7's wrapper) against
  the JAX package's ``make_ia_fn(use_pallas=False)`` (the JAX one passes
  no interpret flag to its kernel, so it cannot run the kernel on the
  CPU), without and
  with the ``contact_cap`` compaction: per berg within ``rtol 1e-5``
  plus 2e-5 of each field's scale, the tolerance of
  ``tests/test_torch_step.py`` (XLA:CPU fuses the pair geometry's
  multiply-adds, and ``crit - r`` amplifies that ulp).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.ops.pallas_pairs import eval_pair_ia_pallas

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import forces as tforces
from icebergs_tpu_torch.ops.pairs import eval_pair_ia_kernel

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5
IA_FIELDS = ("IA_x", "IA_y", "P11", "P12", "P22", "Pu_x", "Pu_y")


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


@functools.lru_cache(maxsize=None)
def _world(pmag=True):
    """A 16x16 grid of 1 km cells with 400 bergs, a quarter of them in a
    dense knot; partners' old positions and velocities set, bergs moving
    so that the damping terms are live."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1., use_f_plane=True,
                             interactive_icebergs_on=True, dt=60.,
                             Runge_not_Verlet=False,
                             scale_damping_by_pmag=pmag)
    grid = ibt.make_uniform_grid(16, 16, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    rng = np.random.RandomState(3)
    n = 400
    lon = rng.uniform(2000., 14000., n)
    lat = rng.uniform(2000., 14000., n)
    lon[:100] = 7.5e3 + rng.uniform(-120., 120., 100)
    lat[:100] = 7.5e3 + rng.uniform(-120., 120., 100)
    st = ibt.create_bergs(512, lon=lon, lat=lat,
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.,
                          uvel=rng.randn(n) * 0.1, vvel=rng.randn(n) * 0.1,
                          id_cnt=np.arange(n) + 1)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, lon_old=st.lon,
                    lat_old=st.lat, uvel_old=st.uvel, vvel_old=st.vvel)
    port = (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))
    return cfg, grid, st, port


def _velocities(st):
    return st.uvel, st.vvel, st.uvel + 0.05, st.vvel - 0.02


def _assert_ia_close(t, j, alive, rtol=RTOL, atol_scale=ATOL_SCALE):
    for f in IA_FIELDS:
        a = getattr(t, f).numpy()[alive]
        b = np.asarray(getattr(j, f))[alive]
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_scale * scale,
                                   err_msg=f)


def _dense_pairs(n=512, m=216, seed=5):
    """(n, m) pair slabs with every candidate slot valid and active, all
    finite: projections of random unit normals, positive damping
    coefficients, partner velocities; and (n,) velocities."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(0., 2 * np.pi, (n, m))
    nx, ny = np.cos(th), np.sin(th)

    def f32(x):
        return np.asarray(x, np.float32)
    pd = jforces.PairData(
        active=np.ones((n, m), bool), IA_x=f32(rng.randn(n)),
        IA_y=f32(rng.randn(n)), P11=f32(nx * nx), P12=f32(nx * ny),
        P22=f32(ny * ny), crad=f32(rng.uniform(1e-3, 1e-2, (n, m))),
        ctan=f32(rng.uniform(1e-4, 1e-3, (n, m))),
        u2=f32(rng.randn(n, m) * 0.2), v2=f32(rng.randn(n, m) * 0.2))
    vel = [f32(rng.randn(n) * 0.2) for _ in range(4)]
    return pd, vel


@pytest.mark.parametrize("pmag,mask", [
    pytest.param(True, "engaged", id="True"),
    pytest.param(False, "engaged", id="False"),
    pytest.param(True, "all", id="True-all"),
    pytest.param(False, "all", id="False-all")])
def test_pair_eval_plain_matches_pallas(pmag, mask):
    """The same (N, M) pair data through both evaluations: the bucket
    tables of the world (its engaged pairs active) and, the dense regime,
    synthetic slabs with every pair active.  There each row sums 216
    signed terms in two orders, whose difference is bounded by ulps of
    the row's sum of magnitudes, not of its sum: ``atol`` is 1e-6 of each
    field's scale (the tolerance ``chip_smoke.py`` states for K7)."""
    cfg, grid, st, (tcfg, _, _) = _world(pmag)
    atol_scale = 0.
    if mask == "all":
        pd, vel = _dense_pairs()
        alive = np.ones(pd.P11.shape[0], bool)
        atol_scale = 1e-6
    else:
        nbr = jforces.build_neighbor_tables(st, grid, cfg, max_per_cell=120)
        pd = jforces.precompute_pair_data(st, cfg, nbr.cand_idx,
                                          nbr.cand_valid, bonded=False,
                                          use_c_crit_dist=False)
        vel = _velocities(st)
        alive = np.asarray(st.alive)
        assert int(np.asarray(pd.active).sum()) > 100
    ref = eval_pair_ia_pallas(pd, cfg, *vel, interpret=True)
    tpd = tforces.PairData(*(torch.as_tensor(np.array(x)) for x in pd
                             if x is not None))
    got = eval_pair_ia_kernel(tpd, tcfg,
                              *(torch.as_tensor(np.array(v)) for v in vel))
    for f in IA_FIELDS:
        b = np.asarray(getattr(ref, f))[alive]
        np.testing.assert_allclose(
            getattr(got, f).numpy()[alive], b, rtol=1e-5,
            atol=max(1e-10, atol_scale * float(np.abs(b).max())), err_msg=f)
    np.testing.assert_array_equal(got.IA_x.numpy(), np.asarray(ref.IA_x))


@pytest.mark.parametrize("window", ["full", "quadrant"])
def test_neighbor_tables_match_jax(window):
    cfg, grid, st, (tcfg, tgrid, tst) = _world()
    jb, jc = jforces.bin_bergs(st, grid, cfg, 32)
    tb, tc = tforces.bin_bergs(tst, tgrid, tcfg, 32)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc[:-1].max()) == 32, "the knot overflows its bucket"
    jn = jforces.build_neighbor_tables(st, grid, cfg, max_per_cell=32,
                                       window=window)
    tn = tforces.build_neighbor_tables(tst, tgrid, tcfg, max_per_cell=32,
                                       window=window)
    for f in jn._fields:
        np.testing.assert_array_equal(getattr(tn, f).numpy(),
                                      np.asarray(getattr(jn, f)), err_msg=f)


@pytest.mark.parametrize("contact_cap", [None, 120])
def test_make_ia_fn_matches_jax(contact_cap):
    """The bucket-table closure; with a cap below the engaged count the
    port reports the dropped bergs, which the JAX package drops
    uncounted."""
    cfg, grid, st, (tcfg, tgrid, tst) = _world()
    jn = jforces.build_neighbor_tables(st, grid, cfg, max_per_cell=120)
    vel = _velocities(st)
    ref = jax.jit(lambda s, n, *v: jforces.make_ia_fn(
        s, n, cfg, use_pallas=False, contact_cap=contact_cap)(*v[2:]))(
        st, jn, *vel)
    tn = tforces.build_neighbor_tables(tst, tgrid, tcfg, max_per_cell=120)
    ia_fn = tforces.make_ia_fn(tst, tn, tcfg, contact_cap=contact_cap)
    got = ia_fn(*(torch.as_tensor(np.array(v)) for v in vel[2:]))
    _assert_ia_close(got, ref, np.asarray(st.alive))
    want = tforces.active_contact_bergs(tst, tcfg, tn.cand_idx,
                                        tn.cand_valid)
    assert int(want.sum()) > 100
    if contact_cap is None:
        assert ia_fn.overflow is None
    else:
        assert int(ia_fn.overflow) == int(want.sum()) - contact_cap

"""The port's calving against the JAX package: the running mean, the
bucket accumulation with both hemispheres' class tables, the spawn from
full buckets (slots, ids, counters and the buckets' bookkeeping exact, the
newborns' fields bitwise but the interpolated environment), the
prefix-sum allocator and the slab's growth.

Tolerance (floats that the two packages reduce in another order or
interpolate, XLA:CPU contracting multiply-adds): ``rtol 1e-5`` plus 1e-5
of the field's largest magnitude.  Integers, slots and counters exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import calving as jcv
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.state import allocate_slots as jax_allocate
from icebergs_tpu.state import grow_capacity as jax_grow

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import calving as tcv
from icebergs_tpu_torch.state import allocate_slots, grow_capacity

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 1e-5
INTS = ("alive", "id_cnt", "id_ij", "ine", "jne", "start_year",
        "conglom_id", "bond_idx", "bond_broken")


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _close(a, b, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if b.size else 0.
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=name)


def _world(cap=512, n_live=200, seed=0, north=False):
    """A 12x10 Cartesian grid of 2 km cells whose centers straddle y = 0
    (the south class tables below, the north ones above), a land column,
    a slab with dead slots scattered through it, and buckets primed so
    that most (cell, class) pairs spawn 0, 1 or 2 bergs."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1., dt=3600.,
                             separate_distrib_for_n_hemisphere=north)
    msk = np.ones((12, 10))
    msk[5, :] = 0.
    grid = ibt.make_uniform_grid(12, 10, 0., -9e3, 2000., 2000.,
                                 grid_is_latlon=False, msk=msk)
    frc = ibt.uniform_forcing(12, 10, uo=0.1, sst=2., sss=34.)
    rng = np.random.RandomState(seed)
    lon = rng.uniform(1e3, 23e3, n_live)
    lat = rng.uniform(-8e3, 10e3, n_live)
    st = ibt.create_bergs(cap, lon=lon, lat=lat, mass=1e9, thickness=50.,
                          width=100., length=150., fl_spawn_count=3.,
                          id_cnt=np.arange(n_live) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    alive = np.asarray(st.alive).copy()
    alive[rng.permutation(n_live)[:n_live // 4]] = False
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, alive=jnp.asarray(alive))
    calv = jcv.init_calving_state(grid)
    s, n = jcv._class_tables(cfg)
    south = np.asarray(grid.lat_center) < 0.
    cap_k = np.where(south[..., None], s["mass"] * s["scal"],
                     n["mass"] * n["scal"])
    stored = cap_k * rng.uniform(0., 2.6, cap_k.shape)
    calv = calv.replace(
        stored_ice=jnp.asarray(stored, jnp.float32),
        stored_heat=jnp.asarray(stored.sum(-1) * rng.uniform(
            1e3, 1e4, south.shape), jnp.float32),
        id_counter=jnp.asarray(rng.randint(0, 50, south.shape), jnp.int32))
    return cfg, grid, frc, st, calv


def _to_torch(cfg, grid, frc, st, calv):
    return (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU),
            tcv.CalvingState(**{k: torch.as_tensor(np.array(v)) for k, v
                                in _leaves(calv).items()}))


def test_running_mean_matches_jax():
    cfg, grid, frc, st, calv = _world()
    cfg = cfg.replace(tau_calving=0.5)
    tcfg, _, _, _, tcalv = _to_torch(cfg, grid, frc, st, calv)
    rng = np.random.RandomState(3)
    for k in range(3):
        c = rng.uniform(0., 1e6, (14, 12)).astype(np.float32)
        h = rng.uniform(0., 50., (14, 12)).astype(np.float32)
        calv, jc, jh = jcv.get_running_mean_calving(calv, jnp.asarray(c),
                                                    jnp.asarray(h), cfg)
        tcalv, tc, th = tcv.get_running_mean_calving(
            tcalv, torch.as_tensor(c), torch.as_tensor(h), tcfg)
        # elementwise in float32 with the same weights: bitwise
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert bool(tcalv.rmean_init) == bool(calv.rmean_init)


@pytest.mark.parametrize("north", [False, True], ids=["one_table",
                                                      "two_hemispheres"])
def test_accumulate_calving_matches_jax(north):
    cfg, grid, frc, st, calv = _world(north=north)
    tcfg, tgrid, _, _, tcalv = _to_torch(cfg, grid, frc, st, calv)
    rng = np.random.RandomState(4)
    c = rng.uniform(0., 5e6, (14, 12)).astype(np.float32)
    h = rng.uniform(0., 80., (14, 12)).astype(np.float32)
    jout = jcv.accumulate_calving(calv, grid, jnp.asarray(c),
                                  jnp.asarray(h), cfg)
    tout = tcv.accumulate_calving(tcalv, tgrid, torch.as_tensor(c),
                                  torch.as_tensor(h), tcfg)
    np.testing.assert_array_equal(tout[0].stored_ice.numpy(),
                                  np.asarray(jout[0].stored_ice))
    np.testing.assert_array_equal(tout[0].stored_heat.numpy(),
                                  np.asarray(jout[0].stored_heat))
    for k in (1, 2):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    for k in (3, 4):      # the sums: another order of the same terms
        _close(float(tout[k]), float(jout[k]), f"sum {k}")
    if north:
        s, n = jcv._class_tables(cfg)
        assert not np.array_equal(s["dist"], n["dist"])


@pytest.mark.parametrize("cap,n_live", [(2048, 200), (600, 200)],
                         ids=["room", "overflow"])
@pytest.mark.parametrize("north", [False, True])
def test_calve_icebergs_matches_jax(cap, n_live, north):
    """The spawn: slots, ids, cells, counters and the bucket state exact;
    the newborns' fields bitwise; the interpolated environment within
    the tolerance.  With 600 slots the requests outnumber the dead slots
    and ``spawn_overflow`` counts the rest."""
    cfg, grid, frc, st, calv = _world(cap, n_live, north=north)
    tcfg, tgrid, tfrc, tst, tcalv = _to_torch(cfg, grid, frc, st, calv)
    js, jc, jd = jcv.calve_icebergs(st, calv, grid, frc, cfg,
                                    current_year=2001,
                                    current_yearday=jnp.float32(33.5))
    ts, tc, td = tcv.calve_icebergs(tst, tcalv, tgrid, tfrc, tcfg,
                                    current_year=2001,
                                    current_yearday=torch.tensor(33.5))
    for k in ("nbergs_calved", "spawn_overflow"):
        assert int(td[k]) == int(jd[k]), k
    assert int(td["nbergs_calved"]) > 20
    if cap == 600:
        assert int(td["spawn_overflow"]) > 0
        assert not bool((~ts.alive).any())
    else:
        assert int(td["spawn_overflow"]) == 0
    J, T = _leaves(js), ibp.to_numpy(ts)
    env = ("uo", "vo", "ui", "vi", "ua", "va", "ssh_x", "ssh_y", "sst",
           "sss", "cn", "hi", "od")
    for name, t in T.items():
        if name in INTS or name not in env:
            np.testing.assert_array_equal(t, J[name], err_msg=name)
        else:
            _close(t, J[name], name)
    np.testing.assert_array_equal(tc.stored_ice.numpy(),
                                  np.asarray(jc.stored_ice))
    np.testing.assert_array_equal(tc.id_counter.numpy(),
                                  np.asarray(jc.id_counter))
    np.testing.assert_array_equal(td["real_calving"].numpy(),
                                  np.asarray(jd["real_calving"]))
    np.testing.assert_array_equal(tc.stored_heat.numpy(),
                                  np.asarray(jc.stored_heat))
    for k in ("calving_to_bergs", "heat_to_bergs"):
        _close(float(td[k]), float(jd[k]), k)


def test_allocate_slots_matches_jax():
    rng = np.random.RandomState(5)
    for n, nreq in ((64, 40), (64, 200), (1000, 333)):
        alive = rng.uniform(size=n) < 0.7
        want = rng.uniform(size=nreq) < 0.4
        jg, js = jax_allocate(jnp.asarray(alive), jnp.asarray(want))
        tg, ts = allocate_slots(torch.as_tensor(alive), torch.as_tensor(want))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert ts.dtype == torch.int32


def test_grow_capacity_matches_jax():
    _, _, _, st, _ = _world(cap=64, n_live=40)
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    J, T = _leaves(jax_grow(st, 100)), ibp.to_numpy(grow_capacity(tst, 100))
    for name, t in T.items():
        np.testing.assert_array_equal(t, J[name], err_msg=name)
    assert grow_capacity(tst, 64) is tst
    with pytest.raises(ValueError):
        grow_capacity(tst, 10)

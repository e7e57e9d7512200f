"""The port's tiled coupled run (``make_sharded_run``) on the worlds of
``tests/test_sharded_run.py``: the whole icebergs_run sequence
(calving spawn, footloose, thermodynamics, spreading, icebergs.F90:
5389-5679) on every tile, then the particle exchange.

Tiled against untiled ``IcebergsModel.run``, bit for bit: the owned
bergs by id (ids, positions, velocities, masses and every other field
but the tile-local cell indices) on 2 and 4 tiles of the calving world (buckets
filling in two cells of different tiles and spawning with global ids),
4 tiles of the footloose world (a tabular berg shedding a child: the
draws are id-derived), 4 tiles of the colliding world with ``fused3``
(the fallback group reached, no contact overflow) and a 2x2 layout of the
2-D colliding world; the budgets and the interval scalars within 1e-6
(the tiles' sums are added in another order), the spawn counts exact,
every exchange counter 0 (the mid-step halo refreshes' too).

Against the JAX package's ``make_sharded_run`` on the CPU mesh (one JAX
run for the module): 4 tiles of the calving world, the spawn and
exchange counters and the owned bergs' ids exact, their floats within
``rtol 1e-5`` plus 2e-5 of each field's scale (the tolerance of
``tests/test_torch_api.py``), the budgets within 1e-6 and the melt,
which counts the halo copies' melt on every tile in both packages,
within that file's 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import icebergs_tpu as ibt
from icebergs_tpu.parallel import domain as jdd
from icebergs_tpu.state import empty_state as jax_empty_state

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.parallel import domain as dd

import torch_parallel_worlds as W

torch.set_num_threads(1)
RTOL, ATOL_SCALE = 1e-5, 2e-5
CALVING_STEPS = 12
_COUNTS = ("nbergs", "nbergs_calved", "spawn_overflow", "contact_overflow")
# the bucket scalars (owned cells only); the melt scalars also count the
# halo copies' melt on every tile, as the JAX package's do, so they are
# held against the JAX package's tiled run instead
_SCALARS = ("net_calving_used", "calving_to_bergs", "heat_used",
            "heat_to_bergs")


def _footloose():
    cfg, grid, frc = W.world(W.FOOTLOOSE, dict(uo=0.0, ua=10.0, sst=2.0,
                                               sss=33.))
    st = W.bergs(grid, [14. * W.DXY + 900.], [4. * W.DXY], thickness=250.,
                 width=8000., length=9000., mass=850. * 250 * 8000. * 9000.)
    return cfg, grid, frc, st, dict(seed=7), {}


def _calving():
    cfg, grid, frc = W.world(W.CALVING, dict(uo=0.2, sst=1.0))
    st = ibp.empty_state(96, device=W.CPU)
    return cfg, grid, frc, st, dict(seed=3, calving=W.calving_field()), {}


def _fused3():
    cfg, grid, frc = W.world(W.INTERACTIVE, dict(uo=0.4, sst=2.0))
    return (cfg, grid, frc, W.bergs(grid, *W.pair_positions()),
            dict(seed=7), W.FUSED3_RUN)


def _fused3_2d():
    cfg, grid, frc = W.world(W.INTERACTIVE, dict(uo=0.3, vo=0.2, sst=2.0),
                             W.NX2, W.NY2, W.DXY2)
    return (cfg, grid, frc, W.bergs(grid, *W.pair_positions_2d()),
            dict(seed=5), W.FUSED3_RUN)


CASES = {  # world, steps, tile capacity
    "calving": (_calving, CALVING_STEPS, 48),
    "footloose": (_footloose, 24, 32),
    "fused3": (_fused3, 10, 32),
    "fused3_2d": (_fused3_2d, 8, 32),
}


@pytest.mark.parametrize("case,layout", [
    ("calving", (2,)), ("calving", (4,)), ("footloose", (4,)),
    ("fused3", (4,)), ("fused3_2d", (2, 2))])
def test_tiled_run_matches_untiled(case, layout):
    make, nsteps, cap = CASES[case]
    cfg, grid, frc, st, kw, run_kw = make()
    geo = (dict(nx=W.NX2, ny=W.NY2, dxy=W.DXY2) if case == "fused3_2d"
           else {})
    s1, outs1 = W.untiled_run(cfg, grid, frc, st, nsteps, **kw,
                              neighbor_mode=run_kw.get("neighbor_mode"),
                              fused_kw=run_kw.get("fused_kw"))
    halo = case.startswith("fused3")
    ms, outs, ovs = W.tiled_run(cfg, frc, st, layout, nsteps, cap=cap,
                                halo_fill=halo, **kw, **geo, **run_kw)
    assert all(int(o.max()) == 0 for o in ovs)
    # each axis: 4 passes of the exchange, and 2 of each mid-step halo
    # refresh (after the spawn, after the footloose children: with
    # contacts on)
    refreshes = cfg.interactive_icebergs_on * (1 + cfg.footloose)
    assert ovs[0].shape[1:] == (len(layout) * (4 + 2 * refreshes), 2)
    for o, o1 in zip(outs, outs1):
        for f in _COUNTS:
            assert int(getattr(o, f)) == int(getattr(o1, f)), f
        for f in _SCALARS:
            np.testing.assert_allclose(float(getattr(o, f)),
                                       float(getattr(o1, f)), rtol=1e-6,
                                       atol=1e-30, err_msg=f)
        for f in ("mass", "heat", "stored_ice", "stored_heat"):
            np.testing.assert_allclose(float(getattr(o.budgets, f)),
                                       float(getattr(o1.budgets, f)),
                                       rtol=1e-6, atol=1e-30, err_msg=f)
        # the gridded fields stay per tile
        assert o.spread_mass.shape[0] == len(ms)
    ref = W.owned_by_id(s1.bergs)
    got = W.owned_by_id([m.bergs for m in ms])
    W.assert_bitwise(got, ref)
    if case == "calving":
        assert got["lon"].shape[0] > 0
        assert sum(int(o.nbergs_calved) for o in outs) == got["lon"].shape[0]
        # the global cells' ids: (cell i + 1) + NX * cell j
        assert set(got["id_ij"]) == {3 + W.NX * 3, 22 + W.NX * 4}
    if case == "footloose":
        assert got["lon"].shape[0] > 1
    if case == "fused3":
        assert int(outs[-1].contact_fallback) > 0


def test_tiled_coupled_world_matches_untiled():
    """``chip_smoke.py`` 15c's world at 12,000 bergs on 32 x 32 cells
    (contacts, swirl, calving into the coast ring, footloose children),
    one step on 4 tiles, bitwise to the untiled run: newborns near a tile
    edge meet the neighbour tile's through the mid-step halo refreshes
    (without them a footloose child's ``fl_k`` differs after the step,
    and 5 bergs after 2)."""
    cfg, grid, frc, st, calving, stored = W.coupled_world()
    # the exact fallback's strip holds a dense cell's 3 x 3 candidates
    fk = dict(fallback_strip_width=128)
    model = ibp.IcebergsModel(grid, cfg, device=W.CPU, fused_kw=fk)
    s = model.init_state(st)
    s = s.replace(calving=s.calving.replace(stored_ice=stored))
    s, o = model.run(s, frc, calving)
    assert int(o.nbergs_calved_fl) > 0 and int(o.nbergs_calved) > 0
    assert int(o.contact_overflow) == 0

    w = W.tiled_world(cfg, (4,), 32, 32, 2000.0)
    frcs, tiles = W.shard(w, frc, st, 8192)
    tiles, ov = dd.make_halo_fill(w, 4096)(tiles)
    ms = [m.replace(calving=m.calving.replace(stored_ice=si)) for m, si in
          zip(dd.init_sharded_model_state(w, tiles),
              dd.shard_calving_field(w, stored))]
    run = dd.make_sharded_run(w, neighbor_mode=None, exchange_width=4096,
                              fused_kw=fk)
    cs = dd.shard_calving_field(w, calving)
    hs = dd.shard_calving_field(w, torch.zeros_like(calving))
    ms, out, _, ov = run(ms, frcs, cs, hs)
    assert int(ov.max()) == 0 and int(out.contact_overflow) == 0
    assert ov.shape == (4, 4 + 2 * 2, 2)
    W.assert_bitwise(W.owned_by_id([m.bergs for m in ms]),
                     W.owned_by_id(s.bergs))


@pytest.fixture(scope="module")
def jax_calving():
    """The JAX package's 4-device run of the calving world."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    cfg = ibt.IcebergsConfig(**W.CALVING)
    frc = ibt.uniform_forcing(W.NX, W.NY, uo=0.2, sst=1.0)
    mesh = Mesh(np.array(jax.devices()[:4]), (jdd.AXIS,))
    world = jdd.make_sharded_world(cfg, mesh, nx=W.NX, ny=W.NY, lon0=0.,
                                   lat0=0., dlon=W.DXY, dlat=W.DXY)
    frc_s = jdd.shard_forcing(world, frc)
    st_s = jdd.shard_state(world, jax_empty_state(96), local_capacity=48)
    ms = jdd.init_sharded_model_state(world, st_s, seed=3)
    calv = jnp.asarray(W.calving_field())
    calv_s = jdd.shard_calving_field(world, calv)
    hflx_s = jdd.shard_calving_field(world, jnp.zeros_like(calv))
    run = jdd.make_sharded_run(world)
    counts = []
    for _ in range(CALVING_STEPS):
        ms, out, nbergs, overflow = run(ms, frc_s, calv_s, hflx_s)
        counts.append(dict(nbergs=int(nbergs),
                           nbergs_calved=int(out.nbergs_calved),
                           spawn_overflow=int(out.spawn_overflow),
                           overflow=np.asarray(overflow)))
    flat = {k: np.asarray(jax.device_get(v)) for k, v in
            vars(ms.bergs).items() if hasattr(v, "shape")}
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in flat.items()}
    own = flat["alive"] & (flat["halo_berg"] < 0.5)
    order = np.lexsort((flat["id_ij"][own], flat["id_cnt"][own]))
    return dict(counts=counts, owned={k: v[own][order]
                                      for k, v in flat.items()},
                mass=float(out.budgets.mass),
                stored_ice=float(out.budgets.stored_ice),
                calving_to_bergs=float(out.calving_to_bergs),
                net_melt_kg=float(out.net_melt_kg))


def test_tiled_run_matches_jax(jax_calving):
    cfg, grid, frc, st, kw, _ = _calving()
    ms, outs, ovs = W.tiled_run(cfg, frc, st, (4,), CALVING_STEPS, cap=48,
                                **kw)
    for o, ov, c in zip(outs, ovs, jax_calving["counts"]):
        assert int(o.nbergs) == c["nbergs"]
        assert int(o.nbergs_calved) == c["nbergs_calved"]
        assert int(o.spawn_overflow) == c["spawn_overflow"] == 0
        np.testing.assert_array_equal(ov.sum((1, 2)).numpy(), c["overflow"])
    got = W.owned_by_id([m.bergs for m in ms])
    want = jax_calving["owned"]
    assert got["lon"].shape[0] == want["lon"].shape[0] > 0
    for f, g in got.items():
        w = want[f]
        if g.dtype.kind != "f":
            assert np.array_equal(g, w), f
            continue
        scale = max(np.abs(w).max(initial=0.), 1e-30)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL_SCALE * scale,
                                   err_msg=f)
    last = outs[-1]
    for f, v in (("mass", float(last.budgets.mass)),
                 ("stored_ice", float(last.budgets.stored_ice)),
                 ("calving_to_bergs", float(last.calving_to_bergs))):
        np.testing.assert_allclose(v, jax_calving[f], rtol=1e-6, err_msg=f)
    # the melt summed over the tiles' owned bergs and halo copies alike,
    # within test_torch_api.py's MELT_LIMITS
    np.testing.assert_allclose(float(last.net_melt_kg),
                               jax_calving["net_melt_kg"], rtol=5e-5)

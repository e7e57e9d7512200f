"""The port's 2-D tiled step on the worlds of ``tests/test_parallel_2d.py``.

Tiled against untiled, bit for bit: a 2x2 layout of the tiled step (x
pass then y pass exchanges) gives the untiled step's ``berg_chksum`` and
owned bergs on the diagonal drift, whose bergs cross tile corners, and
on the colliding world with the ``fused3`` search (pairs straddling the
x and the y tile edges, a triple cluster).  Every exchange counter is 0.

Against the JAX package's 2x2 sharded functions on the CPU mesh (one JAX
run for the module): the halo fill bit for bit in every field of every
slot, then 40 steps of the diagonal drift slot for slot, ``alive``,
``halo_berg``, ``ine``/``jne``, the ids and the counters exact, floats
within ``rtol 1e-5`` plus 2e-5 of each field's scale (the tolerance of
``tests/test_torch_step.py``; the acceleration terms as the velocity
change of half a step against the speed's scale: the RK4 remainder
``bxn`` of this uniform drift is ~1e-10 and its last bits differ between
the packages untiled as well); and the sliced calving fields.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import icebergs_tpu as ibt
from icebergs_tpu.parallel import domain as jdd

from icebergs_tpu_torch.diag import berg_chksum
from icebergs_tpu_torch.parallel import domain as dd

import torch_parallel_worlds as W
from test_torch_parallel import assert_tiles_close, jax_tiles, jax_world

torch.set_num_threads(1)
DIAG_STEPS = 40
CASES = {
    "diagonal": (W.DRIFT, dict(uo=1.0, vo=1.0, sst=2.0),
                 W.diagonal_positions, DIAG_STEPS, dict(with_thermo=False)),
    "fused3": (W.INTERACTIVE, dict(uo=0.3, vo=0.2, sst=2.0),
               W.pair_positions_2d, 10, W.FUSED3_STEP),
}


def _jax_world_2d(cfg):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                (jdd.AXIS, jdd.AXIS_Y))
    return jdd.make_sharded_world_2d(cfg, mesh, nx=W.NX2, ny=W.NY2, lon0=0.,
                                     lat0=0., dlon=W.DXY2, dlat=W.DXY2)


@pytest.fixture(scope="module")
def jax_diagonal():
    """The JAX package's 2x2 run of the diagonal drift: the slabs after
    the halo fill and after DIAG_STEPS steps, and every counter."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    lon, lat = W.diagonal_positions()
    cfg, _, frc, st = jax_world(W.DRIFT, dict(uo=1.0, vo=1.0, sst=2.0), lon,
                                lat, W.NX2, W.NY2, W.DXY2)
    world = _jax_world_2d(cfg)
    frc_s = jdd.shard_forcing_2d(world, frc)
    st_s = jdd.shard_state_2d(world, st, local_capacity=32)
    st_s, ov = jdd.make_halo_fill_2d(world)(st_s)
    filled = jax_tiles(st_s)
    ovs = [np.asarray(ov).reshape(-1)]
    step = jdd.make_sharded_step_2d(world, with_thermo=False)
    for _ in range(DIAG_STEPS):
        st_s, nbergs, total_mass, ov = step(st_s, frc_s)
        ovs.append(np.asarray(ov).reshape(-1))
    return dict(filled=filled, tiles=jax_tiles(st_s), overflow=ovs,
                nbergs=int(nbergs), total_mass=float(total_mass))


def check_untiled(mode, tiles, nbergs, ovs):
    """parallel_reprod on a 2x2 layout: the tiles' owned bergs equal the
    untiled step's bit for bit, checksum too; every counter 0."""
    cfg_kw, frc_kw, pos, nsteps, kw = CASES[mode]
    cfg, grid, frc = W.world(cfg_kw, frc_kw, W.NX2, W.NY2, W.DXY2)
    ref = W.untiled_steps(cfg, grid, frc, W.bergs(grid, *pos()), nsteps,
                          **kw)
    assert ovs[0].shape == (4, 8, 2)
    assert all(int(o.max()) == 0 for o in ovs)
    cs1, n1 = berg_chksum(ref)
    cs, n = berg_chksum(dd.concat_tiles(tiles))
    assert int(n) == int(n1) == int(nbergs) == len(pos()[0])
    assert int(cs) == int(cs1), (int(cs), int(cs1))
    W.assert_bitwise(W.owned_by_id(tiles), W.owned_by_id(ref))


def test_2d_fused3_matches_untiled():
    cfg_kw, frc_kw, pos, nsteps, kw = CASES["fused3"]
    cfg, grid, frc = W.world(cfg_kw, frc_kw, W.NX2, W.NY2, W.DXY2)
    tiles, nbergs, _, ovs = W.tiled_steps(
        cfg, frc, W.bergs(grid, *pos()), (2, 2), nsteps, nx=W.NX2, ny=W.NY2,
        dxy=W.DXY2, **kw)
    check_untiled("fused3", tiles, nbergs, ovs)


def test_2d_matches_jax(jax_diagonal):
    """The 2x2 halo fill and diagonal drift against the untiled step and
    the JAX package's."""
    cfg, grid, frc = W.world(W.DRIFT, dict(uo=1.0, vo=1.0, sst=2.0), W.NX2,
                             W.NY2, W.DXY2)
    st = W.bergs(grid, *W.diagonal_positions())
    w = W.tiled_world(cfg, (2, 2), W.NX2, W.NY2, W.DXY2)
    fs, ts = W.shard(w, frc, st, 32)
    ts, ov = dd.make_halo_fill_2d(w)(ts)
    for t, j in zip(W.tile_fields(ts), jax_diagonal["filled"]):
        W.assert_bitwise(t, j)
    ovs = [ov]
    step = dd.make_sharded_step_2d(w, with_thermo=False)
    for _ in range(DIAG_STEPS):
        ts, nbergs, total_mass, ov = step(ts, fs)
        ovs.append(ov)
    check_untiled("diagonal", ts, nbergs, ovs)
    # the drift took every berg across a tile corner
    d = W.owned_by_id(ts)
    assert (d["lon"] > 8 * W.DXY2).all() and (d["lat"] > 8 * W.DXY2).all()
    for o, jo in zip(ovs, jax_diagonal["overflow"]):
        np.testing.assert_array_equal(o.sum((1, 2)).numpy(), jo)
    assert int(nbergs) == jax_diagonal["nbergs"] == 6
    assert_tiles_close(ts, jax_diagonal["tiles"], W.DRIFT["dt"])
    np.testing.assert_allclose(float(total_mass),
                               jax_diagonal["total_mass"], rtol=1e-6)


def test_2d_shard_calving_field_matches_jax():
    """Each 2-D tile's slice of a calving field (the ring it does not own
    zeroed) and of a 3-D bucket field equals the JAX package's."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rng = np.random.RandomState(5)
    cfg = W.world(W.DRIFT, {}, W.NX2, W.NY2, W.DXY2)[0]
    w = W.tiled_world(cfg, (2, 2), W.NX2, W.NY2, W.DXY2)
    jw = _jax_world_2d(ibt.IcebergsConfig(**W.DRIFT))
    for shape in ((W.NX2 + 2, W.NY2 + 2), (W.NX2 + 2, W.NY2 + 2, 3)):
        a = rng.rand(*shape).astype(np.float32)
        got = dd.shard_calving_field(w, a)
        want = np.asarray(jax.device_get(jdd.shard_calving_field(jw, a)))
        for d, g in enumerate(got):
            assert np.array_equal(g.numpy(), want.reshape(
                (4,) + want.shape[2:])[d])
        # each global cell lands on exactly one tile
        assert np.isclose(sum(float(g.sum()) for g in got),
                          float(a[1:-1, 1:-1].sum()), rtol=1e-5)

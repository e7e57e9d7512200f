"""The tripolar folded north edge in the port's tiles
(``icebergs_tpu_torch.parallel``), on the worlds of
``tests/test_parallel_fold.py`` and ``tests/test_parallel_bonds.py:262``.

``fold_state`` against the JAX package's bit for bit, and an involution.
A folded 2 x 2 world's tile grids (the fold images of the cell fields)
and forcing (the fold images of a random forcing, velocities negated)
bit for bit as the JAX package slices them.  The exchange of a bonded
pair whose bond spans the fold (the partner's replica arrives as its fold
image) against the JAX package's on the 8-device CPU mesh (one JAX run),
every field of every slot bit for bit, every counter as its sums.  A berg
crossing the fold re-enters at the mirrored longitude heading south;
(2, 2) and (4, 2) layouts give the same bits; two bergs meeting through
the fold repel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.parallel import domain as jdd

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import forces as tforces
from icebergs_tpu_torch.parallel import domain as dd

import torch_parallel_worlds as W

torch.set_num_threads(1)
LAT_TOP = W.FNY * W.FDXY
CONTACT_STEPS = 50


def fold_slab():
    """test_parallel_fold.py's involution slab, as numpy."""
    ine = np.array([10, 5] + [0] * 6, np.int32)
    jne = np.array([10, 7] + [0] * 6, np.int32)
    return dict(lon=[12123., 40000.], lat=[64500., 63000.],
                uvel=[0.3, -0.1], vvel=[1.0, 0.5], ine=ine, jne=jne)


def test_fold_state_matches_jax_and_is_an_involution():
    """One application mirrors the position, turns the velocities and
    flips the cell, bit for bit as the JAX package's; two restore the
    slab (rot turned by 2 pi)."""
    d = fold_slab()
    base = dict(mass=1e8, thickness=20., width=50., length=60.,
                mass_scaling=1.0, id_cnt=[1, 2])
    jst = ibt.create_bergs(8, lon=d["lon"], lat=d["lat"], uvel=d["uvel"],
                           vvel=d["vvel"], **base)
    jst = jst.replace(ine=jnp.asarray(d["ine"]), jne=jnp.asarray(d["jne"]),
                      xi=jst.xi * 0 + 0.25, yj=jst.yj * 0 + 0.75)
    tst = ibp.create_bergs(8, lon=d["lon"], lat=d["lat"], uvel=d["uvel"],
                           vvel=d["vvel"], device=W.CPU, **base)
    tst = tst.replace(ine=torch.as_tensor(d["ine"]),
                      jne=torch.as_tensor(d["jne"]),
                      xi=tst.xi * 0 + 0.25, yj=tst.yj * 0 + 0.75)
    kw = dict(nxl=8, nyl=8, H=2, lon_sum=W.FNX * W.FDXY, lat_sum=2. * LAT_TOP)
    j1, t1 = jdd.fold_state(jst, **kw), dd.fold_state(tst, **kw)
    for f in ("lon", "lat", "lon_old", "lat_old", "uvel", "vvel", "xi", "yj",
              "ine", "jne", "rot", "uo", "ssh_y", "axn_fast"):
        assert np.array_equal(getattr(t1, f).numpy(),
                              np.asarray(getattr(j1, f))), f
    assert float(t1.lon[0]) == 64000. - 12123.
    assert t1.uvel[0].item() == float(np.float32(-0.3))
    assert int(t1.ine[0]) == 1 and int(t1.jne[0]) == 9
    t2 = dd.fold_state(t1, **kw)
    for f in ("lon", "lat", "uvel", "vvel", "xi", "yj", "ine", "jne"):
        np.testing.assert_allclose(getattr(t2, f).numpy(),
                                   getattr(tst, f).numpy(), rtol=0,
                                   atol=1e-3)


def jax_folded_world(cfg, layout=(2, 2)):
    mesh = Mesh(np.array(jax.devices()[:layout[0] * layout[1]]).reshape(
        layout), (jdd.AXIS, jdd.AXIS_Y))
    return jdd.make_sharded_world_2d(cfg, mesh, nx=W.FNX, ny=W.FNY, lon0=0.,
                                     lat0=0., dlon=W.FDXY, dlat=W.FDXY,
                                     folded_north=True)


def test_folded_grids_and_forcing_match_jax():
    """The tile grids of a folded 2 x 2 world (the north halo's cell
    fields the fold images, over a random mask and depth) and the tiles
    of a random forcing (corner fields imaged and negated, centre fields
    imaged) bit for bit as the JAX package's; the fold sums equal."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rng = np.random.RandomState(2)
    depth = rng.uniform(10., 900., (W.FNX, W.FNY))
    cfg = W.FOLD
    jcfg = ibt.IcebergsConfig(**cfg)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                (jdd.AXIS, jdd.AXIS_Y))
    jw = jdd.make_sharded_world_2d(jcfg, mesh, nx=W.FNX, ny=W.FNY, lon0=0.,
                                   lat0=0., dlon=W.FDXY, dlat=W.FDXY,
                                   ocean_depth=depth, folded_north=True)
    w = dd.make_sharded_world_2d(ibp.IcebergsConfig(**cfg), dd.Ring((2, 2)),
                                 nx=W.FNX, ny=W.FNY, lon0=0., lat0=0.,
                                 dlon=W.FDXY, dlat=W.FDXY, ocean_depth=depth,
                                 folded_north=True, device=W.CPU)
    assert (w.fold_lon_sum, w.fold_lat_sum) == (jw.fold_lon_sum,
                                                jw.fold_lat_sum)
    for t, g in zip(w.ring.tiles, w.grids):
        dx, dy = w.ring.coords(t)
        for f in ("lonc", "latc", "msk", "area", "dx", "dy", "ocean_depth",
                  "lat_center", "lon0", "lat0"):
            want = np.asarray(getattr(jw.grids, f))[dx, dy]
            assert np.array_equal(getattr(g, f).numpy(), want), (t, f)
    corner = (W.FNX + 1, W.FNY + 1)
    center = (W.FNX + 2, W.FNY + 2)
    arrays = {k: rng.rand(*(corner if k in dd._CORNER else center)).astype(
        np.float32) for k in dd._CORNER + dd._CENTER}
    jf = jdd.shard_forcing_2d(jw, ibt.Forcing(**{
        k: jnp.asarray(v) for k, v in arrays.items()}))
    tf = dd.shard_forcing_2d(w, ibp.Forcing(**{
        k: torch.as_tensor(v) for k, v in arrays.items()}))
    for t, f in zip(w.ring.tiles, tf):
        dx, dy = w.ring.coords(t)
        for k in arrays:
            assert np.array_equal(getattr(f, k).numpy(),
                                  np.asarray(getattr(jf, k))[dx, dy]), (t, k)
    # the top tiles' north halo carries negated images of the corners
    top = tf[1].uo.numpy()
    assert (top[:, -1] < 0).all() and (tf[0].uo.numpy() >= 0).all()


def fold_bond_pair():
    """test :262's pair: A 80 m below the fold at 2.5 cells, B its
    physical neighbour across the fold (lon_sum - lon_A - 100), bonded by
    id stamps (too far apart in index space for a distance bond)."""
    lon_sum = W.FNX * W.FDXY
    lon_a = 2.5 * W.FDXY
    lon = np.array([lon_a, lon_sum - lon_a - 100.0])
    lat = np.array([LAT_TOP - 80., LAT_TOP - 120.])
    return lon, lat


def bond_by_stamps(st, mk):
    """Bond slots 0 of bergs 0 and 1 to each other, by stamps and slots,
    then label (``mk``: the package's array constructor)."""
    B = st.max_bonds
    bic = np.zeros((st.capacity, B), np.int32)
    bij = np.zeros((st.capacity, B), np.int32)
    bidx = np.full((st.capacity, B), -1, np.int32)
    bic[0, 0], bij[0, 0], bidx[0, 0] = 2, 11, 1
    bic[1, 0], bij[1, 0], bidx[1, 0] = 1, 10, 0
    return st.replace(bond_id_cnt=mk(bic), bond_id_ij=mk(bij),
                      bond_idx=mk(bidx))


@pytest.fixture(scope="module")
def jax_fold_bond_fill():
    """The JAX package's exchange (fold on, bonds on) of the fold-bond
    pair on a folded 2 x 2 world: the slabs and the overflow."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from test_torch_parallel import jax_tiles
    cfg = ibt.IcebergsConfig(**W.BONDED)
    world = jax_folded_world(cfg)
    gg = ibt.make_uniform_grid(W.FNX, W.FNY, 0., 0., W.FDXY, W.FDXY,
                               grid_is_latlon=False)
    st = ibt.create_bergs(64, lon=fold_bond_pair()[0],
                          lat=fold_bond_pair()[1], **W.BOND_BERG,
                          id_cnt=[1, 2], id_ij=[10, 11], max_bonds=4)
    i, j, xi, yj = jax_pos_to_cell(gg, st.lon, st.lat, -1.0)
    st = jforces.compute_conglom_ids_host(bond_by_stamps(
        st.replace(ine=i, jne=j, xi=xi, yj=yj), jnp.asarray))
    st_s = jdd.shard_state_2d(world, st, local_capacity=16)
    fold = (world.fold_lon_sum, world.fold_lat_sum)

    def fill(g, s):
        s, ov = jdd.exchange_particles(
            jax.tree.map(lambda x: x[0, 0], s),
            jax.tree.map(lambda x: x[0, 0], g), cfg, world.nxl, world.halo,
            16, nyl=world.nyl, y_axis=jdd.AXIS_Y, fold_north=fold)
        return jax.tree.map(lambda x: x[None, None], s), ov[None, None]
    spec = P(jdd.AXIS, jdd.AXIS_Y)
    st_s, ov = jax.jit(jax.shard_map(fill, mesh=world.mesh,
                                     in_specs=(spec, spec),
                                     out_specs=(spec, spec)))(
        world.grids, st_s)
    return jax_tiles(st_s), np.asarray(ov).reshape(-1)


def test_bond_spanning_fold_matches_jax(jax_fold_bond_fill):
    """The exchange of a bond across the fold bit for bit against the JAX
    package's: A's tile holds B's replica as B's fold image, ~109 m from
    A (test :262), and every counter is 0."""
    jtiles, jov = jax_fold_bond_fill
    cfg = ibp.IcebergsConfig(**W.BONDED)
    w = W.folded_world(cfg, (2, 2))
    grid = ibp.make_uniform_grid(W.FNX, W.FNY, 0., 0., W.FDXY, W.FDXY,
                                 grid_is_latlon=False, device=W.CPU)
    st = W.bergs(grid, *fold_bond_pair(), capacity=64,
                 **{**W.BOND_BERG, "id_cnt": [1, 2], "id_ij": [10, 11],
                    "max_bonds": 4})
    st = tforces.compute_conglom_ids_host(bond_by_stamps(st, torch.as_tensor))
    ts, ov = dd.make_halo_fill_2d(w, 16)(dd.shard_state_2d(w, st, 16))
    assert ov.shape == (4, 12, 2) and not ov.any()
    np.testing.assert_array_equal(ov.sum((1, 2)).numpy(), jov)
    for t, j in zip(W.tile_fields(ts), jtiles):
        W.assert_bitwise(t, j)
    a = ts[1]                                   # tile (0, 1), A's owner
    rep = a.alive & (a.halo_berg >= 0.5) & (a.id_cnt == 2)
    own = a.alive & (a.halo_berg < 0.5) & (a.id_cnt == 1)
    assert int(rep.sum()) == 1 and int(own.sum()) == 1
    d = torch.hypot(a.lon[rep] - a.lon[own], a.lat[rep] - a.lat[own])
    assert float(d) < 300.0
    assert int(a.bond_idx[own][0, 0]) == int(torch.nonzero(rep)[0, 0])


def owned(tiles):
    return W.owned_by_id(tiles)


def test_fold_crossing_re_enters_mirrored():
    """A berg heading north across the fold re-enters at the mirrored
    longitude heading south (rot turned by pi), every counter 0."""
    ts, nb, ovs, _ = W.tiled_bond_run(W.fold_crossing, (2, 2), 12,
                                      folded=True, cap=32, width=64,
                                      with_thermo=False)
    assert int(nb) == 1 and all(not o.any() for o in ovs)
    o = owned(ts)
    np.testing.assert_allclose(o["lon"], W.FNX * W.FDXY - 12123.0, rtol=0,
                               atol=1.0)
    assert o["lat"][0] < LAT_TOP and o["vvel"][0] < 0.
    assert np.float32(o["rot"][0]) == np.float32(np.pi)


def test_fold_cross_layout_identity():
    """(2, 2) and (4, 2) folded layouts give the same bits (test
    ``test_fold_cross_layout_identity``), a berg crossing the fold."""
    cfg = ibp.IcebergsConfig(**W.FOLD)
    frc = ibp.uniform_forcing(W.FNX, W.FNY, sst=2.0, device=W.CPU)
    grid = ibp.make_uniform_grid(W.FNX, W.FNY, 0., 0., W.FDXY, W.FDXY,
                                 grid_is_latlon=False, device=W.CPU)
    rng = np.random.RandomState(5)
    n = 5
    lon = rng.uniform(1 * W.FDXY, 15 * W.FDXY, n)
    lat = rng.uniform(13 * W.FDXY, 15.9 * W.FDXY, n)
    lat[0] = LAT_TOP - 200.
    st = W.bergs(grid, lon, lat, vvel=1.0, id_cnt=np.arange(n) + 1,
                 **W.FOLD_BERG)
    res = []
    for layout in ((2, 2), (4, 2)):
        w = W.folded_world(cfg, layout)
        fs, ts = dd.shard_forcing_2d(w, frc), dd.shard_state_2d(w, st, 32)
        step = dd.make_sharded_step_2d(w, with_thermo=False)
        for _ in range(12):
            ts, nb, _, ov = step(ts, fs)
            assert not ov.any()
        assert int(nb) == n
        res.append(owned(ts))
    W.assert_bitwise(res[0], res[1])
    assert (res[0]["rot"] != 0).sum() >= 1


def test_contact_through_the_fold():
    """Two bergs approaching the glued north edge from mirrored longitudes
    collide through the fold and turn back (test
    ``test_contact_through_the_fold``, its pair started 200 m from the
    fold instead of 400 so that CONTACT_STEPS see the whole collision):
    the halo fold images give each its partner."""
    cfg = ibp.IcebergsConfig(**W.FOLD, interactive_icebergs_on=True,
                             spring_coef=1.e-5).replace(dt=60.0)
    frc = ibp.uniform_forcing(W.FNX, W.FNY, sst=2.0, device=W.CPU)
    grid = ibp.make_uniform_grid(W.FNX, W.FNY, 0., 0., W.FDXY, W.FDXY,
                                 grid_is_latlon=False, device=W.CPU)
    xa = 12000.0
    st = W.bergs(grid, [xa, W.FNX * W.FDXY - xa], [LAT_TOP - 200.] * 2,
                 capacity=64, vvel=[0.1, 0.1], **{**W.BOND_BERG,
                                                  "id_cnt": [1, 2]})
    w = W.folded_world(cfg, (2, 2))
    fs, ts = dd.shard_forcing_2d(w, frc), dd.shard_state_2d(w, st, 32)
    step = dd.make_sharded_step_2d(w, with_thermo=False,
                                   neighbor_mode="buckets")
    min_gap = np.inf
    for _ in range(CONTACT_STEPS):
        ts, nb, _, ov = step(ts, fs)
        assert int(nb) == 2 and not ov.any()
        min_gap = min(min_gap, abs(float(np.sum(LAT_TOP - owned(ts)["lat"]))))
    assert min_gap > 100.0, min_gap
    o = owned(ts)
    assert (o["vvel"] < 0).all() and (o["lat"] < LAT_TOP).all()


def test_fold_pass_counters():
    """The fold passes' counters (tiles, passes, 2): 4 x-axis and 4 y-axis
    passes, then the fold's migration and strip passes.  Three bergs in
    the strip below the fold of top tile (0, 1), with a width of 1: its
    strip pass reports 2 unsent (``ov1``), no other fold counter counts,
    and the mirrored tile (1, 1) holds the one sent as its fold image."""
    cfg = ibp.IcebergsConfig(**W.FOLD)
    grid = ibp.make_uniform_grid(W.FNX, W.FNY, 0., 0., W.FDXY, W.FDXY,
                                 grid_is_latlon=False, device=W.CPU)
    st = W.bergs(grid, [5000., 9000., 13000.], [LAT_TOP - 100.] * 3,
                 vvel=1.0, id_cnt=[1, 2, 3], **W.FOLD_BERG)
    w = W.folded_world(cfg, (2, 2))
    ts, ov = dd.make_halo_fill_2d(w, 1)(dd.shard_state_2d(w, st, 16))
    assert ov.shape == (4, 10, 2)
    assert ov[1, 9].tolist() == [2, 0]
    assert not ov[:, 8].any() and not ov[[0, 2, 3], 9].any()
    t = ts[3]
    image = t.alive & (t.halo_berg >= 0.5) & (t.lat > LAT_TOP)
    assert int(image.sum()) == 1
    assert float(t.lat[image][0]) == float(np.float32(LAT_TOP + 100.))

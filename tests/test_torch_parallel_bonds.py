"""Bonds across tiles in the port (``icebergs_tpu_torch.parallel``): the
bond id stamps, the conglomerate replication and the bonded step, on the
worlds of ``tests/test_parallel_bonds.py``.

``stamp_bond_ids`` and ``connect_bonds_by_id`` against the JAX package's
bit for bit (duplicate ids, dead slots, stamps of missing partners).  The
halo fill of a bonded world (stamps, strip copies, conglomerate
replication, the partners connected by id, the copies re-localised)
against the JAX package's on the 8-device CPU mesh (one JAX run a width,
shared by the module), every field of every slot bit for bit: the
conglomerates straddling the 0 | 1 edge land on tiles 0 and 1 only; with
a width, an id list and a tile too small, the buffer (``ov1``), slot
(``ov2``) and id-list (``ov_ids``) counters each count, per tile as the
JAX package's sums.  The sorted memberships that choose the shipped and
kept rows against the JAX package's dense ``ship`` / ``keep``
comparisons (kept here only as twins).  The bonded pair across the 1-D
tile edge and across the 2 x 2 corner: the tiled step bit for bit to the
untiled step (the partners by id), every counter 0.
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
NX4 = 32                     # 4 tiles of 8 columns (test :217)
STEPS = 20
SLOT_FIELDS = ("bond_idx", "bond_id_cnt", "bond_id_ij")


def random_bonded(seed=0, n=48, cap=64, B=4):
    """A state's id and bond columns as numpy: some ids repeated, some
    slots dead, partner slots random, stamps of absent ids."""
    rng = np.random.RandomState(seed)
    alive = rng.uniform(size=cap) < 0.8
    alive[n:] = False
    id_cnt = rng.randint(1, 30, cap).astype(np.int32)
    id_ij = rng.randint(-2, 3, cap).astype(np.int32)
    bidx = np.where(rng.uniform(size=(cap, B)) < 0.4,
                    rng.randint(0, cap, (cap, B)), -1).astype(np.int32)
    bic = np.where(rng.uniform(size=(cap, B)) < 0.3,
                   rng.randint(0, 35, (cap, B)), 0).astype(np.int32)
    bij = np.where(bic != 0, rng.randint(-2, 3, (cap, B)), 0).astype(
        np.int32)
    return dict(alive=alive, id_cnt=id_cnt, id_ij=id_ij, bond_idx=bidx,
                bond_id_cnt=bic, bond_id_ij=bij)


@pytest.mark.parametrize("seed", [0, 1])
def test_stamp_and_connect_match_jax(seed):
    """Stamping then connecting by id, bit for bit: the stamps, and the
    partner slots (the lowest live slot of each id; -1 where no live slot
    has it or the slot is dead)."""
    cols = random_bonded(seed)
    cap = len(cols["alive"])
    jst = ibt.create_bergs(cap, lon=np.zeros(1), lat=np.zeros(1),
                           mass=1., thickness=1., width=1., length=1.,
                           mass_scaling=1., max_bonds=4)
    jst = jst.replace(**{k: jnp.asarray(v) for k, v in cols.items()})
    tst = ibp.create_bergs(cap, lon=np.zeros(1), lat=np.zeros(1), mass=1.,
                           thickness=1., width=1., length=1.,
                           mass_scaling=1., max_bonds=4, device=W.CPU)
    tst = tst.replace(**{k: torch.as_tensor(v) for k, v in cols.items()})
    js = jforces.stamp_bond_ids(jst)
    ts = tforces.stamp_bond_ids(tst)
    for f in ("bond_id_cnt", "bond_id_ij"):
        assert np.array_equal(getattr(ts, f).numpy(),
                              np.asarray(getattr(js, f))), f
    jc = jforces.connect_bonds_by_id(js)
    tc = tforces.connect_bonds_by_id(ts)
    got, want = tc.bond_idx.numpy(), np.asarray(jc.bond_idx)
    assert np.array_equal(got, want)
    assert (got >= 0).sum() > 20 and (got == -1).sum() > 20


def conglomerate_world():
    """Two bonded pairs straddling the tile-0 | 1 edge at x = 8 km (ids
    1-2 and 3-4) and an unbonded berg on tile 2, on 32 x 8 cells of 1 km:
    numpy inputs of both packages."""
    lon = np.array([7800., 8200., 7800., 8200., 20000.])
    lat = np.array([4500., 4500., 2500., 2500., 4000.])
    return lon, lat


def jax_bonded(lon, lat, cap=64):
    cfg = ibt.IcebergsConfig(**W.BONDED)
    grid = ibt.make_uniform_grid(NX4, W.BNY, 0., 0., W.BDXY, W.BDXY,
                                 grid_is_latlon=False)
    n = len(lon)
    st = ibt.create_bergs(cap, lon=lon, lat=lat, **W.BOND_BERG,
                          id_cnt=np.arange(n) + 1, id_ij=np.arange(n) + 10,
                          max_bonds=4)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = jforces.initialize_bonds_host(
        st.replace(ine=i, jne=j, xi=xi, yj=yj),
        cfg.replace(length_for_manually_initialize_bonds=500.))
    return cfg, jforces.compute_conglom_ids_host(st)


def port_fill(width, id_cap, local_cap):
    cfg = ibp.IcebergsConfig(**W.BONDED)
    grid = ibp.make_uniform_grid(NX4, W.BNY, 0., 0., W.BDXY, W.BDXY,
                                 grid_is_latlon=False, device=W.CPU)
    st = W.bonded_bergs(grid, *conglomerate_world(), capacity=64,
                        bond_length=500.)
    w = W.tiled_world(cfg, (4,), NX4, W.BNY, W.BDXY)
    ts = dd.shard_state(w, st, local_cap)
    return dd.make_halo_fill(w, width, id_cap)(ts)


# (exchange width, conglom_id_cap, tile capacity): the JAX test's; a width
# and a tile too small (ov1, ov2); an id list too short (ov_ids)
FILLS = {"fits": (16, 64, 16), "buffers": (1, 64, 2), "ids": (1, 1, 2)}


@pytest.fixture(scope="module")
def jax_fills():
    """The JAX package's exchange (a halo fill) of the conglomerate world
    on 4 devices, at each FILLS setting: the slabs and overflows."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from test_torch_parallel import jax_tiles
    cfg, st = jax_bonded(*conglomerate_world())
    mesh = Mesh(np.array(jax.devices()[:4]), (jdd.AXIS,))
    world = jdd.make_sharded_world(cfg, mesh, nx=NX4, ny=W.BNY, lon0=0.,
                                   lat0=0., dlon=W.BDXY, dlat=W.BDXY)
    out = {}
    for key, (width, id_cap, local_cap) in FILLS.items():
        st_s = jdd.shard_state(world, st, local_capacity=local_cap)

        def fill(g, s, width=width, id_cap=id_cap):
            s, ov = jdd.exchange_particles(
                jax.tree.map(lambda x: x[0], s),
                jax.tree.map(lambda x: x[0], g), cfg, world.nxl,
                world.halo, width, conglom_id_cap=id_cap)
            return jax.tree.map(lambda x: x[None], s), ov[None]
        st_s, ov = jax.jit(jax.shard_map(
            fill, mesh=mesh, in_specs=(P(jdd.AXIS), P(jdd.AXIS)),
            out_specs=(P(jdd.AXIS), P(jdd.AXIS))))(world.grids, st_s)
        out[key] = (jax_tiles(st_s), np.asarray(ov))
    return out


@pytest.mark.parametrize("key", list(FILLS))
def test_bonded_fill_matches_jax(key, jax_fills):
    """The bonded exchange bit for bit against the JAX package's in every
    field of every slot; the conglomerates reach tiles 0 and 1 only (test
    :217); the per-tile counters sum to the JAX ``overflow``, and at the
    small setting each of ov1, ov2 and ov_ids counts."""
    jtiles, jov = jax_fills[key]
    ts, ov = port_fill(*FILLS[key])
    assert ov.shape == (4, 6, 2)
    np.testing.assert_array_equal(ov.sum((1, 2)).numpy(), jov)
    for t, j in zip(W.tile_fields(ts), jtiles):
        W.assert_bitwise(t, j)
    alive = [int(t.alive.sum()) for t in ts]
    if key == "fits":
        assert not ov.any()
        assert alive == [4, 4, 1, 0]
        for t in ts[:2]:
            assert int((t.bond_idx >= 0).sum()) == 4     # both pairs joined
    else:
        repl, ids = ov[:, 4], ov[:, 5]   # (ov1, ov2) and (ov_ids, 0)
        assert not ids[:, 1].any()
        if key == "buffers":
            assert repl[:, 0].tolist() == repl[:, 1].tolist() == [1, 1, 0, 0]
            assert not ids.any()
        else:
            assert ids[:, 0].tolist() == [1, 1, 0, 0]


def dense_members(cid, ids):
    """The JAX package's dense form of the replication's choices
    (``domain.py:621-622``, ``:642-643``): cid <= 0, or equal to an entry
    of ``ids`` (0-padded)."""
    return (cid <= 0) | (cid[:, None] == ids[None, :]).any(dim=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replication_memberships_equal_dense(seed):
    """``ship`` (an owned bonded member wanted by another tile: the
    gathered id lists with this tile's slice zeroed, as the JAX package
    forms it, against the other tiles' lists) and ``keep`` (a gathered row
    of a conglomerate this tile wants), by the binary search of
    ``_is_member`` and by the dense comparison, bit for bit."""
    rng = np.random.RandomState(seed)
    cap, ntiles = 16, 4
    lists = []
    for _ in range(ntiles):
        k = rng.randint(0, cap + 1)
        ids = np.sort(rng.choice(np.arange(1, 60), k, replace=False))
        lists.append(torch.as_tensor(np.pad(ids, (0, cap - k)),
                                     dtype=torch.int32))
    cid = torch.as_tensor(rng.randint(-2, 60, 500), dtype=torch.int32)
    for me in range(ntiles):
        zeroed = torch.cat([torch.zeros(cap, dtype=torch.int32) if u == me
                            else lists[u] for u in range(ntiles)])
        others = torch.cat([lists[u] for u in range(ntiles) if u != me])
        got = (cid <= 0) | dd._is_member(cid, others)
        assert torch.equal(got, dense_members(cid, zeroed))
        keep = (cid <= 0) | dd._is_member(cid, lists[me])
        assert torch.equal(keep, dense_members(cid, lists[me]))
        assert 0 < int(got.sum()) < len(cid)


def owned(tiles):
    return {k: v for k, v in W.owned_by_id(tiles).items()
            if k not in SLOT_FIELDS}


def partners(tiles):
    """(id, the partners' ids by bond slot) of every owned berg."""
    if not isinstance(tiles, (list, tuple)):
        tiles = [tiles]
    rows = []
    for t in tiles:
        d = ibp.to_numpy(tforces.stamp_bond_ids(t))
        own = d["alive"] & (d["halo_berg"] < 0.5)
        rows += [(c, tuple(np.where(b >= 0, p, 0)))
                 for c, b, p in zip(d["id_cnt"][own], d["bond_idx"][own],
                                    d["bond_id_cnt"][own])]
    return sorted(rows)


@pytest.mark.parametrize("world_fn,layout", [
    (W.edge_pair, (2,)), (W.corner_pair, (2, 2))])
def test_bonded_pair_tiled_matches_untiled(world_fn, layout):
    """The bonded pair across the tile edge (1-D, test :84) and across the
    2 x 2 corner (test :148): STEPS tiled steps after a halo fill equal
    the untiled steps bit for bit, every counter 0, the bond kept."""
    cfg, grid, frc, st = world_fn()
    assert int(st.n_bonds[0]) == 1
    ref = W.untiled_steps(cfg, grid, frc, st, STEPS, with_thermo=False)
    ts, nb, ovs, _ = W.tiled_bond_run(world_fn, layout, STEPS,
                                      with_thermo=False)
    assert int(nb) == 2
    assert all(not o.any() for o in ovs)
    assert ovs[0].shape == (len(ts), 4 * len(layout) + 2, 2)
    W.assert_bitwise(owned(ts), owned(ref))
    assert partners(ts) == partners(ref) == [(1, (2, 0, 0, 0)),
                                             (2, (1, 0, 0, 0))]

"""The port's tiled MTS step (``make_sharded_mts_step``) with its
per-substep ghost refresh, on the worlds of ``tests/test_parallel_bonds.py``
and the property of ``tests/test_ring_scaling.py``.

Tiled against untiled, bit for bit: the 6-element DEM chain straddling
the edge of 2 tiles (ring and all-gather refresh) and the diagonal chain
through the corner of 2 x 2 tiles give the untiled scan's owned elements
in every field (the bond partners by id), with Part 1 converged (one
decision for all tiles); so does the chain on a world whose second tile
starts at an odd global column, over a non-uniform ocean depth, where
the quadratic stencil picks its window by the global cell's parity (the
JAX package's tiles take the tile-local parity: there ``od`` differs from
the untiled run's, ROADMAP.md Queue 3).

Against the JAX package's sharded MTS step on the 8-device CPU mesh (one
JAX run, 3 outer steps, ring refresh): the owned count, the ids, the
broken bonds and every counter exact, positions within the JAX test's
0.5 m, velocities within rtol 2e-4 + 2e-3 of scale (the port's DEM
yardstick against XLA:CPU's contracted multiply-adds; the JAX step reads
the forcing by ``interp_flds``, the port's as ``make_step`` does).

The sorted ghost match against the JAX package's dense ``eq`` /
``argmax`` twin (kept here only), a tile two hops away arriving twice on
a ring of 4; the ring transport against the JAX package's order and its
traffic: a tile's bytes grow with the hops, not with the tiles, and the
all-gather's grow linearly; the ghost counters (``ov_ship``, ``ov_rep``,
replicas not found) each forced; and the ``substep_sync`` hook of
``evolve_icebergs_mts`` (an identity sync gives the scan's bits, and
routes a ``vmem`` request to the scan).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.parallel import domain as jdd

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import mts as tmts
from icebergs_tpu_torch.parallel import domain as dd

import torch_parallel_worlds as W

torch.set_num_threads(1)
NSTEPS = 3
# velocities against the JAX package's step: 2e-3 of scale, the yardstick
# of 12 DEM substeps in tests/test_torch_dem.py (XLA:CPU contracts
# multiply-adds; the stiff substeps carry those ulps to ~1e-3 of scale,
# ROADMAP.md Queue 3)
DEM_ATOL_SCALE = 2e-3
MTS_KW = dict(pair_cap=512, contact_cap=256, ghost_width=16, ghost_slots=16)
# the bond partner slots are tile-local; the partners' ids are compared
SLOT_FIELDS = ("bond_idx", "bond_id_cnt", "bond_id_ij")


def owned(st):
    """``W.owned_by_id`` with the partner slots left out."""
    return {k: v for k, v in W.owned_by_id(st).items()
            if k not in SLOT_FIELDS}


def partner_ids(tiles):
    """Each owned element's partners' ids, (id_cnt order, bond slot)."""
    from icebergs_tpu_torch.ops.forces import stamp_bond_ids
    if not isinstance(tiles, (list, tuple)):
        tiles = [tiles]
    rows = []
    for t in tiles:
        d = ibp.to_numpy(stamp_bond_ids(t))
        own = d["alive"] & (d["halo_berg"] < 0.5)
        has = d["bond_idx"][own] >= 0
        rows += [(c, tuple(np.where(h, b, 0)))
                 for c, h, b in zip(d["id_cnt"][own], has,
                                    d["bond_id_cnt"][own])]
    return sorted(rows)


def untiled_scan(cfg, grid, frc, st, nsteps=NSTEPS):
    return W.untiled_steps(cfg, grid, frc, st, nsteps, with_thermo=False,
                           mts_pair_cap=512, contact_cap=256,
                           mts_neighbor_mode="tables")


def tiled_scan(world_fn, layout, nsteps=NSTEPS, **kw):
    ts, nb, ovs, step = W.tiled_bond_run(world_fn, layout, nsteps, mts=True,
                                         **{**MTS_KW, **kw})
    return ts, nb, ovs, step


@pytest.mark.parametrize("layout,sync,conv", [
    ((2,), "ring", False), ((2,), "allgather", False), ((2,), "ring", True),
    ((2, 2), "ring", False)])
def test_tiled_mts_matches_untiled(layout, sync, conv):
    """The tiled MTS step (ring or all-gather refresh, 1-D and 2 x 2, Part 1
    converged or not) equals the untiled scan bit for bit; every counter
    0; the convergence decisions are the untiled run's."""
    kw = dict(force_convergence=True, convergence_tolerance=1e-4) \
        if conv else {}
    cfg, grid, frc, st = W.mts_chain_world(layout, **kw)
    assert int(st.n_bonds.sum()) == 10
    ref = untiled_scan(cfg, grid, frc, st)
    ts, nb, ovs, step = tiled_scan(lambda: W.mts_chain_world(layout, **kw),
                                   layout, ghost_sync=sync)
    assert int(nb) == 6
    npass = 4 * len(layout) + 4
    assert all(o.shape == (len(ts), npass, 2) and not o.any() for o in ovs)
    W.assert_bitwise(owned(ts), owned(ref))
    assert partner_ids(ts) == partner_ids(ref)
    iters = {d.conv_iters for d in step.diags}
    assert len(iters) == 1 and (iters.pop() > 0) == conv


def test_odd_tile_offset_stencil_parity():
    """A tile whose first column is odd (18 columns in 2 tiles: offsets
    -2 and 7) over a random ocean depth: the quadratic depth ``od`` and
    every other field equal the untiled scan's.  With the tile-local
    parity (the JAX package's rule, ``stencil_lo`` at offset 0) the
    second tile's elements take another window, and ``od`` differs."""
    from icebergs_tpu_torch.ops import interp
    nx = 18
    depth = np.random.RandomState(3).uniform(100., 900., (nx, 8))
    cfg = W.mts_config()

    def world():
        grid = ibp.make_uniform_grid(nx, 8, 0., 0., W.MTS_DXY, W.MTS_DXY,
                                     grid_is_latlon=False, ocean_depth=depth,
                                     device=W.CPU)
        frc = ibp.uniform_forcing(nx, 8, device=W.CPU, **W.MTS_FORCING)
        return cfg, grid, frc, W.mts_chain(grid, cfg, 9 * W.MTS_DXY,
                                           4.3 * W.MTS_DXY)
    _, grid, frc, st = world()
    ref = untiled_scan(cfg, grid, frc, st, 2)
    w = dd.make_sharded_world(cfg, dd.Ring((2,)), nx=nx, ny=8, lon0=0.,
                              lat0=0., dlon=W.MTS_DXY, dlat=W.MTS_DXY,
                              ocean_depth=depth, device=W.CPU)
    assert [g.i_off for g in w.grids] == [-2, 7]
    fs, ts = dd.shard_forcing(w, frc), dd.shard_state(w, st, 16)
    step = dd.make_sharded_mts_step(w, **MTS_KW)
    for _ in range(2):
        ts, nb, _, ov = step(ts, fs)
        assert not ov.any()
    W.assert_bitwise(owned(ts), owned(ref))
    # the window by the tile-local parity differs on the odd tile
    t = ts[1]
    own = t.alive & (t.halo_berg < 0.5)
    g = w.grids[1]
    lo_g = interp.stencil_lo(t.ine, t.xi, g.nx, g.i_off, g.nxg, 1)
    lo_l = interp.stencil_lo(t.ine, t.xi, g.nx, 0, 0, 1)
    assert bool((lo_g != lo_l)[own].all())


def test_mts_ghost_counters():
    """Each ghost counter forced on the chain (3 elements a tile, each
    tile holding the other's 3 as replicas): a ghost width of 2 ships 2
    of a tile's 3 (``ov_ship`` 1), so 1 replica of the other tile finds
    no row (``not found`` 1); 2 slots take 2 of the 3 replicas (``ov_rep``
    1); with 0 hops no replica finds its owner's rows (``not found`` 3)."""
    cfg, grid, frc, st = W.mts_chain_world()
    w = W.tiled_world(cfg, (2,), 16, 8, W.MTS_DXY)
    fs, ts = W.shard(w, frc, st, 16)
    assert [int(t.alive.sum()) for t in ts] == [3, 3]
    for kw, ship, rep, lost in ((dict(ghost_width=2), 1, 0, 1),
                                (dict(ghost_slots=2), 0, 1, 0),
                                (dict(ghost_hops=0), 0, 0, 3)):
        step = dd.make_sharded_mts_step(w, **{**MTS_KW, **kw})
        _, _, _, ov = step(ts, fs)
        assert not ov[:, :-2].any() and not ov[:, -1, 1].any()
        assert ov[:, -2, 0].tolist() == [ship] * 2, kw
        assert ov[:, -2, 1].tolist() == [rep] * 2, kw
        assert ov[:, -1, 0].tolist() == [lost] * 2, kw


def dense_first_match(rcnt, rij, all_cnt, all_ij, all_valid):
    """The JAX package's ghost match (``domain.py:1276-1279``): the dense
    (replicas, S) equality and its ``argmax``, the plain twin of
    ``dd._first_match``."""
    eq = ((rcnt[:, None] == all_cnt[None, :])
          & (rij[:, None] == all_ij[None, :]) & all_valid[None, :])
    return eq.to(torch.uint8).argmax(dim=1).to(torch.int32), eq.any(dim=1)


def test_first_match_equals_dense_with_duplicate_arrivals():
    """On a ring of 4 with 2 hops the tile two away arrives twice (2 hops
    ahead and 2 behind): the sorted match takes its first arrival, as the
    dense twin's argmax does, for ids seen once, twice and never, and
    for rows that are not valid."""
    ring = dd.Ring((4,))
    rng = np.random.RandomState(0)
    W_ = 32
    rows = []
    for t in range(4):
        cnt = rng.randint(1, 40, W_).astype(np.int32)
        ij = rng.randint(-3, 3, W_).astype(np.int32)
        valid = rng.uniform(size=W_) < 0.8
        rows.append(torch.as_tensor(np.stack(
            [cnt, ij, valid.astype(np.int32)], -1)))
    stacks = dd.ring_transport(ring, rows, "x", 2)
    assert stacks[0].shape == (5 * W_, 3)
    # the far tile's rows at the 2nd forward and the 2nd backward hop
    assert torch.equal(stacks[0][2 * W_:3 * W_], rows[2])
    assert torch.equal(stacks[0][4 * W_:5 * W_], rows[2])
    for k, allp in enumerate(stacks):
        q = torch.as_tensor(rng.randint(1, 45, (200, 2)).astype(np.int32))
        q[:, 1] = torch.as_tensor(rng.randint(-3, 3, 200).astype(np.int32))
        q[:50] = allp[rng.randint(0, allp.shape[0], 50), :2]
        args = (q[:, 0], q[:, 1], allp[:, 0], allp[:, 1], allp[:, 2] > 0)
        src, found = dd._first_match(*args)
        dsrc, dfound = dense_first_match(*args)
        assert torch.equal(found, dfound) and int(found.sum()) > 40
        assert torch.equal(src[found], dsrc[found])
        assert not src[~found].any()
        # the far tile's rows match at their first arrival, never the
        # second
        assert int((found & (src >= 2 * W_) & (src < 3 * W_)).sum()) > 0
        assert not (found & (src >= 4 * W_)).any()


def test_ring_transport_matches_jax_order():
    """The stacked rows of a 4-tile ring at 2 hops, tile for tile, in the
    JAX package's order (its ``ring_transport`` under ``shard_map``)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from jax.sharding import PartitionSpec as P
    rows = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4 * 8, 3)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    jout = np.asarray(jax.jit(jax.shard_map(
        lambda r: jdd.ring_transport(r, "x", 4, 2), mesh=mesh,
        in_specs=P("x"), out_specs=P("x")))(rows)).reshape(4, 5 * 8, 3)
    got = dd.ring_transport(dd.Ring((4,)), [torch.as_tensor(rows[8 * t:
                                                               8 * t + 8])
                                            for t in range(4)], "x", 2)
    for t in range(4):
        assert np.array_equal(got[t].numpy(), jout[t])


def test_ring_traffic_is_o_hops_not_o_devices():
    """tests/test_ring_scaling.py's property from the ring's own count: a
    tile sends 2 x hops buffers a transport on 4 and 8 tiles (n - 1 = 1
    hop each way on 2), and the all-gather's output grows linearly."""
    Wr, Cr, hops = 64, 34, 2
    ring_b, all_b = {}, {}
    for n in (2, 4, 8):
        ring = dd.Ring((n,))
        rows = [torch.zeros(Wr, Cr) for _ in range(n)]
        b0 = ring.bytes
        dd.ring_transport(ring, rows, "x", hops)
        ring_b[n] = (ring.bytes - b0) / n
        b0 = ring.bytes
        ring.gather(rows)
        all_b[n] = (ring.bytes - b0) / n
    assert ring_b[4] == ring_b[8] == 2 * hops * Wr * Cr * 4
    assert ring_b[2] == 2 * 1 * Wr * Cr * 4
    assert all_b[8] == 2 * all_b[4] == 4 * all_b[2] == 8 * Wr * Cr * 4


@pytest.fixture(scope="module")
def jax_mts_ring():
    """The JAX package's sharded MTS step (ring) on 2 devices, NSTEPS
    outer steps of the chain world, and its single-device run."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    from test_parallel_bonds import cfg_mts_stable, mts_chain_state
    cfg = cfg_mts_stable()
    grid = ibt.make_uniform_grid(16, 8, 0., 0., W.MTS_DXY, W.MTS_DXY,
                                 grid_is_latlon=False)
    frc = ibt.uniform_forcing(16, 8, **W.MTS_FORCING)
    st = mts_chain_state(cfg, 8 * W.MTS_DXY, 4.3 * W.MTS_DXY)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = jforces.compute_conglom_ids_host(jforces.initialize_bonds_host(
        st.replace(ine=i, jne=j, xi=xi, yj=yj), cfg))
    mesh = Mesh(np.array(jax.devices()[:2]), (jdd.AXIS,))
    world = jdd.make_sharded_world(cfg, mesh, nx=16, ny=8, lon0=0., lat0=0.,
                                   dlon=W.MTS_DXY, dlat=W.MTS_DXY)
    frc_s = jdd.shard_forcing(world, frc)
    st_s = jdd.shard_state(world, st, local_capacity=16)
    step = jdd.make_sharded_mts_step(world, **MTS_KW)
    ovs = []
    for _ in range(NSTEPS):
        st_s, nb, _, ov = step(st_s, frc_s)
        ovs.append(np.asarray(ov))

    def flat(f):
        return np.asarray(jax.device_get(getattr(st_s, f))).reshape(
            (-1,) + np.asarray(getattr(st_s, f)).shape[2:])
    own = flat("alive") & (flat("halo_berg") < 0.5)
    o = np.argsort(flat("id_cnt")[own])
    return dict(nbergs=int(nb), overflow=ovs,
                **{f: flat(f)[own][o] for f in ("id_cnt", "id_ij", "lon",
                                                "lat", "uvel", "vvel",
                                                "bond_broken")})


def test_tiled_mts_matches_jax(jax_mts_ring):
    """The port's tiled MTS step against the JAX package's on the chain:
    the owned count, ids, broken bonds and every counter exact (the
    port's counters summed are the JAX ``overflow``), positions within
    0.5 m (the JAX test's), velocities within rtol 2e-4 + 2e-3 of scale
    (``DEM_ATOL_SCALE``: the JAX test's 1e-6 holds its tiles to its own
    single-device run, whose multiply-adds XLA:CPU contracts alike; the
    port differs from both by ~7e-4 of scale after 12 substeps, as its
    untiled scan does)."""
    ts, nb, ovs, _ = tiled_scan(W.mts_chain_world, (2,))
    assert int(nb) == jax_mts_ring["nbergs"] == 6
    for o, jo in zip(ovs, jax_mts_ring["overflow"]):
        np.testing.assert_array_equal(o.sum((1, 2)).numpy(), jo)
    got = W.owned_by_id(ts)
    for f in ("id_cnt", "id_ij", "bond_broken"):
        np.testing.assert_array_equal(got[f], jax_mts_ring[f])
    for f in ("lon", "lat"):
        np.testing.assert_allclose(got[f], jax_mts_ring[f], rtol=0, atol=0.5)
    for f in ("uvel", "vvel"):
        scale = np.abs(jax_mts_ring[f]).max()
        np.testing.assert_allclose(got[f], jax_mts_ring[f], rtol=2e-4,
                                   atol=DEM_ATOL_SCALE * scale)


def test_substep_sync_hook():
    """``evolve_icebergs_mts(substep_sync=)``: the sync runs at the top of
    every substep (counted), an identity sync gives the scan's bits, and
    a ``vmem`` request with a sync runs the scan (as the JAX package
    routes it, ``mts.py:723``)."""
    cfg, grid, frc, st = W.mts_chain_world()
    st = ibp.make_step(grid, cfg, with_thermo=False)(st, frc)[0]
    calls = []

    def sync(s):
        calls.append(1)
        return s
    ref, _ = tmts.evolve_icebergs_mts(st, grid, frc, cfg)
    got, _ = tmts.evolve_icebergs_mts(st, grid, frc, cfg, substep_sync=sync)
    assert len(calls) == cfg.n_sub_steps
    W.assert_bitwise(W.owned_by_id(got), W.owned_by_id(ref))
    got2, _ = tmts.evolve_icebergs_mts(st, grid, frc, cfg, substep_sync=sync,
                                       substep_kernel="vmem")
    assert len(calls) == 2 * cfg.n_sub_steps
    W.assert_bitwise(W.owned_by_id(got2), W.owned_by_id(ref))

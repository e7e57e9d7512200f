"""The port's 1-D tiled step (``icebergs_tpu_torch.parallel``) on the
worlds of ``tests/test_parallel.py``.

Tiled against untiled, bit for bit: 1, 2 and 4 tiles of the tiled step
(a halo fill, then the per-tile step and the particle exchange) give the
untiled step's ``berg_chksum`` and its owned bergs field for field, on
the drifting world with thermodynamics, on the colliding world with
the ``sorted`` and ``fused3`` searches (pairs straddling the tile edges,
a 4-berg cluster in the exact fallback group), and under the benchmark's
swirl: the interpolation reads each berg's place in its cell, which the
port's tiles measure from the global origin (the JAX package's tiles
measure from their own corner, an ulp apart, and its layout tests use a
uniform current).  Every exchange counter is 0.

Against the JAX package's sharded functions on the 8-device CPU mesh of
``tests/conftest.py`` (one JAX run, shared by the module): the 4-tile
``fused3`` step (``fused_interpret=True``) slot for slot, ``alive``,
``halo_berg``, ``ine``/``jne``, the ids and the exchange counters
exact, floats within ``rtol 1e-5`` plus 2e-5 of each field's scale, the
tolerance of ``tests/test_torch_step.py`` (XLA:CPU contracts
multiply-adds and the contact springs amplify those ulps), the
acceleration terms as the velocity change of half a step against the
speed's scale (``ACCEL``); the halo fill
bit for bit in every field, with ``exchange_width`` 1 forcing nonzero
overflows; the forcing halo refresh bit for bit; the tile metadata of a
``maskmap`` world; and ``dump_halo_state``'s listing of a tiled state.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import icebergs_tpu as ibt
from icebergs_tpu import diag as jdiag
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.parallel import domain as jdd

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import diag as tdiag
from icebergs_tpu_torch.diag import berg_chksum
from icebergs_tpu_torch.parallel import domain as dd
from icebergs_tpu_torch.parallel import multihost as mh

import torch_parallel_worlds as W

torch.set_num_threads(1)
RTOL, ATOL_SCALE = 1e-5, 2e-5
EXACT = ("alive", "halo_berg", "ine", "jne", "id_cnt", "id_ij")
FUSED3_STEPS = 12


def jax_world(cfg_kw, frc_kw, lon, lat, nx=W.NX, ny=W.NY, dxy=W.DXY):
    """The JAX twin of ``W.world`` + ``W.bergs``."""
    cfg = ibt.IcebergsConfig(**cfg_kw)
    grid = ibt.make_uniform_grid(nx, ny, 0., 0., dxy, dxy,
                                 grid_is_latlon=False)
    frc = ibt.uniform_forcing(nx, ny, **frc_kw)
    st = ibt.create_bergs(64, lon=lon, lat=lat, **W.BERG)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.0)
    return cfg, grid, frc, st.replace(ine=i, jne=j, xi=xi, yj=yj)


def jax_tiles(st_s):
    """The stacked JAX slabs as a list of ``{field: array}`` per tile."""
    lead = np.asarray(jax.device_get(st_s.alive)).shape[:-1]
    n = int(np.prod(lead))
    out = [{} for _ in range(n)]
    for f in dataclasses.fields(st_s):
        a = np.asarray(jax.device_get(getattr(st_s, f.name)))
        a = a.reshape((n,) + a.shape[len(lead):])
        for d in range(n):
            out[d][f.name] = a[d]
    return out


# the Verlet / RK4 acceleration terms, compared as the velocity change
# they make in half a step: the RK4 remainder ``b`` (the stages' mean less
# a / 2, icebergs.F90:7258) cancels to ~1e-4 of the stages' accelerations
# on a uniform drift, so its own largest magnitude is no yardstick
ACCEL = ("axn", "ayn", "bxn", "byn", "axn_fast", "ayn_fast", "bxn_fast",
         "byn_fast")


def assert_tiles_close(port_tiles, jax_tiles_, dt):
    """Slot for slot: the EXACT fields and integers equal, floats within
    RTOL plus ATOL_SCALE of the field's largest magnitude over the tiles
    (an ACCEL field times dt / 2 against the speed's)."""
    port = W.tile_fields(port_tiles)
    alive = [j["alive"] for j in jax_tiles_]
    speed = max(max(np.abs(j[f][a]).max(initial=0.) for f in ("uvel", "vvel"))
                for j, a in zip(jax_tiles_, alive))
    for f in jax_tiles_[0]:
        if f in EXACT or jax_tiles_[0][f].dtype.kind != "f":
            for d, (t, j) in enumerate(zip(port, jax_tiles_)):
                assert np.array_equal(t[f], j[f]), (d, f)
            continue
        k = 0.5 * dt if f in ACCEL else 1.
        a = [k * t[f][m].astype(np.float64) for t, m in zip(port, alive)]
        b = [k * j[f][m].astype(np.float64)
             for j, m in zip(jax_tiles_, alive)]
        scale = speed if f in ACCEL else max(
            max(np.abs(x).max(initial=0.) for x in b), 1e-30)
        for d, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL_SCALE * scale,
                                       err_msg=f"tile {d} {f}")


def jax_sharded(cfg, world, frc, st, cap, *, halo_fill=True, width=64):
    frc_s = jdd.shard_forcing(world, frc)
    st_s = jdd.shard_state(world, st, local_capacity=cap)
    ov = None
    if halo_fill:
        st_s, ov = jdd.make_halo_fill(world, exchange_width=width)(st_s)
    return frc_s, st_s, ov


def jax_world_1d(cfg, n, **kw):
    mesh = Mesh(np.array(jax.devices()[:n]), (jdd.AXIS,))
    return jdd.make_sharded_world(cfg, mesh, nx=W.NX, ny=W.NY, lon0=0.,
                                  lat0=0., dlon=W.DXY, dlat=W.DXY, **kw)


@pytest.fixture(scope="module")
def jax_fused3():
    """The JAX package's 4-device fused3 step on the colliding world:
    the halo fill, then FUSED3_STEPS steps; the slabs and counters."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    lon, lat = W.pair_positions()
    cfg, grid, frc, st = jax_world(W.INTERACTIVE, dict(uo=0.4, sst=2.0),
                                   lon, lat)
    world = jax_world_1d(cfg, 4)
    frc_s, st_s, ov0 = jax_sharded(cfg, world, frc, st, 32)
    step = jdd.make_sharded_step(world, with_thermo=True,
                                 fused_interpret=True, **W.FUSED3_STEP)
    ovs = [np.asarray(ov0)]
    for _ in range(FUSED3_STEPS):
        st_s, nbergs, total_mass, ov = step(st_s, frc_s)
        ovs.append(np.asarray(ov))
    return dict(tiles=jax_tiles(st_s), overflow=ovs, nbergs=int(nbergs),
                total_mass=float(total_mass))


CASES = {
    # (config, forcing, positions, steps, step keywords)
    "drift": (W.DRIFT, dict(uo=1.0, sst=2.0), lambda: W.drift_positions(5),
              20, {}),
    "sorted": (W.INTERACTIVE, dict(uo=0.4, sst=2.0),
               lambda: W.pair_positions(cluster=3), 12,
               dict(neighbor_mode="sorted")),
    "fused3": (W.INTERACTIVE, dict(uo=0.4, sst=2.0), W.pair_positions,
               FUSED3_STEPS, W.FUSED3_STEP),
    # the benchmark's swirl: the interpolation reads every berg's place in
    # its cell, which a tile measures from the global origin
    "swirl": (W.INTERACTIVE, dict(swirl=True, uo=0.3, ua=5.0, sst=4.0),
              W.swirl_positions, 8, W.FUSED3_STEP),
}


def check_untiled(mode, ntiles):
    """parallel_reprod (icebergs_framework.F90:33): the tiled step equals
    the untiled one bit for bit, checksum and owned bergs.  Returns the
    tiles, the owned count and mass and the counters."""
    cfg_kw, frc_kw, pos, nsteps, kw = CASES[mode]
    cfg, grid, frc = W.world(cfg_kw, frc_kw)
    st = W.bergs(grid, *pos())
    ref = W.untiled_steps(cfg, grid, frc, st, nsteps, **kw)
    tiles, nbergs, total_mass, ovs = W.tiled_steps(cfg, frc, st, (ntiles,),
                                                   nsteps, **kw)
    assert all(int(o.max()) == 0 for o in ovs)
    assert ovs[0].shape == (ntiles, 4, 2)
    cs1, n1 = berg_chksum(ref)
    cs, n = berg_chksum(dd.concat_tiles(tiles))
    assert int(n) == int(n1) == int(nbergs)
    assert int(cs) == int(cs1), (int(cs), int(cs1))
    W.assert_bitwise(W.owned_by_id(tiles), W.owned_by_id(ref))
    mass = torch.where(ref.alive, ref.mass * ref.mass_scaling, 0.).sum()
    np.testing.assert_allclose(float(total_mass), float(mass), rtol=1e-6)
    return tiles, nbergs, total_mass, ovs


@pytest.mark.parametrize("mode,ntiles", [
    ("drift", 4), ("sorted", 2), ("sorted", 4), ("fused3", 1),
    ("fused3", 2), ("swirl", 4)])
def test_tiled_step_matches_untiled(mode, ntiles):
    check_untiled(mode, ntiles)


def test_tiled_step_matches_jax(jax_fused3):
    """The 4-tile fused3 step against the untiled one, bit for bit, and
    against the JAX package's sharded step, slot for slot on every
    tile."""
    tiles, nbergs, total_mass, ovs = check_untiled("fused3", 4)
    assert int(nbergs) == jax_fused3["nbergs"]
    for o, jo in zip(ovs, jax_fused3["overflow"]):
        np.testing.assert_array_equal(o.sum((1, 2)).numpy(), jo)
    assert_tiles_close(tiles, jax_fused3["tiles"], W.INTERACTIVE["dt"])
    np.testing.assert_allclose(float(total_mass), jax_fused3["total_mass"],
                               rtol=1e-6)


def _edge_world():
    """Bergs crowding the tile edges of the 4-tile world: 3 in the last
    owned column of tile 0, 2 in the first of tile 1, 2 in the last of
    tile 3 (whose ring wraps to tile 0), one mid-tile."""
    x = np.array([7.2, 7.5, 7.8, 8.3, 8.6, 31.5, 31.7, 12.0]) * W.DXY
    y = np.array([3.5, 4.5, 5.5, 2.5, 3.5, 4.0, 5.0, 4.0]) * W.DXY
    return x, y


@pytest.fixture(scope="module")
def jax_edge_fills():
    """The JAX package's halo fill of the edge world on 4 devices at
    ``exchange_width`` 1 and 64: ``{width: (JAX state, stacked slabs,
    overflow)}``."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    lon, lat = _edge_world()
    jcfg, _, jfrc, jst = jax_world(W.DRIFT, dict(uo=1.0), lon, lat)
    out = {}
    for width in (1, 64):
        _, jst_s, jov = jax_sharded(jcfg, jax_world_1d(jcfg, 4), jfrc, jst,
                                    16, width=width)
        out[width] = (jst, jst_s, np.asarray(jov))
    return out


def _port_edge_fill(width=64):
    cfg, grid, frc = W.world(W.DRIFT, dict(uo=1.0))
    st = W.bergs(grid, *_edge_world())
    w = W.tiled_world(cfg, (4,), W.NX, W.NY, W.DXY)
    ts, ov = dd.make_halo_fill(w, exchange_width=width)(
        W.shard(w, frc, st, 16)[1])
    return st, ts, ov


@pytest.mark.parametrize("width", [1, 64])
def test_halo_fill_matches_jax(width, jax_edge_fills):
    """The halo fill (one exchange, no physics) bit for bit against the
    JAX package's in every field of every slot; with ``exchange_width`` 1
    the buffers overflow and the per-tile counts agree."""
    _, jst_s, jov = jax_edge_fills[width]
    _, ts, ov = _port_edge_fill(width)
    np.testing.assert_array_equal(ov.sum((1, 2)).numpy(), jov)
    if width == 1:
        assert int(ov.sum()) > 0
        assert int(ov[:, :, 0].sum()) > 0      # buffers overflowed
    else:
        assert int(ov.max()) == 0
    for t, j in zip(W.tile_fields(ts), jax_tiles(jst_s)):
        W.assert_bitwise(t, j)


def test_forcing_halo_update_matches():
    """The on-device forcing halo refresh (mpp_update_domains,
    icebergs.F90:5240-5351): zeroed halo columns refill bit for bit as
    the host slice and as the JAX package's update have them; the edge
    tiles' outer halos stay as they were."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rng = np.random.RandomState(11)
    corner = (W.NX + 1, W.NY + 1)
    center = (W.NX + 2, W.NY + 2)
    arrays = {k: rng.rand(*(corner if k in ("uo", "vo", "ui", "vi", "ua",
                                            "va") else center))
              .astype(np.float32)
              for k in ("uo", "vo", "ui", "vi", "ua", "va", "ssh", "sst",
                        "sss", "cn", "hi")}
    cfg, _, _ = W.world(W.DRIFT, {})
    w = W.tiled_world(cfg, (4,), W.NX, W.NY, W.DXY)
    truth = dd.shard_forcing(w, ibp.Forcing(**{
        k: torch.as_tensor(v) for k, v in arrays.items()}))
    H, nxl = w.halo, w.nxl

    def stale(t):
        kw = {}
        for k in arrays:
            a = getattr(t, k).clone()
            hw = H if k in ("uo", "vo", "ui", "vi", "ua", "va") else H + 1
            a[:hw] = 0.
            a[a.shape[0] - hw:] = 0.
            kw[k] = a
        return ibp.Forcing(**kw)
    stale_tiles = [stale(t) for t in truth]
    got = dd.make_forcing_halo_update(w)(stale_tiles)

    jcfg = ibt.IcebergsConfig(**W.DRIFT)
    jw = jax_world_1d(jcfg, 4)
    jtruth = jdd.shard_forcing(jw, ibt.Forcing(**{
        k: jnp.asarray(v) for k, v in arrays.items()}))
    for k in arrays:
        assert np.array_equal(np.stack([getattr(t, k).numpy()
                                        for t in truth]),
                              np.asarray(getattr(jtruth, k))), k
    jstale = ibt.Forcing(**{k: jax.device_put(
        jnp.asarray(np.stack([getattr(t, k).numpy() for t in stale_tiles])),
        jax.NamedSharding(jw.mesh, P(jdd.AXIS))) for k in arrays})
    jgot = jdd.make_forcing_halo_update(jw)(jstale)
    for k in arrays:
        hw = H if k in ("uo", "vo", "ui", "vi", "ua", "va") else H + 1
        jk = np.asarray(jax.device_get(getattr(jgot, k)))
        for d in range(4):
            g, want = getattr(got[d], k).numpy(), getattr(truth[d], k).numpy()
            assert np.array_equal(g, jk[d]), (k, d)
            if d > 0:
                assert np.array_equal(g[:hw], want[:hw]), (k, d, "W")
            else:
                assert not g[:hw].any(), (k, d)
            if d < 3:
                assert np.array_equal(g[-hw:], want[-hw:]), (k, d, "E")
            assert np.array_equal(g[hw:-hw], want[hw:-hw]), (k, d)


def test_tile_metadata_and_maskmap():
    """The tile grids carry the JAX tile metadata bit for bit (corners,
    centers, offsets, owned ring), a maskmap world keeps its global
    offsets, and 20 steps of it keep every berg and its mass."""
    if len(jax.devices()) < 3:
        pytest.skip("needs 3 devices")
    msk = np.ones((W.NX, W.NY))
    msk[:8, :] = 0.
    cfg, _, frc = W.world(W.DRIFT, dict(uo=1.0, sst=2.0))
    w = dd.make_sharded_world(cfg, dd.Ring((3,)), nx=W.NX, ny=W.NY, lon0=0.,
                              lat0=0., dlon=W.DXY, dlat=W.DXY, msk=msk,
                              maskmap=[False, True, True, True],
                              device=W.CPU)
    jcfg = ibt.IcebergsConfig(**W.DRIFT)
    jw = jdd.make_sharded_world(
        jcfg, Mesh(np.array(jax.devices()[:3]), (jdd.AXIS,)), nx=W.NX,
        ny=W.NY, lon0=0., lat0=0., dlon=W.DXY, dlat=W.DXY, msk=msk,
        maskmap=[False, True, True, True])
    gh = jw.grids_host
    for d, g in enumerate(w.grids):
        assert g.i_off == int(np.asarray(gh.i_off)[d]) == (d + 1) * 8 - 2
        assert (g.j_off, g.nxg, g.nyg, g.own_halo_x, g.own_halo_y) == (
            0, W.NX, W.NY, 2, 0)
        for f in ("lonc", "latc", "msk", "area", "dx", "dy", "ocean_depth",
                  "lat_center", "lon0", "lat0", "dlon", "dlat"):
            assert np.array_equal(getattr(g, f).numpy(),
                                  np.asarray(getattr(gh, f))[d]), (d, f)
    rng = np.random.RandomState(1)
    lon = rng.uniform(9 * W.DXY, (W.NX - 3) * W.DXY, 5)
    lat = rng.uniform(2 * W.DXY, (W.NY - 2) * W.DXY, 5)
    grid = ibp.make_uniform_grid(W.NX, W.NY, 0., 0., W.DXY, W.DXY,
                                 grid_is_latlon=False, msk=msk, device=W.CPU)
    st = W.bergs(grid, lon, lat)
    fs, ts = dd.shard_forcing(w, frc), dd.shard_state(w, st, 32)
    step = dd.make_sharded_step(w, with_thermo=False)
    for _ in range(20):
        ts, nbergs, total_mass, ov = step(ts, fs)
        assert int(ov.max()) == 0
    assert int(nbergs) == 5
    m0 = float(torch.where(st.alive, st.mass * st.mass_scaling, 0.).sum())
    np.testing.assert_allclose(float(total_mass), m0, rtol=1e-6)
    # the grid metadata round-trips through the conversion of a JAX grid
    g1 = jax.tree.map(lambda x: x[1], gh)
    g0 = ibp.grid_from_numpy(
        {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
         for f in dataclasses.fields(g1) for v in [getattr(g1, f.name)]},
        device=W.CPU)
    assert (g0.i_off, g0.nxg, g0.own_halo_x) == (w.grids[1].i_off, W.NX, 2)


def test_dump_halo_state_matches_jax(jax_edge_fills):
    """The halo_debugging listing of a tiled state (after a halo fill,
    so halo copies are listed) is the JAX package's text line for line,
    and a single state's too."""
    jst, jst_s, _ = jax_edge_fills[64]
    st, ts, _ = _port_edge_fill()
    for args, lines in (((jst_s, ts, {}), 15),
                        ((jst_s, ts, dict(device=1)), 6), ((jst, st, {}), 8)):
        jo, to = io.StringIO(), io.StringIO()
        jdiag.dump_halo_state(args[0], "fill", file=jo, **args[2])
        tdiag.dump_halo_state(args[1], "fill", file=to, **args[2])
        assert to.getvalue() == jo.getvalue()
        assert to.getvalue().count("\nA ") == lines, to.getvalue()


def test_multihost_single_process_and_unported_slices():
    """One process: no group, the ring holds every tile; bonds, MTS and
    the fold, ROADMAP.md item 13's last slices, build: a bonded state
    shards with its partners' ids stamped, the bonded step and the MTS
    run build, and a folded 2-D world carries its fold sums."""
    assert mh.initialize_multihost() == 1
    ring = mh.make_global_mesh(4)
    assert ring.tiles == [0, 1, 2, 3] and mh.local_tile_range(ring) == (0, 4)
    assert mh.make_global_mesh().ntiles == 1
    r2 = mh.make_global_mesh_2d(2, 3)
    assert r2.coords(4) == (1, 1) and r2.neighbour(4, "x", 1) == 1
    assert r2.neighbour(0, "y", -1) == 2 and r2.neighbour(5, "y", 1) == 3
    cfg, grid, frc = W.world(dict(W.DRIFT, iceberg_bonds_on=True), {})
    w = W.tiled_world(cfg, (2,), W.NX, W.NY, W.DXY)
    st = W.bergs(grid, *W.drift_positions(3))
    bi = st.bond_idx.clone()
    bi[0, 0], bi[1, 0] = 1, 0
    ts = dd.shard_state(w, st.replace(bond_idx=bi), 16)
    stamped = torch.cat([t.bond_id_cnt[t.alive] for t in ts])
    assert sorted(stamped[:, 0].tolist())[-2:] == [
        int(st.id_cnt[0]), int(st.id_cnt[1])]
    assert callable(dd.make_sharded_step(w))
    mts = W.tiled_world(cfg.replace(iceberg_bonds_on=False, mts=True),
                        (2,), W.NX, W.NY, W.DXY)
    assert callable(dd.make_sharded_run(mts))
    fw = dd.make_sharded_world_2d(cfg, dd.Ring((2, 2)), nx=16, ny=16,
                                  lon0=0., lat0=0., dlon=1., dlat=1.,
                                  folded_north=True, device=W.CPU)
    assert fw.folded_north and (fw.fold_lon_sum, fw.fold_lat_sum) == (16.,
                                                                       32.)

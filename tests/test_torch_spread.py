"""K3 (spread segment sums) and the coupler fields against the JAX package.

Sequential association (no block overflows the TPU kernel's window): a
cell with one or two rows sums bit for bit; denser cells agree within
1e-6 of each column's largest magnitude, because the JAX kernel sums a
cell's rows with a selection matmul, which in interpret mode on the CPU
runs as an XLA dot whose accumulation order is the library's, while the
port adds a cell's rows strictly in (cell, id) order (the TPU kernel's
order).  Window-overflow flags are exact, including a case where they are
set.

Overflow association: when a block overflows, the JAX package sums every
cell by the slot tree (``spread.py:274-300``) instead, and so does the
port.  That association differs from the sequential one by up to a few
ulps of a dense cell's sums, so the port's tree is held to the JAX
package's on every cell, not only the good blocks: the cell sums and the
coupler fields bit for bit, but for the one field whose epilogue XLA:CPU
fuses (see the test).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import pallas_spread as jps
from icebergs_tpu.ops import spread as jspread
from icebergs_tpu.ops import thermo as jthermo
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import segment_spread as ss
from icebergs_tpu_torch.ops import spread as tspread

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX = 24


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


@functools.lru_cache(maxsize=None)
def _world(old_spreading=True):
    """A sorted JAX state, its thermodynamics output and the matching
    port objects."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0,
                             use_f_plane=True, lat_ref=45., dt=600.,
                             Runge_not_Verlet=False,
                             interactive_icebergs_on=True,
                             use_old_spreading=old_spreading)
    msk = np.ones((NX, NX))
    msk[:3, :5] = 0.                   # land: masked spreading weights
    grid = ibt.make_uniform_grid(NX, NX, 0., 0., 2000., 2000.,
                                 grid_is_latlon=False, msk=msk)
    frc = ibt.swirl_forcing(NX, NX, 2000., sst=4., sss=33.)
    rng = np.random.RandomState(5)
    n = 900
    lon = rng.uniform(1e3, 47e3, n)
    lat = rng.uniform(1e3, 47e3, n)
    lon[:40] = 21e3 + rng.uniform(-900, 900, 40)      # a 40-berg cell
    lat[:40] = 25e3 + rng.uniform(-900, 900, 40)
    st = ibt.create_bergs(1024, lon=lon, lat=lat,
                          uvel=rng.uniform(-.3, .3, n),
                          vvel=rng.uniform(-.3, .3, n),
                          mass=rng.uniform(5e8, 2e9, n), thickness=40.,
                          width=rng.uniform(100., 300., n),
                          length=rng.uniform(300., 900., n),
                          mass_scaling=rng.uniform(1., 3., n),
                          mass_of_bits=rng.uniform(0., 1e6, n),
                          id_cnt=np.arange(n) + 1, sst=rng.uniform(0, 5, n),
                          sss=33.)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    st, cs = jax_sort(st.replace(ine=i, jne=j, xi=xi, yj=yj), grid)
    key_alive = st.alive
    st2, melt = jthermo.thermodynamics(st, grid, frc, cfg,
                                       defer_cell_cols=True)
    # rows that die after the sort keep their cell as sort key
    st2 = st2.replace(alive=st2.alive.at[5:9].set(False))
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    port = (tcfg, ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st2), device=CPU),
            torch.as_tensor(np.array(key_alive)),
            torch.as_tensor(np.array(cs)),
            [torch.as_tensor(np.array(c)) for c in melt.deferred_cols[:3]])
    return (cfg, grid, frc, st2, key_alive, cs, melt.deferred_cols[:3],
            port)


def _rows():
    *_, (tcfg, tgrid, tfrc, tst, key_alive, cs, cols) = _world()
    _, rows = ss.build_rows(tst, tgrid, tfrc, tcfg, cols,
                            key_alive=key_alive)
    return torch.stack(rows), cs, ss.cell_tables(tgrid), tcfg


def test_cell_tables_and_weights_match_jax():
    for old in (True, False):
        cfg, grid, *_ = _world(old)
        tcfg, tgrid = _world(old)[-1][:2]
        tbl = ss.cell_tables(tgrid)
        np.testing.assert_array_equal(tbl.numpy(),
                                      np.asarray(jps.cell_tables(grid)))
        rows, cs, _, _ = _rows()
        key = rows[ss.R_KEY].long().clamp(max=NX * NX - 1)
        w = ss._weights_from_rows(rows, tbl[:, key], tcfg)
        jw = jps._weights_from_rows(jnp.asarray(rows.numpy()),
                                    jnp.asarray(tbl[:, key].numpy()), cfg,
                                    jnp.float32)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=2 ** -23)


@pytest.mark.parametrize("window", [None, 128])
def test_segment_sums_plain_match_jax(window):
    cfg = _world()[0]
    rows, cs, tbl, tcfg = _rows()
    S, bad = ss.segment_spread_sums(rows, cs, tbl, tcfg, 3, window=window)
    jS, jbad = jax.jit(functools.partial(
        jps.segment_spread_sums, cfg=cfg, n_extra=3, cell_block=128,
        window=window, interpret=True))(
        jnp.asarray(rows.numpy()), jnp.asarray(cs.numpy()),
        jnp.asarray(tbl.numpy()))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    assert bool(bad.any()) == (window is not None)
    occ = (cs[1:] - cs[:-1]).numpy()
    assert occ.max() >= 40
    S, jS = S.numpy(), np.asarray(jS)
    good = ~np.repeat(np.asarray(jbad), 128)[:NX * NX]
    small = good & (occ <= 2)
    np.testing.assert_array_equal(S[small], jS[small])
    np.testing.assert_allclose(S[good], jS[good], rtol=0,
                               atol=1e-6 * np.abs(jS).max())


def test_coupler_fields_match_jax():
    cfg, grid, frc, st, key_alive, cs, cols, port = _world()
    tcfg, tgrid, tfrc, tst, tkey_alive, tcs, tcols = port
    ncells = NX * NX
    key_s = jnp.where(key_alive, st.jne * NX + st.ine, ncells)
    rank = jnp.arange(st.capacity, dtype=jnp.int32) - cs[
        jnp.minimum(key_s, ncells)]
    jsp, jx = jspread.create_gridded_icebergs_fields(
        st, grid, frc, cfg, sort_ctx=(None, key_s, rank),
        extra_cell_cols=cols, key_alive=key_alive, cell_starts=cs)
    tsp, tx = tspread.create_gridded_icebergs_fields(
        tst, tgrid, tfrc, tcfg, key_alive=tkey_alive, cell_starts=tcs,
        extra_cell_cols=tcols)
    pairs = [(getattr(tsp, f), getattr(jsp, f)) for f in tsp._fields]
    pairs += list(zip(tx, jx))
    for k, (t, j) in enumerate(pairs):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-6 * max(np.abs(j).max(), 1e-30),
                                   err_msg=str(k))
    assert float(np.abs(np.asarray(jsp.spread_mass)).max()) > 0


def _jax_tree_sums(rows, cs, tbl, cfg, K):
    """The JAX package's overflow association on the port's payload
    (``_pallas_spread_sums``' fallback on sorted rows): the row products
    by ``pallas_spread``, then ``_cell_slot_sums_scatter_t``."""
    ncells = tbl.shape[1]
    rows_s = jnp.asarray(rows.numpy())
    key_s = rows_s[ss.R_KEY].astype(jnp.int32)
    tblj = jnp.asarray(tbl.numpy())
    tblrows = tblj[:, jnp.minimum(key_s, ncells - 1)]
    w9 = jps._weights_from_rows(rows_s, tblrows, cfg, jnp.float32)
    area_c = jnp.maximum(tblrows[ss.T_AREA:ss.T_AREA + 1], 1e-30)
    u, v = rows_s[ss.R_U:ss.R_U + 1], rows_s[ss.R_V:ss.R_V + 1]
    LWms = rows_s[ss.R_LWMS:ss.R_LWMS + 1]
    vals = jnp.concatenate([rows_s[ss.R_MASS:ss.R_MASS + 1], LWms,
                            u * LWms, v * LWms])
    P9 = (w9[:, None, :] * vals[None, :, :]).reshape(36, -1)
    w_cell = rows_s[ss.R_MASSMS:ss.R_MASSMS + 1] / area_c
    contribT = jnp.concatenate(
        [P9, w_cell, w_cell * u, w_cell * v,
         rows_s[ss.R_VIRT:ss.R_NFIX], rows_s[ss.R_NFIX:]])
    csj = jnp.asarray(cs.numpy())
    rank = (jnp.arange(key_s.shape[0], dtype=jnp.int32)
            - csj[jnp.minimum(key_s, ncells)])
    return np.asarray(jspread._cell_slot_sums_scatter_t(
        key_s, rank, contribT, ncells, K))


@pytest.mark.parametrize("K", [16, 5])
def test_segment_sums_tree_match_jax(K):
    """At window 128 some block overflows: the port's K3 (plain version)
    takes the slot tree, held bitwise to ``_cell_slot_sums_scatter_t`` on
    every cell (the 40-berg cell puts 25 rows, or with K = 5 36 rows,
    into slot K-1; K = 5 pads the tree's odd levels).  The row products
    are the same float32 operations in both packages and the scatter adds
    each slot's rows in row order, so no ulp is allowed."""
    cfg = dataclasses.replace(_world()[0], reprod_max_per_cell=K)
    rows, cs, tbl, tcfg = _rows()
    tcfg = tcfg.replace(reprod_max_per_cell=K)
    S, bad, nbad = ss.segment_spread_sums_count(rows, cs, tbl, tcfg, 3,
                                                window=128)
    assert int(nbad) == int(bad.sum()) > 0
    assert int((cs[1:] - cs[:-1]).max()) >= 40
    np.testing.assert_array_equal(S.numpy(),
                                  _jax_tree_sums(rows, cs, tbl, cfg, K))
    # the rows given as a list take the same path
    S2, _ = ss.segment_spread_sums(list(rows), cs, tbl, tcfg, 3, window=128)
    assert torch.equal(S, S2)
    # without overflow the sums are sequential, which differ from the tree
    Sq, badq = ss.segment_spread_sums(rows, cs, tbl, tcfg, 3)
    assert not bool(badq.any())
    assert torch.equal(Sq, ss.segment_spread_sums_plain(rows, cs, tbl,
                                                        tcfg))
    assert not torch.equal(Sq, S)


def test_coupler_fields_overflow_match_jax(monkeypatch):
    """Both packages forced to a 128-row window (their module constants,
    read at call time; nothing here is a cached jit): a block overflows,
    the JAX package switches to the slot tree, and the port's coupler
    fields must follow it on every cell: bitwise, but for
    ``ustar_iceberg``, within 2**-23 of its largest magnitude (1 ulp of
    scale), because XLA:CPU fuses the multiply-adds of its ``du*du +
    dv*dv`` and ``dvo*dvo + utide**2``, which the port rounds separately
    (ROADMAP Queue 3).  The sequential sums differ from the tree's on
    the dense cells (by up to ~2.4e-7 of scale) and fail here."""
    monkeypatch.setattr(jspread, "PALLAS_SPREAD_WINDOW", 128)
    monkeypatch.setattr(tspread, "SPREAD_WINDOW", 128)
    cfg, grid, frc, st, key_alive, cs, cols, port = _world()
    tcfg, tgrid, tfrc, tst, tkey_alive, tcs, tcols = port
    ncells = NX * NX
    key_s = jnp.where(key_alive, st.jne * NX + st.ine, ncells)
    rank = jnp.arange(st.capacity, dtype=jnp.int32) - cs[
        jnp.minimum(key_s, ncells)]
    jsp, jx = jspread.create_gridded_icebergs_fields(
        st, grid, frc, cfg, sort_ctx=(None, key_s, rank),
        extra_cell_cols=cols, key_alive=key_alive, cell_starts=cs)
    tsp, tx = tspread.create_gridded_icebergs_fields(
        tst, tgrid, tfrc, tcfg, key_alive=tkey_alive, cell_starts=tcs,
        extra_cell_cols=tcols)
    pairs = [(f, getattr(tsp, f), getattr(jsp, f)) for f in tsp._fields]
    pairs += [(f"extra {k}", t, j) for k, (t, j) in enumerate(zip(tx, jx))]
    for name, t, j in pairs:
        j = np.asarray(j)
        if name == "ustar_iceberg":
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=2 ** -23 * np.abs(j).max(),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert float(np.abs(np.asarray(jsp.spread_mass)).max()) > 0

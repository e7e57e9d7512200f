"""K3 (spread segment sums) and the coupler fields against the JAX package.

Tolerance: a cell with one or two rows sums bit for bit.  Denser cells
agree within 1e-6 of each column's largest magnitude: the JAX kernel
sums a cell's rows with a selection matmul, which in interpret mode on
the CPU runs as an XLA dot whose accumulation order is the library's,
while the port adds a cell's rows strictly in (cell, id) order (the TPU
kernel's order).  Window-overflow flags are exact, including a case
where they are set; there the JAX package itself switches to a tree-sum
fallback whose sums differ from the kernel's only in association.
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

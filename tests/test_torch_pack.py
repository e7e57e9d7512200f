"""K1 (column permute) and the re-sort against the JAX package: the plain
version equals pack_rows_to_lanes -> take -> unpack_lanes_to_rows bit
for bit, at both call sites' index patterns, and so does each entry
(columns handed over as a list, the dead index, the row-major table
gather and the row route); sort_state_by_cell gives the same order,
cell_starts and leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import pallas_pack as jpk
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort
from icebergs_tpu.ops.sorted import uniform_state_fields as jax_uniform

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops.pack import (gather_rows_u32, pack_rows_u32,
                                         permute_cols_u32)
from icebergs_tpu_torch.ops.sorted import (sort_state_by_cell,
                                           uniform_state_fields)

torch.set_num_threads(1)
CPU = torch.device("cpu")


@jax.jit
def _jax_transport(R, idx):
    P = jpk.pack_rows_to_lanes(R, interpret=True)
    return jpk.unpack_lanes_to_rows(jnp.take(P, idx, axis=0), R.shape[0],
                                    interpret=True)


@pytest.mark.parametrize("C", [5, 64, 128])
@pytest.mark.parametrize("site", ["resort", "table"])
def test_permute_matches_pack_take_unpack(C, site):
    rng = np.random.RandomState(C)
    if site == "resort":
        nsrc = n = 700                 # idx = a permutation of the rows
        idx = rng.permutation(n)
    else:
        nsrc, n = 97, 700              # idx = cell keys into a table
        idx = rng.randint(0, nsrc, n)
    bits = rng.randint(-2**31, 2**31, size=(C, nsrc), dtype=np.int64)
    R = bits.astype(np.int32)
    # a few real float and bool columns ride as bit patterns
    R[0] = rng.standard_normal(nsrc).astype(np.float32).view(np.int32)
    R[-1] = rng.randint(0, 2, nsrc)
    ref = np.asarray(_jax_transport(jnp.asarray(R.view(np.uint32)),
                                    jnp.asarray(idx, jnp.int32)))
    out = permute_cols_u32(torch.as_tensor(R),
                           torch.as_tensor(idx.astype(np.int32)))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)


def _random_bits(rng, C, nsrc):
    R = rng.randint(-2**31, 2**31, size=(C, nsrc), dtype=np.int64)
    R = R.astype(np.int32)
    R[0] = rng.standard_normal(nsrc).astype(np.float32).view(np.int32)
    R[-1] = rng.randint(0, 2, nsrc)
    return R


def _as_columns(R):
    """R's rows handed over as K1's callers hold them: separate 1-D
    tensors, columns of a 2-D leaf (strided), and None where a row is
    zero."""
    C, nsrc = R.shape
    leaf = torch.as_tensor(np.ascontiguousarray(R[1:4].T))   # (nsrc, 3)
    cols = [torch.as_tensor(R[0].copy())]
    cols += [leaf[:, b] for b in range(leaf.shape[1])]
    cols += [None if c % 3 == 0 else torch.as_tensor(R[c].copy())
             for c in range(4, C)]
    ref = R.copy()
    for c in range(4, C):
        if c % 3 == 0:
            ref[c] = 0
    return cols, ref


@pytest.mark.parametrize("C", [5, 89])
@pytest.mark.parametrize("entry", ["columns", "dead", "table_rows",
                                   "via_rows", "pack_rows"])
def test_permute_entries_match_pack_take_unpack(C, entry):
    """Each K1 entry bit for bit against the JAX transport: a column
    list (strided columns, None for zeros), idx == nsrc reading 0, the
    row-major table gather (also against the (C, nsrc) column gather of
    the same table), the row route, and the row-major pack against
    pack_rows_to_lanes."""
    rng = np.random.RandomState(C + len(entry))
    nsrc, n = 211, 700
    R = _random_bits(rng, C, nsrc)
    cols, Rz = _as_columns(R)
    idx = rng.randint(0, nsrc + 1, n)         # includes the dead key nsrc
    if entry == "columns":
        idx = np.concatenate([rng.permutation(nsrc)] * 4)[:n]
    Rdead = np.concatenate([Rz, np.zeros((C, 1), np.int32)], axis=1)
    tidx = torch.as_tensor(idx.astype(np.int32))
    if entry == "pack_rows":
        ref = np.asarray(jpk.pack_rows_to_lanes(
            jnp.asarray(Rz.view(np.uint32)), interpret=True))[:, :C]
        out = pack_rows_u32(cols)
        assert out.shape == (nsrc, C)
        np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)
        return
    ref = np.asarray(_jax_transport(jnp.asarray(Rdead.view(np.uint32)),
                                    jnp.asarray(idx, jnp.int32)))
    if entry == "table_rows":
        T = pack_rows_u32(cols)
        out = gather_rows_u32(T, tidx)
        np.testing.assert_array_equal(
            out.numpy(), permute_cols_u32(torch.as_tensor(Rz), tidx).numpy())
    else:
        out = permute_cols_u32(cols, tidx, via_rows=entry == "via_rows")
    assert out.shape == (C, n)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


def test_sort_state_by_cell_matches_jax():
    n, cap = 300, 400
    rng = np.random.RandomState(7)
    grid = ibt.make_uniform_grid(12, 10, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    lon = rng.uniform(0., 12e3, n)
    lat = rng.uniform(0., 10e3, n)
    lon[:30] = 5.5e3                      # a dense cell: id tiebreaks
    lat[:30] = 4.5e3
    st = ibt.create_bergs(cap, lon=lon, lat=lat,
                          uvel=rng.uniform(-1, 1, n), mass=1e9,
                          id_cnt=rng.randint(0, 50, n),
                          id_ij=rng.randint(-5, 5, n))
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    alive = np.asarray(st.alive) & (rng.uniform(size=cap) > 0.1)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, alive=jnp.asarray(alive))
    cfg = ibt.IcebergsConfig()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    assert uniform_state_fields(tcfg) == jax_uniform(cfg)
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    _check_sort(st, grid, tst, tgrid, cfg)


def test_sort_state_by_cell_via_rows_matches_jax():
    """The re-sort by K1's row route (the first sort of a slab in random
    order) against the JAX package."""
    n, cap = 300, 400
    rng = np.random.RandomState(8)
    grid = ibt.make_uniform_grid(12, 10, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    st = ibt.create_bergs(cap, lon=rng.uniform(0., 12e3, n),
                          lat=rng.uniform(0., 10e3, n),
                          vvel=rng.uniform(-1, 1, n), mass=1e9,
                          id_cnt=rng.randint(0, 50, n),
                          id_ij=rng.randint(-5, 5, n))
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    cfg = ibt.IcebergsConfig()
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    _check_sort(st, grid, tst, tgrid, cfg, via_rows=True)


def _check_sort(st, grid, tst, tgrid, cfg, **kw):
    for static in ((), jax_uniform(cfg)):
        js, jcs = jax_sort(st, grid, static_fields=static,
                           packed_permute=True, pack_kernel=True)
        ts, tcs = sort_state_by_cell(tst, tgrid, static_fields=static, **kw)
        np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))
        J, T = _leaves(js), ibp.to_numpy(ts)
        live = J["alive"]
        np.testing.assert_array_equal(T["alive"], live)
        for name, t in T.items():
            # dead rows tie on all three keys; their order is the sort's
            # choice, and they are all-default here except the ids
            np.testing.assert_array_equal(t[live], J[name][live],
                                          err_msg=name)

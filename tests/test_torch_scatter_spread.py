"""The slot-sum spreading methods, thermodynamics' own melt scatters and
the non-reproducing scatters against the JAX package.

World: ``tests/test_torch_spread.py``'s 900 bergs on a 24 x 24 grid with
a 40-berg cell and four rows that die after the sort (their sort key
keeps its cell), so cells denser than ``reprod_max_per_cell`` take each
method's own association.  Both packages get the same state, sort
context and melt columns.

Coupler fields and per-cell sums: bit for bit for ``scatter``,
``scatter_t`` (on the presorted slab and on a slab in random order, whose
slot K-1 adds its rows in the slab's order), ``gather`` and
``gather_raw``, and without ``parallel_reprod`` (one accumulating
scatter, which the CPU runs in row order like XLA:CPU), but for
``ustar_iceberg``, within 2**-23 of its largest magnitude (XLA:CPU fuses
its multiply-adds; see ``test_coupler_fields_overflow_match_jax``).
``gather_mm`` contracts each block with ``einsum`` in both packages, in
library orders that differ: within 1e-6 of each field's largest
magnitude.  Thermodynamics' melt fields (its melt laws round pow / cos
differently) within rtol 1e-5 and 2e-5 of scale, and so is
``thermodynamics``' ``melt_by_class``; ``melt_by_class_field`` on the
same melt rates bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebergs_tpu.ops import spread as jspread
from icebergs_tpu.ops import thermo as jthermo

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import spread as tspread
from icebergs_tpu_torch.ops import thermo as tthermo

from test_torch_spread import NX, _leaves, _world

torch.set_num_threads(1)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _frames(shuffled):
    """(JAX state, key aliveness, port state, port key aliveness,
    config pair) on the sorted slab or on a random order of it."""
    cfg, grid, frc, st, key_alive, cs, cols, port = _world()
    tcfg, tgrid, tfrc, tst, tkey_alive, tcs, tcols = port
    if not shuffled:
        return st, key_alive, cols, tst, tkey_alive, tcols
    perm = np.random.RandomState(9).permutation(st.capacity)
    leaves = {k: v[perm] for k, v in _leaves(st).items()
              if getattr(v, "ndim", 0) >= 1}
    st = st.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    key_alive = jnp.asarray(np.asarray(key_alive)[perm])
    cols = [jnp.asarray(np.asarray(c)[perm]) for c in cols]
    tp = torch.as_tensor(perm)
    return (st, key_alive, cols,
            ibp.state_from_numpy(leaves, device=CPU), tkey_alive[tp],
            [c[tp] for c in tcols])


def _sort_ctx(st, key_alive, tst, tkey_alive, shuffled):
    ncells = NX * NX
    if shuffled:
        return (jspread.make_sort_ctx(st, _world()[1], key_alive),
                tspread.make_sort_ctx(tst, _world()[-1][1], tkey_alive))
    key_s = jnp.where(key_alive, st.jne * NX + st.ine, ncells)
    cs = _world()[5]
    rank = jnp.arange(st.capacity, dtype=jnp.int32) - cs[
        jnp.minimum(key_s, ncells)]
    tkey = torch.as_tensor(np.array(key_s)).to(torch.int32)
    return ((None, key_s, rank),
            (None, tkey, tspread.sorted_ranks(tkey, ncells)))


def _fields(method, K, shuffled, reprod=True):
    cfg, grid, frc, *_ = _world()
    tcfg, tgrid, tfrc = _world()[-1][:3]
    kw = dict(slot_sum_method=method, reprod_max_per_cell=K,
              parallel_reprod=reprod)
    cfg, tcfg = cfg.replace(**kw), tcfg.replace(**kw)
    st, key_alive, cols, tst, tkey_alive, tcols = _frames(shuffled)
    jctx, tctx = (_sort_ctx(st, key_alive, tst, tkey_alive, shuffled)
                  if reprod else (None, None))
    extra = dict(extra_cell_cols=cols) if reprod else {}
    # op by op, as the JAX tests of the spreading run it: under one jit
    # XLA:CPU fuses a product into the scatter-add that consumes it
    jout = jspread.create_gridded_icebergs_fields(st, grid, frc, cfg,
                                                  sort_ctx=jctx, **extra)
    tout = tspread.create_gridded_icebergs_fields(
        tst, tgrid, tfrc, tcfg, sort_ctx=tctx,
        **(dict(extra_cell_cols=tcols) if reprod else {}))
    if not reprod:
        jout, tout = (jout, []), (tout, [])
    (jsp, jx), (tsp, tx) = jout, tout
    pairs = [(f, getattr(tsp, f), getattr(jsp, f)) for f in tsp._fields]
    pairs += [(f"extra {k}", t, j) for k, (t, j) in enumerate(zip(tx, jx))]
    return pairs


@pytest.mark.parametrize("method,K,shuffled", [
    ("scatter", 16, False), ("scatter", 5, True), ("scatter_t", 5, False),
    ("scatter_t", 5, True), ("gather", 5, True), ("gather_raw", 16, True),
    ("gather_mm", 5, True), ("noreprod", 16, True)])
def test_coupler_fields_slot_methods_match_jax(method, K, shuffled):
    reprod = method != "noreprod"
    pairs = _fields(method if reprod else "pallas", K, shuffled, reprod)
    assert len(pairs) == 13 + 3 * reprod
    for name, t, j in pairs:
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1e-30)
        if method == "gather_mm":
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=1e-6 * scale, err_msg=name)
        elif name == "ustar_iceberg":
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=2 ** -23 * scale, err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert float(np.abs(pairs[0][1].numpy()).max()) > 0


def test_slot_methods_differ_on_dense_cells():
    """The associations really differ where a cell holds more than K
    bergs (the 40-berg cell), and agree elsewhere."""
    fields = {m: dict((n, t) for n, t, _ in _fields(m, 5, True))
              for m in ("scatter", "scatter_t", "gather")}
    a, b, c = (fields[m]["mass_on_ocean"] for m in fields)
    assert not torch.equal(a, c) and not torch.equal(a, b)
    near = torch.zeros_like(a, dtype=torch.bool)
    for f in (a, b, c):
        near |= f != a
    assert int(near.sum()) <= 9        # the dense cell's 3x3 footprint


@pytest.mark.parametrize("method,shuffled", [
    ("scatter", False), ("scatter_t", True), ("gather", True),
    ("gather_raw", False), ("gather_mm", True), ("noreprod", True)])
def test_melt_scatters_match_jax(method, shuffled):
    """thermodynamics with its own melt scatters (``defer_cell_cols``
    off, or ``parallel_reprod=False``): the 14 gridded melt fields, on
    the sorted slab or a random order of it, K = 5."""
    cfg, grid, frc, *_ = _world()
    tcfg, tgrid, tfrc = _world()[-1][:3]
    reprod = method != "noreprod"
    kw = dict(parallel_reprod=reprod, reprod_max_per_cell=5,
              slot_sum_method=method if reprod else "pallas")
    cfg, tcfg = cfg.replace(**kw), tcfg.replace(**kw)
    st, key_alive, _, tst, tkey_alive, _ = _frames(shuffled)
    jctx, tctx = (_sort_ctx(st, key_alive, tst, tkey_alive, shuffled)
                  if reprod else (None, None))
    _, jm = jax.jit(lambda s, c: jthermo.thermodynamics(
        s, grid, frc, cfg, sort_ctx=c, defer_cell_cols=False))(
        st.replace(alive=key_alive), jctx)
    _, tm = tthermo.thermodynamics(tst.replace(alive=tkey_alive), tgrid,
                                   tfrc, tcfg, defer_cell_cols=False,
                                   sort_ctx=tctx)
    assert tm.deferred_cols is None
    for name in tthermo.MELT_FIELDS:
        j = np.asarray(getattr(jm, name))
        t = getattr(tm, name).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=2e-5 * max(np.abs(j).max(), 1e-30),
                                   err_msg=name)
    assert np.abs(np.asarray(jm.floating_melt)).max() > 0


def test_melt_by_class_matches_jax():
    """``melt_by_class_field`` on the same melt rates, both hemispheres'
    tables, bit for bit; and ``thermodynamics(with_class_melt=True)``
    returns it."""
    cfg, grid, frc, st, key_alive, cs, cols, port = _world()
    tcfg, tgrid, tfrc, tst, tkey_alive, tcs, tcols = port
    rng = np.random.RandomState(4)
    n = st.capacity
    lat = np.where(rng.uniform(size=n) < .5, -1., 1.) * np.asarray(st.lat)
    start = rng.uniform(5e7, 9e11, n).astype(np.float32)
    rate = rng.uniform(0., 1e-3, n).astype(np.float32)
    for sep in (False, True):
        c = cfg.replace(separate_distrib_for_n_hemisphere=sep)
        js = st.replace(lat=jnp.asarray(lat, jnp.float32),
                        start_mass=jnp.asarray(start))
        j = jthermo.melt_by_class_field(js, grid, c, jnp.asarray(rate),
                                        key_alive)
        ts = tst.replace(lat=torch.as_tensor(lat, dtype=torch.float32),
                         start_mass=torch.as_tensor(start))
        t = tthermo.melt_by_class_field(
            ts, tgrid, tcfg.replace(separate_distrib_for_n_hemisphere=sep),
            torch.as_tensor(rate), tkey_alive)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _, jm = jax.jit(lambda s: jthermo.thermodynamics(
        s, grid, frc, cfg, with_class_melt=True))(st)
    _, tm = tthermo.thermodynamics(tst, tgrid, tfrc, tcfg,
                                   with_class_melt=True)
    j = np.asarray(jm.melt_by_class)
    assert tm.melt_by_class.shape == j.shape == (NX + 2, NX + 2, 10)
    np.testing.assert_allclose(tm.melt_by_class.numpy(), j, rtol=1e-5,
                               atol=2e-5 * np.abs(j).max())
    assert float(tm.melt_by_class.sum()) > 0

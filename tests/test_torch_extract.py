"""K2 (contact extraction) and the fused3 contact closure against the JAX
package.

The plain version of K2 is held to ``contact_extract_sorted_g`` in
interpret mode at the production block / window (128 / 160): bad-block
flags exact everywhere, counts and min / max partner slots exact and
partner features bit for bit on the rows of good blocks (bad blocks are
discarded by both packages).  Worlds: sparse contacts, clustered knots
(>= 3 partners), a cell too dense for the window, blocks whose cell
span is too wide, each edge of the bad rule (window need exactly WL and WL
+ 1, a span of exactly nx - 3 cells and one more; the rule the CUDA
kernel now applies per block) and a partial tail block (N % BN != 0)
after an all-dead one.
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
from icebergs_tpu.ops.fused_contact import make_ia_fn_fused3 as jax_fused3
from icebergs_tpu.ops.pallas_prepass import contact_extract_sorted_g
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import extract
from icebergs_tpu_torch.ops.fused_contact import (contact_features,
                                                  make_ia_fn_fused3)
from torch_k2_boundary import k2_boundary_counts

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX, NY, CAP = 64, 16, 2048
BN, WINDOW = 128, 160
# the "boundary" case: WL = window_lanes(300) = 512, grid rows 0-9
BOUNDARY_WINDOW, BOUNDARY_NY = 300, 10


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0,
                             use_f_plane=True, lat_ref=45., dt=600.,
                             Runge_not_Verlet=False,
                             interactive_icebergs_on=True)
    grid = ibt.make_uniform_grid(NX, NY, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    return cfg, grid


@functools.lru_cache(maxsize=None)
def _boundary():
    """(per-cell counts, the edge blocks) of the "boundary" case."""
    return k2_boundary_counts(NX, BOUNDARY_NY, BN, 1,
                              extract.window_lanes(BOUNDARY_WINDOW))


def _world(case, seed=3):
    """A cell-sorted JAX state for one case."""
    cfg, grid = _setup()
    rng = np.random.RandomState(seed)
    n = {"span": 600, "tail": 1700}.get(case, 1900)
    cap = CAP
    lon = rng.uniform(2e3, 62e3, n)
    lat = rng.uniform(2e3, 14e3, n)
    if case == "tail":                 # 2000 slots: a partial last block
        cap = 2000
    if case == "boundary":
        # the counts of k2_boundary_counts, each berg inside its cell
        counts = _boundary()[0]
        cell = np.repeat(np.arange(counts.size), counts)
        n = cell.size
        cap = -(-(n + BN) // BN) * BN
        lon = (cell % NX + rng.uniform(0.05, 0.95, n)) * 1e3
        lat = (cell // NX + rng.uniform(0.05, 0.95, n)) * 1e3
    if case == "clustered":            # 20 knots of 6 bergs within 100 m
        for k in range(20):
            c = rng.uniform([5e3, 4e3], [59e3, 12e3])
            lon[6 * k:6 * k + 6] = c[0] + rng.uniform(-100, 100, 6)
            lat[6 * k:6 * k + 6] = c[1] + rng.uniform(-100, 100, 6)
    if case == "window":               # one cell denser than the window
        lon[:450] = 30.5e3 + rng.uniform(-400, 400, 450)
        lat[:450] = 8.5e3 + rng.uniform(-400, 400, 450)
    if case == "edge":
        # the top grid row, with a crowd in the last cell: the last
        # block's row-above strip clips to [ncells-1, ncells-1] and
        # repeats that cell, which both packages count twice
        lat[:200] = rng.uniform(15e3, 16e3, 200)
        lon[:200] = rng.uniform(2e3, 64e3, 200)
        lon[:30] = rng.uniform(63e3, 63.99e3, 30)
    st = ibt.create_bergs(cap, lon=lon, lat=lat,
                          uvel=rng.uniform(-.3, .3, n),
                          vvel=rng.uniform(-.3, .3, n),
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=rng.uniform(120., 180., n),
                          mass_scaling=1., id_cnt=np.arange(n) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, lon_old=st.lon,
                    lat_old=st.lat)
    return jax_sort(st, grid)


@functools.lru_cache(maxsize=None)
def _jax_extract(window=WINDOW):
    cfg, grid = _setup()
    return jax.jit(functools.partial(
        contact_extract_sorted_g, grid=grid, cfg=cfg, block_n=BN,
        window=window, interpret=True))


@pytest.mark.parametrize("case", ["sparse", "clustered", "window", "span",
                                  "edge", "boundary", "tail"])
def test_extract_plain_matches_jax(case):
    cfg, grid = _setup()
    js, jcs = _world(case)
    window = BOUNDARY_WINDOW if case == "boundary" else WINDOW
    tst = ibp.state_from_numpy(_leaves(js), device=CPU)
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    PT, key_s = contact_features(tst, tgrid, tcfg)
    cs = torch.as_tensor(np.array(jcs))
    out, bad = extract.extract_sorted(PT, key_s, cs, tgrid, tcfg,
                                      block_n=BN, window=window)
    jout, jbad = _jax_extract(window)(jnp.asarray(PT.numpy()),
                                jnp.asarray(key_s.numpy()),
                                jnp.asarray(np.asarray(jcs)))
    jout, jbad = np.asarray(jout), np.asarray(jbad)
    out, bad = out.numpy(), bad.numpy()
    np.testing.assert_array_equal(bad, jbad)
    good = ~bad
    np.testing.assert_array_equal(out[:, good], jout[:, good])

    cnt = out[extract.EX_CNT][good & np.asarray(js.alive)]
    if case == "sparse":
        assert (cnt == 1).sum() > 20 and (cnt == 2).sum() > 0
        # only the block holding the last live rows and the dead tail
        assert bad.sum() <= BN
    elif case == "clustered":
        assert (cnt >= 3).sum() >= 60
    elif case == "edge":
        c_lo, c_hi, _ = extract.block_tables(key_s, cs, NX, NY, BN, WINDOW)
        last = NX * NY - 1
        dup = ((c_lo[:, 2] == last) & (c_hi[:, 1] == last)
               & ~torch.as_tensor(bad[::BN]))
        assert bool(dup.any())
    elif case == "window":
        c_lo, c_hi, bflag = extract.block_tables(key_s, cs, NX, NY, BN,
                                                 WINDOW)
        span = ((c_hi[:, 1] - 1) - (c_lo[:, 1] + 1)) > NX - 3
        assert bflag.any() and not span[bflag].all()
    elif case == "boundary":
        # the edge blocks' flags: need WL good, WL + 1 bad, span nx - 3
        # good, nx - 2 bad (k2_boundary_counts holds their need and span)
        blocks = _boundary()[1]
        assert [bool(bad[blocks[k] * BN]) for k in ("wl", "wl+1", "span",
                                                    "span+1")] == [
            False, True, False, True]
        assert (cnt > 0).sum() > 1000
    elif case == "tail":
        # the last block holds 80 dead rows, the one before only dead rows
        assert PT.shape[1] % BN == 80
        assert not bool(tst.alive[-80 - BN:].any())
    else:                              # every block with live rows
        assert bad[np.asarray(js.alive)].all()


# fallback cap / strip width per case: the dense cell sends its whole
# window-bad neighbourhood to the exact fallback
_FALLBACK = {"clustered": (512, 64), "window": (CAP, 512)}


@functools.lru_cache(maxsize=None)
def _jax_ia(case):
    cfg, grid = _setup()
    js, jcs = _world(case)
    cap, width = _FALLBACK[case]

    @jax.jit
    def run(st, cs):
        ia_fn, stats = jax_fused3(st, grid, cfg, block_n=BN, window=WINDOW,
                                  fallback_cap=cap,
                                  fallback_strip_width=width,
                                  presorted=True, cell_starts=cs,
                                  interpret=True)
        return ia_fn(st.uvel * 0.5, st.vvel * 0.5), stats

    return run(js, jcs)


@pytest.mark.parametrize("case", sorted(_FALLBACK))
def test_fused3_closure_matches_jax(case):
    """The whole fused3 closure (K2 + normal pairs + exact fallback +
    fold).  Counters exact.  IA sums within rtol 1e-5 and 1e-6 of each
    field's largest magnitude: XLA:CPU contracts multiply-adds into FMAs
    (a 1-ulp difference per pair term), and the fallback's 192-candidate
    sums reduce in another order."""
    cfg, grid = _setup()
    js, jcs = _world(case)
    jia, jstats = _jax_ia(case)
    tst = ibp.state_from_numpy(_leaves(js), device=CPU)
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    cap, width = _FALLBACK[case]
    ia_fn, stats = make_ia_fn_fused3(
        tst, tgrid, tcfg, block_n=BN, window=WINDOW, fallback_cap=cap,
        fallback_strip_width=width,
        cell_starts=torch.as_tensor(np.array(jcs)))
    ia = ia_fn(tst.uvel * 0.5, tst.vvel * 0.5)
    assert int(stats.overflow) == int(jstats.overflow) == 0
    assert int(stats.n_fallback) == int(jstats.n_fallback) > 0
    live = np.asarray(js.alive)
    for name in ia._fields:
        j = np.asarray(getattr(jia, name))[live]
        t = getattr(ia, name).numpy()[live]
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max(),
                                   err_msg=name)

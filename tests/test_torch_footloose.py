"""The port's footloose calving against the JAX package: no calving
without a foot, the children (new bergs) and the binned footloose bits
of both styles with the JAX package's own per-berg uniforms plugged in,
the promotion of bits into a berg, the deletion of fully calved
elements, the children's interactivity over the sorted strip tables and
the bucket tables, thermodynamics' footloose branches, 4 per-step steps
of ``make_multi_step`` with footloose on, and the default hash uniforms'
independence of the slab's layout.

Tolerance: ``rtol 1e-5`` plus 1e-5 of each field's largest magnitude.
XLA:CPU and torch round ``x ** 0.25`` (the buoyancy length) an ulp
apart on some bergs, and a child's size follows from it.  Slots, ids,
cells, fl_k's states and the counters are exact.  The per-step steps
take ``tests/test_torch_perstep.py``'s tolerance (2e-5 of scale).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import footloose as jfl
from icebergs_tpu import model as jmodel
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.ops import sorted as jsorted
from icebergs_tpu.ops import thermo as jthermo

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import footloose as tfl
from icebergs_tpu_torch.ops import forces as tforces
from icebergs_tpu_torch.ops import sorted as tsorted
from icebergs_tpu_torch.ops import thermo as tthermo

from test_torch_api import _world as _coupled_world
from test_torch_perstep import assert_steps_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 1e-5
INTS = ("alive", "id_cnt", "id_ij", "ine", "jne", "start_year",
        "conglom_id", "bond_idx", "bond_broken")


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def assert_state(T, J, exact=()):
    """Integers (and ``exact`` floats) equal; floats within tolerance."""
    for name, t in T.items():
        j = J[name]
        if name in INTS or name in exact or t.dtype.kind != "f":
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            scale = np.abs(j).max() if j.size else 0.
            np.testing.assert_allclose(t, j, rtol=RTOL,
                                       atol=ATOL_SCALE * scale,
                                       err_msg=name)


def _cfg(**kw):
    base = dict(grid_is_latlon=False, Lx=-1., use_f_plane=True,
                lat_ref=-60., dt=1800., Runge_not_Verlet=False,
                footloose=True, fl_style="new_bergs", fl_youngs=1.e8,
                fl_strength=250., allow_bergs_to_roll=True,
                interactive_icebergs_on=True)
    base.update(kw)
    return ibt.IcebergsConfig(**base)


def _world(cfg, n=60, cap=160, seed=0, foot=True):
    """Tabular bergs on a 16x16 grid of 5 km cells (a zero-area column, so
    that some children fall back onto their parents), every third with a
    primed foot, every fifth with footloose bits past the promotion
    threshold, a few static, and dead slots among the live ones."""
    grid = ibt.make_uniform_grid(16, 16, 0., 0., 5000., 5000.,
                                 grid_is_latlon=False)
    area = np.asarray(grid.area).copy()
    area[14, :] = 0.                       # cells (13, j)
    grid = grid.replace(area=jnp.asarray(area))
    rng = np.random.RandomState(seed)
    k = np.arange(n)
    lon = rng.uniform(8e3, 64.5e3, n)
    lat = rng.uniform(8e3, 72e3, n)
    lon[:6] = rng.uniform(63.6e3, 64.45e3, 6)       # by the zero column
    st = ibt.create_bergs(
        cap, lon=lon, lat=lat, thickness=rng.uniform(150., 300., n),
        width=rng.uniform(1.5e3, 4e3, n), length=rng.uniform(4e3, 9e3, n),
        mass=850. * 250 * 3e3 * 6e3, mass_scaling=rng.uniform(1., 3., n),
        id_cnt=k + 1, id_ij=k % 7 + 3,
        fl_k=np.where(k % 3 == 0, rng.uniform(1e5, 6e6, n), 0.)
        if foot else 0.,
        mass_of_fl_bits=np.where(k % 5 == 1, rng.uniform(2e11, 9e11, n), 0.)
        if foot else 0.,
        mass_of_fl_bergy_bits=np.where(k % 5 == 1, 3e9, 0.),
        static_berg=np.where(k % 11 == 4, 1., 0.),
        fl_spawn_count=k % 4, uvel=rng.uniform(-.2, .2, n),
        vvel=rng.uniform(-.2, .2, n))
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    alive = np.asarray(st.alive).copy()
    alive[rng.permutation(n)[:8]] = False
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, alive=jnp.asarray(alive))
    return grid, st


def _port(cfg, grid, st):
    return (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))


def jax_uniforms(key, style):
    """The port's ``uniforms(stream, st)`` drawing what the JAX
    ``footloose_calving(key)`` draws, each folded from the berg's id
    (``_id_uniform``): with ``new_bergs`` stream 0 (the children) from
    the first split of ``key`` and stream 1 (the promotion) from the
    second; the other styles split once, for the promotion."""
    k, s0 = jax.random.split(key)
    _, s1 = jax.random.split(k)
    keys = (s0, s1) if style == "new_bergs" else (None, s0)

    def uniforms(stream, st):
        ids = SimpleNamespace(id_cnt=jnp.asarray(st.id_cnt.numpy()),
                              id_ij=jnp.asarray(st.id_ij.numpy()))
        return torch.tensor(np.asarray(jfl._id_uniform(keys[stream], ids,
                                                       jnp.float32)))
    return uniforms


def _run_both(cfg, grid, st, key=3):
    key = jax.random.PRNGKey(key)
    js, jd = jfl.footloose_calving(st, grid, cfg, key, current_year=2003,
                                   current_yearday=jnp.float32(12.25))
    tcfg, tgrid, tst = _port(cfg, grid, st)
    ts, td = tfl.footloose_calving(tst, tgrid, tcfg,
                                   uniforms=jax_uniforms(key, cfg.fl_style),
                                   current_year=2003,
                                   current_yearday=torch.tensor(12.25))
    return (js, jd), (ts, td)


def test_no_calving_without_a_foot():
    cfg = _cfg()
    grid, st = _world(cfg, foot=False)
    (js, jd), (ts, td) = _run_both(cfg, grid, st)
    assert int(td.nbergs_calved_fl) == int(jd.nbergs_calved_fl) == 0
    assert int(td.spawn_overflow) == 0
    assert_state(ibp.to_numpy(ts), _leaves(st), exact=("fl_k", "mass"))
    assert float(td.fl_bits_src.abs().sum()) == 0.


@pytest.mark.parametrize("style", ["new_bergs", "fl_bits"])
@pytest.mark.parametrize("displace", [True, False])
@pytest.mark.parametrize("cap", [160, 64], ids=["room", "full"])
def test_footloose_calving_matches_jax(style, displace, cap):
    """Part 1 of the mechanism on the primed world: the parents' k and
    shrink, the children (``new_bergs``) or the bits binned into cells
    (``fl_bits``), then the promotion of the bits past the threshold;
    with 64 slots the requests outnumber the dead slots."""
    cfg = _cfg(fl_style=style, displace_fl_bergs=displace)
    grid, st = _world(cfg, n=60 if cap == 160 else 58, cap=cap)
    (js, jd), (ts, td) = _run_both(cfg, grid, st)
    for f in ("nbergs_calved_fl", "spawn_overflow"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f
    assert int(td.nbergs_calved_fl) > 3
    assert (int(td.spawn_overflow) > 0) == (cap == 64)
    assert_state(ibp.to_numpy(ts), _leaves(js))
    src, jsrc = td.fl_bits_src.numpy(), np.asarray(jd.fl_bits_src)
    np.testing.assert_allclose(src, jsrc, rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(jsrc).max())
    if style == "fl_bits":
        assert np.abs(jsrc).max() > 0.
    for f in ("fl_to_berg_kg", "flb_to_bergy_kg"):
        np.testing.assert_allclose(float(getattr(td, f)),
                                   float(getattr(jd, f)), rtol=RTOL)
    if cap == 160:
        assert float(td.fl_to_berg_kg) > 0.


def test_delete_fully_fl_calved_matches_jax():
    cfg = _cfg()
    grid, st = _world(cfg)
    flk = np.asarray(st.fl_k).copy()
    flk[::4] = -3.
    st = st.replace(fl_k=jnp.asarray(flk))
    js, jn = jfl.delete_fully_fl_calved(st)
    ts, tn = tfl.delete_fully_fl_calved(_port(cfg, grid, st)[2])
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def _children_world(cfg):
    """Newborn children (fl_k -1) beside parents and alone."""
    grid, st = _world(cfg, foot=False)
    rng = np.random.RandomState(9)
    flk = np.asarray(st.fl_k).copy()
    lon, lat = np.asarray(st.lon).copy(), np.asarray(st.lat).copy()
    flk[:40:2] = -1.
    # some of the children touch their neighbour in the slab
    lon[1:32:4] = lon[0:32:4] + rng.uniform(50., 400., 8)
    lat[1:32:4] = lat[0:32:4]
    st = st.replace(fl_k=jnp.asarray(flk), lon=jnp.asarray(lon),
                    lat=jnp.asarray(lat), width=st.width * 0.2,
                    length=st.length * 0.1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    return grid, st.replace(ine=i, jne=j, xi=xi, yj=yj)


@pytest.mark.parametrize("tables", ["sorted_strips", "buckets"])
def test_interactivity_promotion_matches_jax(tables):
    """adjust_fl_berg_interactivity: -1 children out of contact range of
    every candidate become -2, exactly as in the JAX package, over the
    sorted strip tables (the fused and sorted modes' walk) and the
    bucket tables."""
    cfg = _cfg(contact_distance=300.)
    grid, st = _children_world(cfg)
    tcfg, tgrid, tst = _port(cfg, grid, st)
    if tables == "sorted_strips":
        st, cs = jsorted.sort_state_by_cell(st, grid)
        nbr = jsorted.strip_neighbor_tables(st, grid, cfg, cs)
        tst, tcs = tsorted.sort_state_by_cell(tst, tgrid)
        tnbr = tsorted.strip_neighbor_tables(tst, tgrid, tcfg, tcs)
    else:
        nbr = jforces.build_neighbor_tables(st, grid, cfg, max_per_cell=16)
        tnbr = tforces.build_neighbor_tables(tst, tgrid, tcfg,
                                             max_per_cell=16)
    js = jfl.adjust_fl_berg_interactivity(st, nbr, cfg)
    ts = tfl.adjust_fl_berg_interactivity(tst, tnbr, tcfg)
    flk = ts.fl_k.numpy()
    np.testing.assert_array_equal(flk, np.asarray(js.fl_k))
    alive = ts.alive.numpy()
    assert ((flk == -2.) & alive).sum() >= 3
    assert ((flk == -1.) & alive).sum() >= 3


def _thermo_world(cfg):
    """Warm, windy water: the feet grow; small bergs with footloose bits
    melt away and their bits become a berg."""
    grid, st = _world(cfg)
    n = st.capacity
    k = np.arange(n)
    small = (k % 9 == 2)
    st = st.replace(
        thickness=jnp.where(small, 0.3, st.thickness),
        width=jnp.where(small, 0.1, st.width),
        length=jnp.where(small, 0.12, st.length),
        mass=jnp.where(small, 3., st.mass),
        mass_of_fl_bits=jnp.where(small, 4e8, st.mass_of_fl_bits),
        fl_k=jnp.where(k % 3 == 1, 0., st.fl_k))
    frc = ibt.uniform_forcing(16, 16, uo=0.1, ua=14.0, sst=4.0, sss=33.)
    return grid, frc, st


@pytest.mark.parametrize("split", [True, False],
                         ids=["operator_split", "classic"])
def test_thermodynamics_footloose_matches_jax(split):
    """thermodynamics with footloose on: fl_k accumulates the foot's area
    (icebergs.F90:3016-3036) and a melted parent's bits become a berg
    with fl_k -1 (3225-3262)."""
    cfg = _cfg(use_operator_splitting=split, parallel_reprod=False)
    grid, frc, st = _thermo_world(cfg)
    from icebergs_tpu.model import interp_to_bergs
    st = interp_to_bergs(st, grid, frc, cfg)
    js, jm = jthermo.thermodynamics(st, grid, frc, cfg)
    tcfg, tgrid, tst = _port(cfg, grid, st)
    tfrc = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    ts, tm = tthermo.thermodynamics(tst, tgrid, tfrc, tcfg,
                                    defer_cell_cols=False)
    assert int(tm.nbergs_melted) == int(jm.nbergs_melted) > 0
    T, J = ibp.to_numpy(ts), _leaves(js)
    assert_state(T, J)
    live = T["alive"]
    st0 = _leaves(st)
    grew = live & (st0["fl_k"] >= 0.) & (T["fl_k"] > st0["fl_k"])
    assert grew.sum() > 5
    promoted = live & (T["fl_k"] == -1.)
    assert promoted.sum() > 0
    np.testing.assert_array_equal(promoted, J["alive"] & (J["fl_k"] == -1.))


@pytest.mark.parametrize("style", ["new_bergs", "fl_bits"])
def test_footloose_steps_match_jax(style):
    """4 per-step coupling steps (fused3 contacts) with footloose on:
    ``make_step``'s footloose branch (the calving, the deletion of fully
    calved elements, the children's interactivity over the bucket
    tables) against the JAX ``make_multi_step``, whose step draws from
    ``PRNGKey(0)`` each step; the port takes those uniforms.  A few
    bergs start marked fully calved (fl_k -3), so the deletion runs."""
    cfg, grid, frc, st, _, _ = _coupled_world(style)
    k = jnp.arange(st.capacity)
    st = st.replace(fl_k=jnp.where(k % 11 == 5, -3., st.fl_k))
    kw = dict(persistent=False, neighbor_mode="fused3", fused_block_n=16)
    jout = jmodel.make_multi_step(grid, cfg, 4, True, fused_interpret=True,
                                  **kw)(st, frc)
    tcfg, tgrid, tst = _port(cfg, grid, st)
    tfrc = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    step = ibp.make_step(tgrid, tcfg, neighbor_mode="fused3",
                         fused_block_n=16)
    unif = jax_uniforms(jax.random.PRNGKey(0), style)
    zero = torch.zeros((), dtype=torch.int32)
    ov, fb = zero, zero
    acc = torch.zeros(grid.nx + 2, grid.ny + 2)
    calved = deleted = 0
    for _ in range(4):
        tst, d = step(tst, tfrc, fl_uniforms=unif)
        deleted += int(d.nbergs_deleted_fl)
        ov = torch.maximum(ov, d.contact_overflow)
        fb = torch.maximum(fb, d.contact_fallback)
        for f in (d.spread_mass, d.spread_area, d.ustar_iceberg,
                  d.mass_on_ocean, d.floating_melt, d.calving_hflx,
                  d.u_iceberg, d.v_iceberg):
            acc = acc + f
        calved += int(d.nbergs_calved_fl)
        assert int(d.fl_spawn_overflow) == 0
    assert calved > 0 and deleted == 4
    assert_steps_close((tst, ov, fb, acc), jout)


def test_default_uniforms_are_layout_invariant():
    """The default hash (:func:`id_hash_uniforms`) gives each id the same
    uniform in any slot: the slab permuted, every child (found by its id)
    is the same bit for bit."""
    cfg = _cfg(fl_style="new_bergs")
    grid, st = _world(cfg)
    tcfg, tgrid, tst = _port(cfg, grid, st)
    perm = torch.as_tensor(np.random.RandomState(1).permutation(
        tst.capacity))
    pst = tst.replace(**{f: getattr(tst, f)[perm] for f in
                         ("alive",) + tuple(
                             f.name for f in dataclasses.fields(tst)
                             if f.name != "alive")})
    outs = []
    for s in (tst, pst):
        o, d = tfl.footloose_calving(
            s, tgrid, tcfg, uniforms=tfl.id_hash_uniforms(11, 4))
        outs.append(ibp.to_numpy(o))
        assert int(d.nbergs_calved_fl) > 3
    by_id = []
    for o in outs:
        live = np.nonzero(o["alive"])[0]
        keys = o["id_cnt"][live].astype(np.int64) << 32 | o["id_ij"][live]
        order = live[np.argsort(keys)]
        by_id.append({f: v[order] for f, v in o.items()
                      if v.ndim == 1})
    for f, v in by_id[0].items():
        np.testing.assert_array_equal(v, by_id[1][f], err_msg=f)
    u = tfl.id_hash_uniforms(11, 4)(0, tst)
    assert float(u.min()) >= 0. and float(u.max()) < 1.
    assert not torch.equal(u, tfl.id_hash_uniforms(11, 5)(0, tst))
    assert not torch.equal(u, tfl.id_hash_uniforms(11, 4)(1, tst))

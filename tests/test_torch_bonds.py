"""Bonded springs outside MTS against the JAX package: the bonded and
``use_c_crit_dist`` pair data on the legacy dispatch (bonds pull only
when over-stretched) and on the modern one (``contact_distance``), in
both layouts; ``make_ia_fn`` with its bond and same-conglomerate groups
over the bucket and the sorted strip tables, the fused3 closure with its
bond group; ``check_bond_reciprocity``; and 4 per-step fused3 steps of a
bonded world at the reference's dt of 60 s.

Tolerance: ``rtol 1e-5`` plus 1e-5 of each field's scale for the pair
data and the closures (one-shot: the terms are the same, the sums'
orders differ, XLA:CPU contracts multiply-adds), 2e-5 of scale for the
steps (``tests/test_torch_step.py``'s).  Masks, counts exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import model as jmodel
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.ops import fused_contact as jfused
from icebergs_tpu.ops import sorted as jsorted

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import forces as tforces
from icebergs_tpu_torch.ops import fused_contact as tfused
from icebergs_tpu_torch.ops import sorted as tsorted

from test_torch_perstep import assert_steps_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 1e-5
DISPATCH = {"legacy": {}, "modern": dict(contact_distance=300.)}


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _close(t, j, name, atol_scale=ATOL_SCALE):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = np.abs(j).max() if j.size else 0.
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=atol_scale * scale,
                               err_msg=name)


def _world(dispatch="legacy", seed=3, dt=60.):
    """Two bonded rafts (6x5 bergs 195 m apart, ``initialize_bonds_host``
    by radius) and a dense one (5x5, 120 m apart: more neighbours within
    the bond radius than ``max_bonds``, so unbonded members of one
    conglomerate touch) among loose bergs on a 14x14 grid of 1 km cells.
    The rafts' positions are jittered by up to 12 m after bonding, so
    that some bonds are over-stretched and some compressed."""
    cfg = ibt.IcebergsConfig(
        grid_is_latlon=False, Lx=-1., use_f_plane=True, lat_ref=-60.,
        dt=dt, Runge_not_Verlet=False, use_new_predictive_corrective=True,
        interactive_icebergs_on=True, iceberg_bonds_on=True, max_bonds=6,
        manually_initialize_bonds=True,
        manually_initialize_bonds_from_radii=True, fused_fallback_cap=512,
        **DISPATCH[dispatch])
    grid = ibt.make_uniform_grid(14, 14, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    frc = ibt.uniform_forcing(14, 14, uo=0.15, vo=-0.05, ua=6., sst=-1.,
                              sss=34.)
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(6) * 195., np.arange(5) * 195.)
    rafts = [np.stack([xs.ravel() + x0, ys.ravel() + y0], 1)
             for x0, y0 in ((3.1e3, 3.3e3), (7.4e3, 8.2e3))]
    xd, yd = np.meshgrid(np.arange(5) * 120., np.arange(5) * 120.)
    rafts.append(np.stack([xd.ravel() + 9.3e3, yd.ravel() + 2.6e3], 1))
    loose = rng.uniform(2e3, 12e3, (90, 2))
    pos = np.concatenate(rafts + [loose])
    n = len(pos)
    st = ibt.create_bergs(320, lon=pos[:, 0], lat=pos[:, 1],
                          uvel=rng.uniform(-.1, .1, n),
                          vvel=rng.uniform(-.1, .1, n),
                          mass=850. * 40. * 200. * 200., thickness=40.,
                          width=200., length=200., max_bonds=6,
                          id_cnt=rng.permutation(n) + 1)
    st = jforces.initialize_bonds_host(st, cfg)
    jit = np.zeros((st.capacity, 2))
    jit[:85] = rng.uniform(-12., 12., (85, 2))
    st = st.replace(lon=st.lon + jit[:, 0], lat=st.lat + jit[:, 1])
    st = st.replace(lon_old=st.lon, lat_old=st.lat, uvel_old=st.uvel,
                    vvel_old=st.vvel)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    port = (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))
    return cfg, grid, frc, st, port


def _assert_pd(tpd, jpd):
    np.testing.assert_array_equal(tpd.active.numpy(), np.asarray(jpd.active))
    for f in ("IA_x", "IA_y", "P11", "P12", "P22", "crad", "ctan", "u2",
              "v2"):
        _close(getattr(tpd, f).numpy(), getattr(jpd, f), f)


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
@pytest.mark.parametrize("group", ["bonded", "c_crit"])
def test_pair_data_matches_jax(dispatch, group):
    """The bond table's pair data (``bonded=True``) and the
    same-conglomerate contact pairs' (``use_c_crit_dist=True``), (N, M)
    and (M, N)."""
    cfg, grid, _, st, (tcfg, tgrid, _, tst) = _world(dispatch)
    if group == "bonded":
        other, mask = jforces.bond_partner_table(st)
        tother, tmask = tforces.bond_partner_table(tst)
        kw = dict(bonded=True, use_c_crit_dist=False)
    else:
        nbr = jforces.build_neighbor_tables(st, grid, cfg, max_per_cell=12)
        tnbr = tforces.build_neighbor_tables(tst, tgrid, tcfg,
                                             max_per_cell=12)
        other, mask = nbr.cand_idx, nbr.cand_valid & ~nbr.is_bond_partner
        tother = tnbr.cand_idx
        tmask = tnbr.cand_valid & ~tnbr.is_bond_partner
        kw = dict(bonded=False, use_c_crit_dist=True)
    np.testing.assert_array_equal(tother.numpy(), np.asarray(other))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    jpd = jforces.precompute_pair_data(st, cfg, other, mask, **kw)
    tpd = tforces.precompute_pair_data(tst, tcfg, tother, tmask, **kw)
    _assert_pd(tpd, jpd)
    nact = int(tpd.active.sum())
    if group == "bonded" and dispatch == "legacy":
        # only the over-stretched bonds pull
        assert 0 < nact < int(tmask.sum())
    else:
        assert nact > 10
    jpdT = jforces.precompute_pair_data_T(st, cfg, other.T, mask.T, **kw)
    tpdT = tforces.precompute_pair_data_T(tst, tcfg, tmask.T.contiguous(),
                                          other_T=tother.T.contiguous(),
                                          **kw)
    _assert_pd(tpdT, jpdT)


def _velocities(tst):
    g = torch.Generator().manual_seed(5)
    return (tst.uvel + 0.02 * torch.randn(tst.capacity, generator=g),
            tst.vvel - 0.02 * torch.randn(tst.capacity, generator=g))


@pytest.mark.parametrize("mode,dispatch", [
    ("buckets", "legacy"), ("buckets", "modern"), ("sorted", "legacy"),
    ("sorted", "modern"), ("fused3", "legacy")])
def test_make_ia_fn_with_bonds_matches_jax(mode, dispatch):
    """The interactive-force closures with the bond group (and, on the
    modern dispatch, the same-conglomerate group): every IA field."""
    cfg, grid, _, st, (tcfg, tgrid, _, tst) = _world(dispatch)
    if mode == "sorted":
        st, cs = jsorted.sort_state_by_cell(st, grid)
        tst, tcs = tsorted.sort_state_by_cell(tst, tgrid)
    u1, v1 = _velocities(tst)
    if mode == "fused3":
        jfn, jstats = jfused.make_ia_fn_fused3(
            st, grid, cfg, block_n=16, window=cfg.fused_window,
            fallback_cap=512, fallback_strip_width=64, interpret=True)
        tfn, tstats = tfused.make_ia_fn_fused3(
            tst, tgrid, tcfg, block_n=16, window=cfg.fused_window,
            fallback_cap=512, fallback_strip_width=64, presorted=False)
        assert int(tstats.overflow) == int(jstats.overflow) == 0
        assert int(tstats.n_fallback) == int(jstats.n_fallback)
    else:
        r = jforces.neighbor_radius(grid, cfg)
        assert r == tforces.neighbor_radius(tgrid, tcfg)
        if mode == "sorted":
            nbr = jsorted.strip_neighbor_tables(st, grid, cfg, cs,
                                                strip_width=48,
                                                ncells_radius=r)
            tnbr = tsorted.strip_neighbor_tables(tst, tgrid, tcfg, tcs,
                                                 strip_width=48,
                                                 ncells_radius=r)
        else:
            nbr = jforces.build_neighbor_tables(st, grid, cfg,
                                                max_per_cell=16,
                                                ncells_radius=r)
            tnbr = tforces.build_neighbor_tables(tst, tgrid, tcfg,
                                                 max_per_cell=16,
                                                 ncells_radius=r)
        jfn = jforces.make_ia_fn(st, nbr, cfg)
        tfn = tforces.make_ia_fn(tst, tnbr, tcfg)
    jia = jfn(jnp.asarray(u1.numpy()), jnp.asarray(v1.numpy()))
    tia = tfn(u1, v1)
    for f, t, j in zip(tia._fields, tia, jia):
        _close(t.numpy(), j, f)
    assert float(tia.IA_x.abs().max()) > 0.


def test_check_bond_reciprocity_matches_jax():
    cfg, grid, _, st, (_, _, _, tst) = _world()
    # the dense raft's bergs keep their first max_bonds partners only, so
    # some bonds already have no back-bond
    n0 = int(tforces.check_bond_reciprocity(tst))
    assert n0 == int(jforces.check_bond_reciprocity(st)) > 0
    bidx = np.asarray(st.bond_idx).copy()
    rows = np.nonzero(bidx[:, 0] >= 0)[0][:7]
    bidx[rows, 0] = -1                   # the partners keep their bond
    st = st.replace(bond_idx=jnp.asarray(bidx))
    tst = tst.replace(bond_idx=torch.as_tensor(bidx))
    n = int(tforces.check_bond_reciprocity(tst))
    assert n == int(jforces.check_bond_reciprocity(st)) != n0


def test_bonded_fused3_steps_match_jax():
    """4 per-step fused3 steps with the bond group (the legacy KID bonds
    at dt 60 s, ``tests/test_interactions.py:75-82``)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _world()
    kw = dict(persistent=False, neighbor_mode="fused3", fused_block_n=16)
    jout = jmodel.make_multi_step(grid, cfg, 4, True, fused_interpret=True,
                                  **kw)(st, frc)
    tout = ibp.make_multi_step(tgrid, tcfg, 4, True, **kw)(tst, tfrc)
    assert int(tout[1]) == 0
    assert_steps_close(tout, jout)


@pytest.mark.parametrize("mode", ["fused3", "fused"])
def test_bonded_persistent_steps_match_jax(mode):
    """4 steps of the default route of the bonded legacy config: the
    persistent lane, where the slab is re-sorted by cell every step and
    ``bond_idx`` is remapped with it (fused3 presorted, or the fused
    closure on the sorted slab)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _world()
    kw = dict(neighbor_mode=mode, fused_block_n=16)
    jout = jmodel.make_multi_step(grid, cfg, 4, True, fused_interpret=True,
                                  **kw)(st, frc)
    tout = ibp.make_multi_step(tgrid, tcfg, 4, True, **kw)(tst, tfrc)
    assert int(tout[1]) == 0
    assert_steps_close(tout, jout)
    T = ibp.to_numpy(tout[0])
    key = np.where(T["alive"], T["jne"] * 14 + T["ine"], 14 * 14)
    assert np.all(np.diff(key) >= 0), "the persistent lane ran"
    # the partners by id agree: the remapped bond_idx points at the same
    # bergs as the JAX package's
    J = _leaves(jout[0])
    for D in (T, J):
        b = D["bond_idx"]
        D["partner_id"] = np.where(b >= 0, D["id_cnt"][np.maximum(b, 0)], -1)
    tp = {int(i): tuple(sorted(p)) for i, p, a in
          zip(T["id_cnt"], T["partner_id"], T["alive"]) if a}
    jp = {int(i): tuple(sorted(p)) for i, p, a in
          zip(J["id_cnt"], J["partner_id"], J["alive"]) if a}
    assert tp == jp
    assert sum(len([x for x in p if x >= 0]) for p in tp.values()) > 100

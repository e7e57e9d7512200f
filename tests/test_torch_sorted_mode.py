"""The ``sorted`` neighbour mode against the JAX package: the strip
tables of a (cell, id)-sorted slab exactly (candidate slots, validity
and the bond-partner flag, at radius 1 and 2), and 4 per-step steps of
``neighbor_mode="sorted"`` on the clustered world of
``tests/test_torch_perstep.py`` (the port's pairs evaluated through K7,
the JAX package's through its XLA twin).

Tolerance of the steps (floats, per berg id): ``rtol 1e-5`` plus 2e-5 of
each field's scale, that of ``tests/test_torch_step.py`` (XLA:CPU
contracts multiply-adds; the contact springs amplify those ulps);
integers and counters exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import model as jmodel
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.ops import sorted as jsorted

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import sorted as tsorted

from test_torch_perstep import _world, assert_steps_close

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _bonded_world(seed=2):
    """Rafts of bonded bergs (``initialize_bonds_host``) among loose ones
    on a 12x12 grid of 1 km cells; some cells hold 20 bergs."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.,
                             interactive_icebergs_on=True,
                             iceberg_bonds_on=True, max_bonds=6,
                             manually_initialize_bonds=True,
                             manually_initialize_bonds_from_radii=True)
    grid = ibt.make_uniform_grid(12, 12, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(6) * 190., np.arange(5) * 190.)
    rafts = [np.stack([xs.ravel() + x0, ys.ravel() + y0], 1)
             for x0, y0 in ((2.2e3, 3.1e3), (6.4e3, 6.6e3))]
    loose = rng.uniform(1.5e3, 10.5e3, (80, 2))
    pos = np.concatenate(rafts + [loose])
    n = len(pos)
    st = ibt.create_bergs(256, lon=pos[:, 0], lat=pos[:, 1],
                          mass=850. * 40. * 200. * 200., thickness=40.,
                          width=200., length=200., max_bonds=6,
                          id_cnt=rng.permutation(n) + 1)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    return cfg, grid, jforces.initialize_bonds_host(st, cfg)


@pytest.mark.parametrize("bonds", [False, True])
@pytest.mark.parametrize("radius,width", [(1, 16), (1, 5), (2, 24)])
def test_strip_tables_match_jax(bonds, radius, width):
    cfg, grid, st = _bonded_world()
    cfg = cfg.replace(iceberg_bonds_on=bonds)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    js, jcs = jsorted.sort_state_by_cell(st, grid)
    ts, tcs = tsorted.sort_state_by_cell(tst, tgrid)
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))
    jn = jsorted.strip_neighbor_tables(js, grid, cfg, jcs,
                                       strip_width=width,
                                       ncells_radius=radius)
    tn = tsorted.strip_neighbor_tables(ts, tgrid, tcfg, tcs,
                                       strip_width=width,
                                       ncells_radius=radius)
    for f in ("cand_idx", "cand_valid", "is_bond_partner"):
        t, j = getattr(tn, f).numpy(), np.asarray(getattr(jn, f))
        assert t.shape == j.shape == (st.capacity,
                                      (2 * radius + 1) * width), f
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert tn.cand_idx.dtype == torch.int32
    assert int(tn.cand_valid.sum()) > 500
    assert (int(tn.is_bond_partner.sum()) > 40) == bonds


def test_sorted_mode_steps_match_jax():
    """4 per-step steps with ``neighbor_mode="sorted"``: the state is
    re-sorted by (cell, id) each step and the pairs come from the strips
    (``max_per_cell`` 80 x 3 slots a row: the knot holds 75 bergs)."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _world()
    kw = dict(persistent=False, neighbor_mode="sorted", max_per_cell=80)
    jout = jmodel.make_multi_step(grid, cfg, 4, True, **kw)(st, frc)
    tout = ibp.make_multi_step(tgrid, tcfg, 4, True, **kw)(tst, tfrc)
    assert_steps_close(tout, jout)
    # the slab is in the order of the last step's (cell, id) sort, as
    # the JAX package's is
    for f in ("id_cnt", "alive"):
        np.testing.assert_array_equal(getattr(tout[0], f).numpy(),
                                      np.asarray(getattr(jout[0], f)))

"""RK4 stepping against the JAX package, on the knot world of
``tests/test_torch_step.py`` with ``Runge_not_Verlet=True``.

``rk4_step`` on the same sorted state and environment, without contacts
and with the fused3 closure, with the environment cached at the step
start and (``old_interp_flds_order``) re-interpolated at every stage by
``interp_flds``; then four per-step ``make_step`` steps
(``interp_mode="xla"``, ``slot_sum_method="scatter"``).  Four persistent
fast-lane steps with RK4 are in ``tests/test_torch_fastlane_opts.py``.

Tolerance as in ``tests/test_torch_step.py``: integers, counters and the
walk's bounces exact; floats per berg id within rtol 1e-5 plus 2e-5 of
each field's largest magnitude (XLA:CPU contracts multiply-adds, and four
stages of springs amplify an ulp).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from icebergs_tpu import dynamics as jdyn
from icebergs_tpu.model import make_step as jax_make_step
from icebergs_tpu.ops import pallas_interp as jinterp
from icebergs_tpu.ops.fused_contact import make_ia_fn_fused3 as jax_fused3
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import dynamics as tdyn
from icebergs_tpu_torch.ops.fused_contact import make_ia_fn_fused3

from test_torch_step import (ATOL_SCALE, CPU, _leaves, _world,
                             assert_state_close)

torch.set_num_threads(1)
FUSED = dict(block_n=16, window=160, fallback_cap=1024,
             fallback_strip_width=128)


def _rk4_world(**kw):
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    kw = dict(Runge_not_Verlet=True, **kw)
    return cfg.replace(**kw), grid, frc, st, tcfg.replace(**kw), tgrid, tfrc


@functools.lru_cache(maxsize=None)
def _jax_rk4(contacts, old_order):
    cfg, grid, frc, st, *_ = _rk4_world(old_interp_flds_order=old_order)
    js, jcs = jax_sort(st, grid)

    @jax.jit
    def run(s, cs):
        s, pre = jinterp.interp_to_bergs_table(s, grid, frc, cfg)
        ia_fn = None
        if contacts:
            ia_fn, _ = jax_fused3(s, grid, cfg, presorted=True,
                                  cell_starts=cs, interpret=True, **FUSED)
        return s, pre, jdyn.rk4_step(s, grid, frc, cfg, ia_fn=ia_fn,
                                     m25_pre=pre)

    return js, jcs, run(js, jcs)


@pytest.mark.parametrize("contacts,old_order", [
    (False, False), (True, False), (True, True)])
def test_rk4_step_matches_jax(contacts, old_order):
    cfg, grid, frc, st, tcfg, tgrid, tfrc = _rk4_world(
        old_interp_flds_order=old_order)
    js, jcs, (js2, (jm25, jm81), jout) = _jax_rk4(contacts, old_order)
    tst = ibp.state_from_numpy(_leaves(js2), device=CPU)
    pre = (torch.as_tensor(np.array(jm25)), torch.as_tensor(np.array(jm81)))
    ia_fn = None
    if contacts:
        ia_fn, stats = make_ia_fn_fused3(
            tst, tgrid, tcfg, cell_starts=torch.as_tensor(np.array(jcs)),
            **FUSED)
        assert int(stats.overflow) == 0 and int(stats.n_fallback) > 0
    tout = tdyn.rk4_step(tst, tgrid, tfrc, tcfg, ia_fn=ia_fn, m25_pre=pre)
    assert_state_close(tout.state, jout.state)
    assert int(tout.bounced) == int(jout.bounced) > 0
    assert int(tout.tickets) == int(jout.tickets)
    moved = np.abs(tout.state.lon.numpy() - tst.lon.numpy()).max()
    assert moved > 1.


@functools.lru_cache(maxsize=None)
def _jax_per_step(kw):
    cfg, grid, frc, st, *_ = _rk4_world(**dict(kw))
    step = jax.jit(jax_make_step(grid, cfg, jit=False, fused_block_n=16,
                                 fused_fallback_strip_width=128))
    out = []
    for _ in range(4):
        st, d = step(st, frc)
        out.append(d)
    return st, out


PER_STEP = (("interp_mode", "xla"), ("slot_sum_method", "scatter"))


def test_make_step_rk4_xla_scatter_matches_jax():
    """Four per-step steps with RK4, the XLA interpolation and the slot
    scatter spreading: the state per berg id and the coupler fields of
    every step."""
    cfg, grid, frc, st, tcfg, tgrid, tfrc = _rk4_world(**dict(PER_STEP))
    jst, jd = _jax_per_step(PER_STEP)
    step = ibp.make_step(tgrid, tcfg, fused_block_n=16,
                         fused_fallback_strip_width=128)
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    for k in range(4):
        tst, td = step(tst, tfrc)
        assert int(td.contact_overflow) == int(jd[k].contact_overflow) == 0
        assert int(td.contact_fallback) == int(jd[k].contact_fallback)
        assert int(td.bounced) == int(jd[k].bounced)
        for name in ("spread_mass", "spread_area", "mass_on_ocean",
                     "floating_melt", "calving_hflx", "berg_melt"):
            j = np.asarray(getattr(jd[k], name))
            np.testing.assert_allclose(
                getattr(td, name).numpy(), j, rtol=1e-5,
                atol=ATOL_SCALE * max(np.abs(j).max(), 1e-30),
                err_msg=f"step {k} {name}")
    assert_state_close(tst, jst)

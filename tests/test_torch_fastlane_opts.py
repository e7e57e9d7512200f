"""The persistent fast lane's options against the JAX package's
``make_persistent_multi_step`` on the knot world of
``tests/test_torch_step.py``: four steps with RK4, with K2's pair
epilogue, with the three transport knobs and the slot scatter, and with
``interp_flds`` and the plain scatters of ``parallel_reprod=False``;
and the (cell, id) re-sort under each transport knob.

Tolerance as in ``tests/test_torch_step.py`` (integers and counters
exact, floats per berg id within rtol 1e-5 plus 2e-5 of each field's
largest magnitude).  The transport knobs move bits, so the re-sort is
held bit for bit, and the knobs' fast-lane steps equal the port's
default lane bit for bit but for the spreading's association, which
does not feed back into the state.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebergs_tpu.model import make_persistent_multi_step as jax_multi
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort
from icebergs_tpu.ops.sorted import uniform_state_fields as jax_uniform

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops.sorted import (sort_state_by_cell,
                                           starts_from_sorted_key,
                                           uniform_state_fields)

from test_torch_step import (ATOL_SCALE, CPU, _leaves, _world,
                             assert_state_close)

torch.set_num_threads(1)
KNOBS = (("sort_packed_permute", False), ("pack_kernel", False),
         ("starts_via_scatter", True), ("slot_sum_method", "scatter"))
OPTS = {"rk4": (("Runge_not_Verlet", True),),
        "epilogue": (("contact_epilogue", True),),
        "knobs": KNOBS,
        "xla_noreprod": (("interp_mode", "xla"), ("parallel_reprod", False))}


@functools.lru_cache(maxsize=None)
def _jax_lane(opt):
    cfg, grid, frc, st, _ = _world()
    return jax_multi(grid, cfg.replace(**dict(OPTS[opt])), 4, True,
                     fused_block_n=16, fused_fallback_strip_width=128)(
        st, frc)


def _port_lane(kw):
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    multi = ibp.make_persistent_multi_step(
        tgrid, tcfg.replace(**dict(kw)), 4, True, fused_block_n=16,
        fused_fallback_strip_width=128)
    return multi(ibp.state_from_numpy(_leaves(st), device=CPU), tfrc)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_persistent_options_match_jax(opt):
    jst, jov, jfb, jacc = _jax_lane(opt)
    tst, tov, tfb, tacc = _port_lane(OPTS[opt])
    assert int(tov) == int(jov) == 0
    assert int(tfb) == int(jfb) > 0
    assert_state_close(tst, jst)
    jacc = np.asarray(jacc)
    np.testing.assert_allclose(tacc.numpy(), jacc, rtol=0,
                               atol=ATOL_SCALE * np.abs(jacc).max())
    if opt == "knobs":
        # the same state bits as the default lane
        dst = _port_lane(())[0]
        for name, t in ibp.to_numpy(tst).items():
            np.testing.assert_array_equal(t, ibp.to_numpy(dst)[name],
                                          err_msg=name)


@pytest.mark.parametrize("knobs", [
    dict(packed_permute=True, pack_kernel=True),
    dict(packed_permute=True, pack_kernel=False),
    dict(packed_permute=False, pack_kernel=True),
    dict(packed_permute=True, pack_kernel=True, starts_via_scatter=True)])
def test_sort_state_knobs_match_jax(knobs):
    """``sort_state_by_cell`` under each transport knob: every leaf and
    the cell starts bit for bit against the JAX function with the same
    knobs, on a slab in random order with dead rows."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    perm = np.random.RandomState(3).permutation(st.capacity)
    leaves = {k: v[perm] for k, v in _leaves(st).items()
              if getattr(v, "ndim", 0) >= 1}
    leaves["alive"][:7] = False
    st = st.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    js, jcs = jax_sort(st, grid, static_fields=jax_uniform(cfg), **knobs)
    tst, tcs = sort_state_by_cell(
        ibp.state_from_numpy(_leaves(st), device=CPU), tgrid,
        static_fields=uniform_state_fields(tcfg), **knobs)
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))
    J = _leaves(js)
    for name, t in ibp.to_numpy(tst).items():
        np.testing.assert_array_equal(t, J[name], err_msg=name)


def test_starts_via_scatter_with_empty_cells():
    """The scatter-min starts equal the binary-search starts on keys with
    empty cells, a crowded cell and the dead tail."""
    key = torch.tensor([0, 0, 3, 3, 3, 7, 9, 9, 12, 12], dtype=torch.int32)
    for n in (12, 13):              # 12: the last two rows are dead
        np.testing.assert_array_equal(
            starts_from_sorted_key(key, n, via_scatter=True).numpy(),
            starts_from_sorted_key(key, n).numpy())

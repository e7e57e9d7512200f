"""The XLA interpolation ``interp_flds`` against the JAX package.

A 16 x 16 grid of 1 km cells with a land blob, random ocean depth and
random forcing (every corner velocity, ssh, sst, sss, ice), 400 bergs
anywhere on it: the reference's bilinear weights (``old_bug_bilin``) and
the corrected ones, coastal and tidal drift with a nonzero tidal step,
the MTS quadratic depth stencil and the A68 test's analytic depth.
Every berg's 13 environment fields within rtol 1e-5 and 1e-6 of the
field's largest magnitude (XLA:CPU contracts the bilinear and stencil
multiply-adds into fused ones); the A68 depth, a select of constants,
exactly.
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
from icebergs_tpu.ops.interp import interp_flds as jax_interp_flds

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops.interp import interp_flds, use_interp_table

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX = 16
CASES = {
    "old_bilin": {},
    "new_bilin": dict(old_bug_bilin=False),
    "drift": dict(coastal_drift=0.3, tidal_drift=0.2),
    "mts_quad": dict(mts=True, rev_mind=True),
    "mts_a68": dict(mts=True, A68_test=True, A68_xdisp=8e3 - 360.,
                    A68_ydisp=7e3),
}


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


@functools.lru_cache(maxsize=None)
def _world():
    rng = np.random.RandomState(7)
    msk = np.ones((NX, NX))
    msk[3:6, 9:13] = 0.                      # a land blob
    msk[:, 0] = 0.                           # and a coast
    grid = ibt.make_uniform_grid(NX, NX, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, msk=msk,
                                 ocean_depth=rng.uniform(50., 500.,
                                                         (NX, NX)))
    corner = (NX + 1, NX + 1)
    center = (NX + 2, NX + 2)
    frc = ibt.Forcing(**{k: jnp.asarray(rng.uniform(-1., 1., corner),
                                        jnp.float32)
                         for k in ("uo", "vo", "ui", "vi", "ua", "va")},
                      ssh=jnp.asarray(rng.uniform(-.5, .5, center),
                                      jnp.float32),
                      sst=jnp.asarray(rng.uniform(-1., 5., center),
                                      jnp.float32),
                      sss=jnp.asarray(rng.uniform(30., 35., center),
                                      jnp.float32),
                      cn=jnp.asarray(rng.uniform(0., 1., center),
                                     jnp.float32),
                      hi=jnp.asarray(rng.uniform(0., 2., center),
                                     jnp.float32))
    n = 400
    lon = jnp.asarray(rng.uniform(10., NX * 1000. - 10., n), jnp.float32)
    lat = jnp.asarray(rng.uniform(10., NX * 1000. - 10., n), jnp.float32)
    i, j, xi, yj = jax_pos_to_cell(grid, lon, lat, -1.)
    return grid, frc, (lon, lat, i, j, xi, yj)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interp_flds_matches_jax(case):
    grid, frc, pos = _world()
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0, **CASES[case])
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    rx, ry = (0.7, -0.4) if case == "drift" else (0., 0.)
    jenv = jax.jit(lambda *p: jax_interp_flds(grid, frc, cfg, *p, rx, ry))(
        *pos)
    tenv = interp_flds(ibp.grid_from_numpy(_leaves(grid), device=CPU),
                       ibp.forcing_from_numpy(_leaves(frc), device=CPU),
                       tcfg, *(torch.as_tensor(np.array(p)) for p in pos),
                       rx, ry)
    for name in tenv._fields:
        t = getattr(tenv, name).numpy()
        j = np.asarray(getattr(jenv, name))
        assert np.isfinite(t).all(), name
        if case == "mts_a68" and name == "od":
            np.testing.assert_array_equal(t, j)
            assert 0 < (t == 0.).sum() < t.size
            continue
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(j).max(), 1e-30),
                                   err_msg=name)
    # the coast and the land blob reach the stencil: some slopes are
    # masked, some are not
    ssh_x = tenv.ssh_x.numpy()
    assert (ssh_x == 0.).any() and (ssh_x != 0.).any()


def test_per_step_interp_routing():
    """The per-step path reads the table where the JAX ``make_step``
    does (``model.py:166-169``) and takes ``interp_flds`` elsewhere."""
    base = ibp.IcebergsConfig(grid_is_latlon=False)
    assert use_interp_table(base)
    for kw in (dict(interp_mode="xla"), dict(interp_mode="kernel"),
               dict(coastal_drift=0.1), dict(tidal_drift=0.1),
               dict(mts=True, A68_test=True)):
        assert not use_interp_table(base.replace(**kw)), kw
    assert use_interp_table(base.replace(mts=True))

"""K2's pair epilogue (``contact_epilogue=True``) against the JAX package.

The plain version of K2's epilogue instantiation is held to
``contact_extract_sorted_g(epilogue=True)`` in interpret mode on the
worlds of ``tests/test_torch_extract.py``: bad-block flags exact; on the
rows of good blocks the count, partner slots, exactness flags, partner
velocities and mass ratios bit for bit.  The projections P11, P12, P22
and the spring sums ``EX_IAX`` / ``EX_IAY`` agree within rtol 1e-5 and
1e-6 of each row's largest magnitude: XLA:CPU contracts the kernel's
r2 = rx*rx + ry*ry into a fused multiply-add, so r, and everything
divided by it, differs from the separately rounded products by an ulp on
about 1% of the pairs (the port keeps them separate, as the TPU does).
Rows of bad blocks are discarded by both packages.

The closure built on the epilogue agrees with the JAX package's
epilogue closure, and with the port's closure on the search alone,
within the tolerance of ``test_fused3_closure_matches_jax`` (the
epilogue rounds the spring term as aspr * (rx / r), the search-alone
precompute as (aspr * rx) / r, in both packages).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebergs_tpu.ops.fused_contact import make_ia_fn_fused3 as jax_fused3
from icebergs_tpu.ops.pallas_prepass import contact_extract_sorted_g

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import extract
from icebergs_tpu_torch.ops.fused_contact import (contact_features,
                                                  make_ia_fn_fused3)

from test_torch_extract import (BN, CPU, WINDOW, _FALLBACK, _leaves, _setup,
                                _world)

torch.set_num_threads(1)
# per partner: u, v, P11, P12, P22, mass ratio, exactness
EXACT_ROWS = [b + k for b in (extract.EX_F1, extract.EX_F2)
              for k in (0, 1, 5, 6)]
R_ROWS = [b + k for b in (extract.EX_F1, extract.EX_F2) for k in (2, 3, 4)]


@functools.lru_cache(maxsize=None)
def _jax_extract_epi():
    cfg, grid = _setup()
    return jax.jit(functools.partial(
        contact_extract_sorted_g, grid=grid, cfg=cfg, block_n=BN,
        window=WINDOW, interpret=True, epilogue=True))


def _port(js):
    cfg, grid = _setup()
    return (ibp.state_from_numpy(_leaves(js), device=CPU),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.config_from_dict(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("case", ["sparse", "clustered", "window", "edge"])
def test_epilogue_plain_matches_jax(case):
    js, jcs = _world(case)
    tst, tgrid, tcfg = _port(js)
    PT, key_s = contact_features(tst, tgrid, tcfg)
    cs = torch.as_tensor(np.array(jcs))
    out, bad = extract.extract_sorted(PT, key_s, cs, tgrid, tcfg,
                                      block_n=BN, window=WINDOW,
                                      epilogue=True)
    jout, jbad = _jax_extract_epi()(jnp.asarray(PT.numpy()),
                                    jnp.asarray(key_s.numpy()),
                                    jnp.asarray(np.asarray(jcs)))
    jout, jbad = np.asarray(jout), np.asarray(jbad)
    out, bad = out.numpy(), bad.numpy()
    np.testing.assert_array_equal(bad, jbad)
    good = ~bad
    for r in [extract.EX_CNT, extract.EX_VMIN, extract.EX_VMAX] + EXACT_ROWS:
        np.testing.assert_array_equal(out[r, good], jout[r, good],
                                      err_msg=f"row {r}")
    for r in R_ROWS + [extract.EX_IAX, extract.EX_IAY]:
        scale = max(float(np.abs(jout[r, good]).max()), 1e-30)
        np.testing.assert_allclose(out[r, good], jout[r, good], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=f"row {r}")
    # exact pairs per row: at most the engaged count
    few = good & (out[extract.EX_CNT] <= 2)
    many = good & ~few
    ex = out[extract.EX_F1 + 6, good]
    cnt = out[extract.EX_CNT, good]
    assert ((ex == 0.) | (ex == 1.)).all() and (ex[cnt == 0] == 0.).all()
    if case == "sparse":
        assert (ex > 0).sum() > 20 and (out[extract.EX_IAX, few] != 0).any()
    if case == "clustered":
        assert many.sum() >= 60


@pytest.mark.parametrize("case", sorted(_FALLBACK))
def test_epilogue_closure_matches(case):
    """fused3 with ``contact_epilogue`` against the JAX package's
    epilogue closure and the port's search-alone closure."""
    cfg, grid = _setup()
    js, jcs = _world(case)
    tst, tgrid, tcfg = _port(js)
    cap, width = _FALLBACK[case]
    cs = torch.as_tensor(np.array(jcs))
    kw = dict(block_n=BN, window=WINDOW, fallback_cap=cap,
              fallback_strip_width=width, cell_starts=cs)
    u1, v1 = tst.uvel * 0.5, tst.vvel * 0.5
    ia0, st0 = make_ia_fn_fused3(tst, tgrid, tcfg, **kw)
    ia1, st1 = make_ia_fn_fused3(tst, tgrid,
                                 tcfg.replace(contact_epilogue=True), **kw)
    a0, a1 = ia0(u1, v1), ia1(u1, v1)
    assert int(st1.n_fallback) == int(st0.n_fallback) > 0
    assert int(st1.overflow) == 0
    live = np.asarray(js.alive)
    for name in a0._fields:
        t0 = getattr(a0, name).numpy()[live]
        np.testing.assert_allclose(getattr(a1, name).numpy()[live], t0,
                                   rtol=1e-5, atol=1e-6 * np.abs(t0).max(),
                                   err_msg=name)

    ecfg = cfg.replace(contact_epilogue=True)

    @jax.jit
    def run(st, cs):
        ia_fn, stats = jax_fused3(st, grid, ecfg, block_n=BN, window=WINDOW,
                                  fallback_cap=cap,
                                  fallback_strip_width=width,
                                  presorted=True, cell_starts=cs,
                                  interpret=True)
        return ia_fn(st.uvel * 0.5, st.vvel * 0.5), stats

    jia, jstats = run(js, jcs)
    assert int(jstats.n_fallback) == int(st1.n_fallback)
    for name in a1._fields:
        j = np.asarray(getattr(jia, name))[live]
        t = getattr(a1, name).numpy()[live]
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max(),
                                   err_msg=name)


def test_epilogue_only_with_gathered_extraction(monkeypatch):
    """The JAX package runs the epilogue only with the gathered
    extraction window; with another ``extract_impl`` the setting is
    accepted and the search-alone path runs."""
    js, jcs = _world("sparse")
    tst, tgrid, tcfg = _port(js)
    cs = torch.as_tensor(np.array(jcs))
    calls = []
    real = extract.extract_sorted

    def spy(*a, **k):
        calls.append(k.get("epilogue", False))
        return real(*a, **k)

    import icebergs_tpu_torch.ops.fused_contact as fc
    monkeypatch.setattr(fc, "extract_sorted", spy)
    for impl in ("gathered", "manual", "pipelined"):
        c = tcfg.replace(contact_epilogue=True, extract_impl=impl)
        ibp.check_ported(c)
        make_ia_fn_fused3(tst, tgrid, c, block_n=BN, window=WINDOW,
                          cell_starts=cs)
    assert calls == [True, False, False]

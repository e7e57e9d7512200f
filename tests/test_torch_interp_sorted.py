"""K6, the sorted-frame interpolation, against the JAX package.

The port's ``interp_to_bergs_sorted`` (K6's plain version on the CPU)
against the JAX one with the TPU kernel in interpret mode, on the cases
of ``tests/test_pallas_interp.py``: a plain world, bergs in the edge
cells where the SSH stencil divides by zero (the NaN scrub), and a
window so small that every block overflows it.  There the JAX rows come
from ``interp_flds`` and the port's from the kernel's arithmetic, which
is exact on every row.  ``m25_pre`` and the bad-row flags are exact;
floats on alive rows within ``rtol 1e-5`` plus 2e-5 of each field's
scale, the tolerance of ``tests/test_torch_step.py`` (XLA:CPU contracts
the bilinear multiply-adds into FMAs).  The kernel path's environment
also equals the port's table path bit for bit, and a Verlet step with
its walk anchors keeps ``ine``/``jne`` exact against the JAX step.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import dynamics as jdyn
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.ops import pallas_interp as jinterp
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import dynamics as tdyn
from icebergs_tpu_torch.ops import interp_sorted as tis
from icebergs_tpu_torch.ops import interp_table as tit

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5
ENV_FIELDS = ("uo", "vo", "ui", "vi", "ua", "va", "ssh_x", "ssh_y",
              "sst", "sss", "cn", "hi", "od")
DXY = 700.0


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


@functools.lru_cache(maxsize=None)
def _setup(case):
    """``_setup`` of test_pallas_interp.py (48x40 grid of 700 m cells,
    sinusoidal SSH), cell-sorted; ``"edge"`` spreads 800 bergs into the
    edge cells, ``"land"`` adds land beyond column 36 and eastward
    velocities so the walk bounces."""
    nx, ny = 48, 40
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0,
                             use_f_plane=True, lat_ref=45.0, dt=600.0,
                             Runge_not_Verlet=False,
                             interactive_icebergs_on=True,
                             interp_mode="kernel")
    msk = np.ones((nx, ny))
    if case == "land":
        msk[36:, :] = 0.
    grid = ibt.make_uniform_grid(nx, ny, 0., 0., DXY, DXY,
                                 grid_is_latlon=False, msk=msk)
    frc = ibt.uniform_forcing(nx, ny, uo=0.3, vo=0.1, ua=5.0, va=-2.0,
                              ui=0.05, vi=0.02, sst=4.0, sss=33.0)
    ssh = 0.5 * np.sin(np.linspace(0, 6, nx + 2))[:, None] \
        * np.cos(np.linspace(0, 5, ny + 2))[None, :]
    frc = frc.replace(ssh=jnp.asarray(ssh, jnp.float32))
    rng = np.random.RandomState(0 if case != "edge" else 3)
    n = 800 if case == "edge" else 2000
    if case == "edge":
        lon = rng.uniform(0.05 * DXY, nx * DXY * 0.999, n)
        lat = rng.uniform(0.05 * DXY, ny * DXY * 0.999, n)
    else:
        lon = rng.uniform(2 * DXY, (35.9 if case == "land" else nx - 2)
                          * DXY, n)
        lat = rng.uniform(2 * DXY, (ny - 2) * DXY, n)
    uvel = rng.uniform(0.5, 1.5, n) if case == "land" else np.zeros(n)
    st = ibt.create_bergs(2048, lon=lon, lat=lat,
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.0,
                          uvel=uvel, id_cnt=np.arange(n) + 1)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    st, _ = jax_sort(st, grid)
    port = (ibp.config_from_dict(dataclasses.asdict(cfg)),
            ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))
    return cfg, grid, frc, st, port


def _assert_close(t, j, alive, what):
    t, j = t[alive], np.asarray(j)[alive]
    assert np.isfinite(t).all(), what
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=what)


@pytest.mark.parametrize("case,cell_window", [("plain", 384), ("edge", 384),
                                              ("edge", 1)])
def test_interp_sorted_matches_jax(case, cell_window):
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _setup(case)
    jst, jm25 = jinterp.interp_to_bergs_sorted(st, grid, frc, cfg,
                                               cell_window=cell_window,
                                               interpret=True)
    t2, tm25 = tis.interp_to_bergs_sorted(tst, tgrid, tfrc, tcfg)
    alive = np.asarray(st.alive)
    np.testing.assert_array_equal(tm25.numpy()[alive],
                                  np.asarray(jm25)[alive])
    for f in ENV_FIELDS:
        _assert_close(getattr(t2, f).numpy(), getattr(jst, f), alive, f)
    # the TPU kernel's bad rows, computed as its wrapper computes them
    ncells = grid.nx * grid.ny
    key = jnp.where(st.alive, st.jne * grid.nx + st.ine, ncells)
    _, jbad = jinterp.interp_sorted(
        jinterp.interp_cell_table(grid, frc, cfg), key, st.xi, st.yj, grid,
        cfg, cell_window=cell_window, interpret=True)
    tbad = tis.window_bad_rows(torch.as_tensor(np.array(key)), ncells, 128,
                               cell_window)
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    assert bool(tbad.any()) == (cell_window == 1)


def test_interp_sorted_equals_table_path():
    """Same slot table, same expressions: the kernel path's plain version
    and the table path agree bit for bit, walk anchor included."""
    _, _, _, _, (tcfg, tgrid, tfrc, tst) = _setup("edge")
    a, m25 = tis.interp_to_bergs_sorted(tst, tgrid, tfrc, tcfg)
    b, (m25b, _) = tit.interp_to_bergs_table(tst, tgrid, tfrc, tcfg)
    for f in ENV_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(m25, m25b)


def test_walk_on_kernel_anchors_matches_jax():
    """A Verlet step whose walk starts from K6's 5x5 anchor: the port
    reads the 9x9 rows from the grid, the JAX package walks on the 5x5
    anchor; cells and bounces exact."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc, tst) = _setup("land")
    jst, jm25 = jinterp.interp_to_bergs_sorted(st, grid, frc, cfg,
                                               interpret=True)
    jout = jdyn.evolve_icebergs(jst, grid, frc, cfg, m25_pre=jm25)
    t2, tm25 = tis.interp_to_bergs_sorted(tst, tgrid, tfrc, tcfg)
    tout = tdyn.evolve_icebergs(t2, tgrid, tfrc, tcfg, m25_pre=tm25)
    alive = np.asarray(st.alive)
    for f in ("ine", "jne"):
        np.testing.assert_array_equal(getattr(tout.state, f).numpy(),
                                      np.asarray(getattr(jout.state, f)),
                                      err_msg=f)
    assert int(tout.bounced) == int(jout.bounced) > 0
    for f in ("lon", "lat", "uvel", "vvel", "xi", "yj"):
        _assert_close(getattr(tout.state, f).numpy(),
                      getattr(jout.state, f), alive, f)

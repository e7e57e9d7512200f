"""The port's driver against the JAX driver on ``tests/test_driver.py``'s
``DEM_NML`` world (16 bonded elements, MTS with 12 explicit substeps,
stress fracture on the substeps, one hour at 120 s): the substeps as the
scan, and with ``substep_kernel="vmem"`` through K4's plain version
(the JAX package's Pallas kernel in interpret mode), the capacity grown
to one 128-slot block as the JAX driver grows it
(``tests/test_driver.py:220``).

Tolerance: integers, cells, bonds, broken flags and the capacity exact.
Floats cannot be held to a fixed bound: the stiff substeps turn one ulp
(XLA:CPU's contracted multiply-adds, which the port rounds apart) into
percents of the rotations' and velocities' scale over the 30 steps, as
``chip_smoke.py`` phase 4b finds on the card.  So the test measures that
response: the port's own run from the same restart with every longitude
one ulp larger; each float field (of the state and of every output
file) must lie within ULP_FACTOR times that response, or within FLOOR
of its scale.  ``tests/test_torch_mts_scan.py`` holds the substeps bit
for bit against the JAX functions run op by op.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from icebergs_tpu import driver as jdrv

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import driver as tdrv
from icebergs_tpu_torch.io import restart as trio
from icebergs_tpu_torch.io.namelist import config_from_namelist

import test_driver
from test_torch_driver import INTS, _leaves, read_nc

torch.set_num_threads(1)
CPU = torch.device("cpu")
ULP_FACTOR, FLOOR = 10.0, 2e-5


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not b.size:
        return 0.
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _nudged_inputs(tmp_path):
    """The input directory with every longitude one ulp larger."""
    d = tmp_path / "nudged"
    d.mkdir()
    for f in ("input.nml", "bonds_iceberg.res.nc"):
        shutil.copy(tmp_path / f, d / f)
    cfg, _ = config_from_namelist(str(tmp_path / "input.nml"))
    grid = ibp.make_uniform_grid(24, 24, 0., 0., 7000., 7000.,
                                 grid_is_latlon=False, device=CPU)
    st = trio.read_restart_bergs(str(tmp_path / "icebergs.res.nc"), 64,
                                 grid, cfg)
    up = torch.nextafter(st.lon, torch.full_like(st.lon, float("inf")))
    trio.write_restart_bergs(str(d / "icebergs.res.nc"),
                             st.replace(lon=up), cfg)
    return d


@pytest.mark.parametrize("kernel", ["scan", "vmem"])
def test_dem_driver_matches_jax(tmp_path, kernel):
    (tmp_path / "input.nml").write_text(test_driver.DEM_NML)
    test_driver._dem_world(tmp_path)
    nudged = _nudged_inputs(tmp_path)
    kw = dict(capacity=64, verbose=False, substep_kernel=kernel)
    nml = str(tmp_path / "input.nml")
    j = jdrv.run(nml, str(tmp_path), str(tmp_path / "oj"), **kw)
    t = tdrv.run(nml, str(tmp_path), str(tmp_path / "ot"), device="cpu",
                 **kw)
    u = tdrv.run(str(nudged / "input.nml"), str(nudged),
                 str(tmp_path / "ou"), device="cpu", **kw)
    assert t.capacity == j.capacity == (128 if kernel == "vmem" else 64)

    J, T, U = _leaves(j), ibp.to_numpy(t), ibp.to_numpy(u)
    alive = J["alive"]
    beyond = {}
    for name, v in T.items():
        if name in INTS or v.dtype == bool:
            np.testing.assert_array_equal(v, J[name], err_msg=name)
            continue
        err = _scaled(v[alive], J[name][alive])
        ulp = _scaled(U[name][alive], v[alive])
        if err > max(ULP_FACTOR * ulp, FLOOR):
            beyond[name] = (err, ulp)
    assert not beyond, beyond
    assert int(t.bond_broken.sum()) == int(np.asarray(j.bond_broken).sum())

    names = sorted(os.listdir(tmp_path / "oj"))
    assert sorted(os.listdir(tmp_path / "ot")) == names
    for fname in names:
        F = [read_nc(str(tmp_path / o / fname)) for o in ("oj", "ot", "ou")]
        assert list(F[1]) == list(F[0]), fname
        for k, v in F[0].items():
            if k == "list_chksum":
                continue                # a hash of every bit of the state
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(F[1][k], v, err_msg=k)
                continue
            err, ulp = _scaled(F[1][k], v), _scaled(F[2][k], F[1][k])
            assert err <= max(ULP_FACTOR * ulp, FLOOR), (fname, k, err, ulp)

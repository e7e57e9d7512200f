"""The port's stand-alone driver against the JAX package's on the
reference's iKID collision configuration, ``input_MTS_KID.nml``
(``tests/test_torch_io.py``'s ``MTS_KID_NML``: MTS with 60 substeps,
force convergence, ``contact_distance`` with its own spring,
``hexagonal_icebergs=.true.`` and ``collision_test=.true.``, the
converging jet of ``icebergs_tpu/driver.py:66-80``), run for 4 hours with
restarts saved, on two bonded hexagonal rafts (seven elements each, a
centre and its six neighbours) either side of the jet's midline: the
final state and every output file (restart triplet, bonds, trajectories,
history).  Every step spreads the bond-oriented hexagons.

Tolerance: integers, cells, bond tables and the file layout exact.  The
60 stiff substeps a step (and one Part-1 iteration more or fewer a step:
the namelist's tolerance, 1e-8, lies below float32's resolution,
``tests/test_torch_mts_scan.py``) turn one ulp into 2e-4 of the
velocities' scale over the 4 steps, as much as the JAX package's
contracted multiply-adds (XLA:CPU) move them.  So, as
``tests/test_torch_driver_dem.py`` holds the DEM namelist, the test
measures that response, the port's own run from the same restart with
every longitude one ulp larger, and each float field of the state and
of every file must lie within ULP_FACTOR times it, or within FLOOR of
its scale.  The history's ratio fields (``spread_uvel``,
``spread_vvel``, ``ustar_iceberg``: each step's sum over the spread
area, averaged over the steps) but on at most ``MAX_GRAZED`` cells,
whose step-averaged spread area must agree: where a hexagon's corner
grazes a cell edge in one step, an ulp of its position (or of the bond
orientation's ``atan``, which the two libraries round an ulp apart) puts
~1e-9 of its area on the neighbour cell in one package and none in the
other, and that step's ratio there is the berg's whole velocity or 0
(``tests/test_torch_driver.py`` masks such cells by their averaged
area; here the cell is covered in the other steps).
"""

import math
import os
import shutil

import numpy as np
import torch

import icebergs_tpu as ibt
from icebergs_tpu import driver as jdrv
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.io import restart as jrio
from icebergs_tpu.io.namelist import config_from_namelist
from icebergs_tpu.ops import forces as jforces

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import driver as tdrv
from icebergs_tpu_torch.io import restart as trio
from icebergs_tpu_torch.io.namelist import (
    config_from_namelist as tconfig_from_namelist)

import test_torch_io
from test_torch_driver import INTS, RATIO_FIELDS, _leaves, read_nc
from test_torch_driver_dem import FLOOR, ULP_FACTOR, _scaled

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIDE = 400.                       # element width and length
R_HEX = math.sqrt(SIDE * SIDE / (2. * math.sqrt(3.)))   # 215 m apothem
MAX_GRAZED = 2


def kid_nml():
    """``MTS_KID_NML`` cut to 4 hours, with the restarts saved and the
    trajectories sampled hourly."""
    return test_torch_io.MTS_KID_NML.replace(
        "collision_test=.true.",
        "collision_test=.true.\n  ibhrs=4\n  saverestart=.true.").replace(
        "max_bonds=6", "max_bonds=6\n  traj_sample_hrs=1.")


def hex_rafts(tmp_path):
    """Two seven-element hexagonal rafts (neighbours 2 x apothem apart,
    touching) centred 2 km either side of the midline, bonded by the
    radius criterion, written as the restart and bond files."""
    cfg, _ = config_from_namelist(str(tmp_path / "input.nml"))
    assert cfg.hexagonal_icebergs and cfg.mts
    grid = ibt.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    ring = [(0., 0.)] + [(2 * R_HEX * math.cos(math.pi / 3 * k + math.pi / 6),
                          2 * R_HEX * math.sin(math.pi / 3 * k + math.pi / 6))
                         for k in range(6)]
    lon, lat = [], []
    for cx, cy in ((5000., 8000.), (5200., 12000.)):
        lon += [cx + dx for dx, _ in ring]
        lat += [cy + dy for _, dy in ring]
    n = len(lon)
    st = ibt.create_bergs(32, lon=lon, lat=lat,
                          mass=850. * 100 * SIDE * SIDE, thickness=100.,
                          width=SIDE, length=SIDE, mass_scaling=1.,
                          id_cnt=np.arange(n) + 1, max_bonds=6)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    st = jforces.count_bonds(jforces.initialize_bonds_host(st, cfg.replace(
        manually_initialize_bonds_from_radii=True)))
    nb = np.asarray(st.n_bonds)[:n]
    assert nb[0] == nb[7] == 6 and nb.sum() == 2 * (6 + 6 * 3)
    jrio.write_restart_bergs(str(tmp_path / "icebergs.res.nc"), st, cfg)
    jrio.write_restart_bonds(str(tmp_path / "bonds_iceberg.res.nc"), st,
                             cfg)
    return n


def _nudged(tmp_path):
    """The input directory with every longitude one ulp larger."""
    d = tmp_path / "nudged"
    d.mkdir()
    for f in ("input.nml", "bonds_iceberg.res.nc"):
        shutil.copy(tmp_path / f, d / f)
    cfg, _ = tconfig_from_namelist(str(tmp_path / "input.nml"))
    grid = ibp.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, device=CPU)
    st = trio.read_restart_bergs(str(tmp_path / "icebergs.res.nc"), 32,
                                 grid, cfg)
    up = torch.nextafter(st.lon, torch.full_like(st.lon, float("inf")))
    trio.write_restart_bergs(str(d / "icebergs.res.nc"), st.replace(lon=up),
                             cfg)
    return d


def _off_grazed_cells(F, f):
    """A history ratio field (JAX, port, nudged) without the cells where
    it differs beyond the yardstick while the step-averaged spread area
    agrees: at most ``MAX_GRAZED`` of them."""
    scale = max(np.abs(f[0]).max(), 1e-30)
    resp = _scaled(f[2], f[1])
    off = np.abs(f[1] - f[0]) > max(ULP_FACTOR * resp, FLOOR) * scale
    assert off.sum() <= MAX_GRAZED, off.sum()
    area = [x["spread_area"] for x in F]
    aresp = _scaled(area[2], area[1])
    assert _scaled(area[1][off], area[0][off]) <= max(
        ULP_FACTOR * aresp, FLOOR)
    return [x[~off] for x in f]


def test_mts_kid_driver_hexagons_matches_jax(tmp_path):
    """Both drivers on the namelist and the rafts; the assertions of
    ``tests/test_mts_collision.py`` (finite, the rafts pushed toward the
    midline, every bond kept) on the port's run."""
    (tmp_path / "input.nml").write_text(kid_nml())
    n = hex_rafts(tmp_path)
    nudged = _nudged(tmp_path)
    nml = str(tmp_path / "input.nml")
    kw = dict(capacity=32, verbose=False)
    j = jdrv.run(nml, str(tmp_path), str(tmp_path / "oj"), **kw)
    t = tdrv.run(nml, str(tmp_path), str(tmp_path / "ot"), device="cpu",
                 **kw)
    u = tdrv.run(str(nudged / "input.nml"), str(nudged),
                 str(tmp_path / "ou"), device="cpu", **kw)
    J, T, U = _leaves(j), ibp.to_numpy(t), ibp.to_numpy(u)
    alive = J["alive"]
    assert int(alive.sum()) == n
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

    names = sorted(os.listdir(tmp_path / "oj"))
    assert names == ["bonds_iceberg.res.nc", "calving.res.nc",
                     "icebergs.res.nc", "icebergs_history.nc",
                     "kid_traj.nc"]
    assert sorted(os.listdir(tmp_path / "ot")) == names
    for fname in names:
        F = [read_nc(str(tmp_path / o / fname)) for o in ("oj", "ot", "ou")]
        assert list(F[1]) == list(F[0]), fname
        for k, v in F[0].items():
            assert F[1][k].shape == v.shape and F[1][k].dtype == v.dtype
            if k == "list_chksum":
                continue                # a hash of every bit of the state
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(F[1][k], v, err_msg=k)
                continue
            f = [x[k] for x in F]
            if k in RATIO_FIELDS:
                f = _off_grazed_cells(F, f)
            err, ulp = _scaled(f[1], f[0]), _scaled(f[2], f[1])
            assert err <= max(ULP_FACTOR * ulp, FLOOR), (fname, k, err, ulp)

    lat = T["lat"][alive]
    assert np.isfinite(T["lon"][alive]).all() and np.isfinite(lat).all()
    # the jet moved both rafts toward the midline, bonds intact
    assert lat[:7].mean() > 8000. and lat[7:].mean() < 12000.
    assert int((T["bond_idx"] >= 0).sum()) == 48
    assert int(T["bond_broken"].sum()) == 0
    tr = read_nc(str(tmp_path / "ot" / "kid_traj.nc"))
    assert tr["lon"].shape[0] >= 4 * n

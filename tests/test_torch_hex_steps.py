"""Whole steps with hexagonal elements, the port against the JAX package:
the fast lane (``make_multi_step`` routes the hexagonal headline flags to
the persistent ``fused3`` lane, which spreads through the slot sums on
its presorted slab: K3's pass-through, never K3), one hexagonal DEM
outer step with the radius-based faces (the scan, and K4's plain
version against the scan), and ``IcebergsModel.run`` with hexagons,
calving and footloose.

Tolerances are those of the files whose worlds these are: the fast lane
``tests/test_torch_perstep.py``'s (integers and counters exact, floats
per berg id within rtol 1e-5 plus 2e-5 of scale); the DEM step
stated in its test (integers, ``conv_iters`` and ``broken_bonds``
exact; floats against the JAX scan run op by op in float64 and float32;
the port's scan against K4's plain version within 5e-6 of scale, the
JAX package's own gate); the coupled
entry ``tests/test_torch_api.py``'s (its ``MELT_LIMITS`` on the melt
fields).  Hexagons without bonds keep the initial orientation, whose
cos and sin both libraries round alike, so no trig ulp enters here.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icebergs_tpu import api as japi
from icebergs_tpu import mts as jmts
from icebergs_tpu import model as jmodel
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.ops import dem_vmem as jvmem

import icebergs_tpu as ibt
import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import api as tapi
from icebergs_tpu_torch import mts as tmts
from icebergs_tpu_torch.ops import segment_spread as ss

import test_torch_api as tapi_test
from test_torch_dem_forces import (CPU, DXY, NX, close, eager, jax_cfg,
                                   leaves, port_cfg, tstate)
from test_torch_mts_scan import FLOATS, INTS
from test_torch_step import _leaves, _world

torch.set_num_threads(1)
SKW = dict(fused_block_n=16, fused_fallback_strip_width=128)
HEX = dict(hexagonal_icebergs=True)
# the DEM outer step against JAX's, of each float field's scale: float64
# (1.1e-9 read, the elastic world's ayn_fast, as for square elements);
# float32 while fracturing (448 of the world's bonds break); float32 in
# the elastic world, whose accelerations are differences of nearly
# cancelling bond forces (3.6e-3 of scale on one element's ayn_fast)
DEM_TOL_64, DEM_TOL_32, DEM_TOL_32_ELASTIC = 5e-9, 2e-4, 5e-3


def test_fast_lane_hexagons_matches_jax(monkeypatch):
    """4 steps of the hexagonal fast lane: ``make_multi_step`` routes it
    to the persistent fused3 lane (no ``step_diags``: not the per-step
    path), K3 never runs (its entry is replaced by one that raises), the
    slot sums run (counted) on the identity sort of the presorted slab,
    and the state and coupler fields match the JAX lane's."""
    from test_torch_perstep import assert_steps_close
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    cfg, tcfg = cfg.replace(**HEX), tcfg.replace(**HEX)
    assert cfg.slot_sum_method == "pallas" and cfg.parallel_reprod

    def no_k3(*a, **kw):
        raise AssertionError("K3 ran under hexagons")
    monkeypatch.setattr(ss, "spread_cell_sums", no_k3)
    calls = []
    sums = ss.segment_sums

    def counted(*a, **kw):
        calls.append(kw.get("tree"))
        return sums(*a, **kw)
    monkeypatch.setattr(ss, "segment_sums", counted)
    multi = ibp.make_multi_step(tgrid, tcfg, 4, True, **SKW)
    assert not hasattr(multi, "step_diags")
    tout = multi(ibp.state_from_numpy(_leaves(st), device=CPU), tfrc)
    # per step: thermodynamics' melt sums and the spreading's pass
    assert len(calls) == 8 and all(calls)
    jout = jax.jit(jmodel.make_persistent_multi_step(
        grid, cfg, 4, True, neighbor_mode="fused3", fused_interpret=True,
        **SKW))(st, frc)
    assert int(tout[1]) == 0 and int(tout[2]) > 0
    assert_steps_close(tout, jout)


def test_fast_lane_hexagons_differ_from_rectangles():
    """The same 4 steps with rectangles give other coupler fields (the
    hexagon spreading ran) and another state (hexagons contact at their
    inscribed radius, sqrt(A / (2 sqrt 3)), not sqrt(A / pi)), with the
    same bergs alive."""
    cfg, grid, frc, st, (tcfg, tgrid, tfrc) = _world()
    st = ibp.state_from_numpy(_leaves(st), device=CPU)
    h = ibp.make_multi_step(tgrid, tcfg.replace(**HEX), 4, True,
                            **SKW)(st, tfrc)
    r = ibp.make_multi_step(tgrid, tcfg, 4, True, **SKW)(st, tfrc)
    assert not torch.equal(h[3], r[3])
    assert not torch.equal(h[0].uvel, r[0].uvel)
    assert torch.equal(h[0].alive, r[0].alive)


# ---- one hexagonal DEM outer step --------------------------------------

HEX_COLS, HEX_ROWS = 6, 6
# hexagons of apothem r = 1.5 km: area 2 sqrt(3) r^2, neighbours 2r apart
# just touch (the bonding radius 1.25 x 2r = 3.75 km bonds six of them)
HEX_R = 1500.
HEX_SIDE = math.sqrt(2. * math.sqrt(3.)) * HEX_R
HEX_DEM = dict(hexagonal_icebergs=True, constant_length=HEX_SIDE,
               constant_width=HEX_SIDE)


@functools.lru_cache(maxsize=None)
def hex_world(jitter=40.0, seed=3, cap=128):
    """``tests/test_torch_dem_forces.py``'s world with hexagonally packed
    conglomerates: three 6 x 6 units, columns r sqrt(3) apart, rows 2r
    apart, odd columns offset by r (r = 1.5 km), each bonded once as a
    prototype by the JAX package under ``hexagonal_icebergs`` (the radius
    criterion 1.25 x 2 sqrt(A / (2 sqrt 3)) = 3.75 km: six neighbours),
    one bond pair broken, random velocities and ocean depths, in the
    conglomerate-blocked layout of 128-slot blocks."""
    R = HEX_R
    cfg = jax_cfg(**HEX_DEM)
    c, k = np.meshgrid(np.arange(HEX_COLS), np.arange(HEX_ROWS),
                       indexing="ij")
    px = (c * R * math.sqrt(3.)).ravel()
    py = (k * 2 * R + (c % 2) * R).ravel()
    per = px.size
    proto = jforces.initialize_bonds_host(ibt.create_bergs(
        64, lon=px, lat=py, mass=1., thickness=200., width=HEX_SIDE,
        length=HEX_SIDE, mass_scaling=1., max_bonds=6), cfg)
    pbond = np.asarray(proto.bond_idx)[:per]
    pblen = np.asarray(proto.bond_length)[:per]
    assert (pbond >= 0).sum(1).max() == 6
    ext = px.max()
    x0 = 2 * DXY
    origins = [(x0, x0), (x0 + ext + 2.6e3, x0),
               (x0 + ext + 2.6e3, x0 + py.max() + 3.5e3)]
    nu = len(origins)
    n = nu * per
    rng = np.random.RandomState(seed)
    lon = np.concatenate([px + ox for ox, _ in origins]) \
        + rng.uniform(-jitter, jitter, n)
    lat = np.concatenate([py + oy for _, oy in origins]) \
        + rng.uniform(-jitter, jitter, n)
    grid = ibt.make_uniform_grid(NX, NX, 0., 0., DXY, DXY,
                                 grid_is_latlon=False)
    frc = ibt.uniform_forcing(NX, NX, uo=0.25, vo=0.05, ua=5.0, sst=-2.0,
                              sss=34.0)
    st = ibt.create_bergs(cap, lon=lon, lat=lat,
                          uvel=rng.uniform(-0.1, 0.1, n),
                          vvel=rng.uniform(-0.1, 0.1, n),
                          mass=850. * 200. * HEX_SIDE ** 2, thickness=200.,
                          width=HEX_SIDE, length=HEX_SIDE, mass_scaling=1.0,
                          id_cnt=np.arange(n) + 1, max_bonds=6)
    from icebergs_tpu.grid import pos_to_cell
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    od = np.zeros(cap, np.float32)
    od[:n] = rng.uniform(120., 260., n)
    bond_idx = np.full((cap, 6), -1, np.int32)
    bond_len = np.zeros((cap, 6), np.float32)
    cong = np.zeros(cap, np.int32)
    offs = (np.arange(nu) * per)[:, None, None]
    bond_idx[:n] = np.where(pbond[None] >= 0, pbond[None] + offs,
                            -1).reshape(n, 6)
    bond_len[:n] = np.broadcast_to(pblen[None], (nu, per, 6)).reshape(n, 6)
    cong[:n] = np.repeat(np.arange(nu) + 1, per)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, od=jnp.asarray(od),
                    bond_idx=jnp.asarray(bond_idx),
                    bond_length=jnp.asarray(bond_len),
                    conglom_id=jnp.asarray(cong))
    bb = np.asarray(st.bond_broken).copy()
    bi = np.asarray(st.bond_idx)
    p = bi[0, 0]
    bb[0, 0] = 1
    bb[p, bi[p] == 0] = 1
    st = jforces.count_bonds(st.replace(bond_broken=jnp.asarray(bb)))
    return grid, frc, jvmem.pack_conglomerates_blocked(st, 128)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                        tree)


@pytest.mark.parametrize("jitter,flags", [
    (40.0, {}),
    (2.0, {"short_step_mts_grounding": True, "use_grounding_torque": True,
           "frac_thres_n": 1.8e5})], ids=["fracturing", "elastic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dem_outer_step_hexagons_matches_jax(dtype, jitter, flags):
    """One MTS/DEM outer step of hexagonal elements with
    ``radius_based_drag`` (the faces 2 sqrt(L W / (2 sqrt 3))) and the
    hexagonal radii throughout: the port's scan against the JAX scan
    (Part 1 on the tables), float64 first (x64 on in JAX: within
    ``DEM_TOL_64`` of scale), then float32, where the stiff substeps grow
    the rounding of each substep (torch's CPU float32 ``sqrt`` among it)
    to ``DEM_TOL_32`` of scale while fracturing, ``DEM_TOL_32_ELASTIC``
    in the elastic world; in float32 the
    port's K4 plain version (``F_HEX``) against its scan within 5e-6 of
    scale with ``broken_bonds`` equal; with the faces off the step
    differs (they enter the drag)."""
    cfg = jax_cfg(**HEX_DEM, radius_based_drag=True, **flags)
    tcfg = port_cfg(cfg)
    ibp.check_ported(tcfg)
    grid, frc, st = hex_world(jitter=jitter)
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        if dtype == "float64":
            grid, frc, st = _f64(grid), _f64(frc), _f64(st)
            grid, frc, st = (type(x)(**leaves(x)) for x in (grid, frc, st))
        js, jd = eager(jmts.evolve_icebergs_mts, st, grid, frc, cfg,
                       neighbor_mode="tables")
        J = leaves(js)
    finally:
        jax.config.update("jax_enable_x64", False)
    tgrid = ibp.grid_from_numpy(leaves(grid), device=CPU)
    tfrc = ibp.forcing_from_numpy(leaves(frc), device=CPU)
    ts, td = tmts.evolve_icebergs_mts(tstate(st), tgrid, tfrc, tcfg,
                                      neighbor_mode="tables")
    assert ts.lon.dtype == getattr(torch, dtype)
    assert td.conv_iters == int(jd.conv_iters) >= 1
    assert int(td.broken_bonds) == int(jd.broken_bonds)
    if jitter > 10:
        assert int(jd.broken_bonds) > 100
    T = ibp.to_numpy(ts)
    for name in INTS:
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    live = J["alive"]
    tol = (DEM_TOL_64 if dtype == "float64"
           else DEM_TOL_32 if jitter > 10 else DEM_TOL_32_ELASTIC)
    for name in FLOATS:
        close(T[name][live], J[name][live], name, 0., tol)
    if dtype == "float64":
        return
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, 128)
    assert deltas
    tk, tkd = tmts.evolve_icebergs_mts(
        tstate(st), tgrid, tfrc, tcfg, neighbor_mode="tables",
        substep_kernel="vmem", vmem_deltas=deltas, vmem_block_n=128)
    assert int(tkd.broken_bonds) == int(td.broken_bonds)
    K = ibp.to_numpy(tk)
    for name in INTS:
        np.testing.assert_array_equal(T[name], K[name], err_msg=name)
    for name in FLOATS:
        close(T[name], K[name], name, 0., 5e-6)
    off, _ = tmts.evolve_icebergs_mts(
        tstate(st), tgrid, tfrc, tcfg.replace(radius_based_drag=False),
        neighbor_mode="tables")
    assert not torch.equal(off.uvel, ts.uvel)


def test_k4_plain_hexagons_matches_jax():
    """K4's plain version with ``F_HEX`` against the JAX package's
    ``part3_substeps_vmem(interpret=True)`` on the hexagonal world
    (``tests/test_torch_dem.py``'s bound: 2e-3 of scale, integers
    exact)."""
    cfg = jax_cfg(**HEX_DEM, radius_based_drag=True)
    tcfg = port_cfg(cfg)
    from icebergs_tpu_torch.ops import dem_substeps as tk4
    _, _, st = hex_world()
    st = st.replace(axn_fast=st.uvel * 1e-3, ayn_fast=st.vvel * -1e-3,
                    ang_vel=st.uvel * 1e-5)
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, 128)
    jst, jnb = jax.jit(lambda s: jvmem.part3_substeps_vmem(
        s, cfg, deltas, block_n=128, interpret=True))(st)
    tst, tnb = tk4.part3_substeps_vmem(tstate(st), tcfg, deltas,
                                       block_n=128)
    assert tk4.instantiation(tcfg, tst.max_bonds) == "dem_hex"
    assert int(tnb) == int(jnb) > 0
    J, T = leaves(jst), ibp.to_numpy(tst)
    for name in ("bond_broken", "n_bonds", "alive", "bond_idx"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    for name in ("lon", "lat", "uvel", "vvel", "ang_vel", "rot",
                 "bond_length", "bond_nstress"):
        a, b = T[name].astype(np.float64), J[name].astype(np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= 2e-3 * scale, name


# ---- the coupled entry ------------------------------------------------

@pytest.mark.parametrize("style", ["new_bergs", "fl_bits"])
def test_run_hexagons_matches_jax(style):
    """4 coupling steps of ``IcebergsModel.run`` with hexagons, calving
    and footloose (``tests/test_torch_api.py``'s world): the counters
    exact, the state per slot and the coupler fields within that file's
    tolerance, the melt fields within its ``MELT_LIMITS``."""
    cfg, grid, frc, st, calving, hflx = tapi_test._world(style)
    cfg = cfg.replace(**HEX)
    jm = japi.IcebergsModel(grid, cfg)
    tm = tapi.IcebergsModel(ibp.grid_from_numpy(_leaves(grid), device=CPU),
                            ibp.config_from_dict(dataclasses.asdict(cfg)),
                            device=CPU)
    js = jm.init_state(st, seed=3, year=2001, yearday=5.)
    ts = tm.init_state(ibp.state_from_numpy(_leaves(st), device=CPU),
                       seed=3, year=2001, yearday=5.)
    tf = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    calved = fl_calved = 0
    for _ in range(4):
        unif = tapi_test._jax_fl_uniforms(js.key, style)
        js, jo = jm.run(js, frc, jnp.asarray(calving), jnp.asarray(hflx))
        ts, to = tm.run(ts, tf, torch.as_tensor(calving),
                        torch.as_tensor(hflx), fl_uniforms=unif)
        for f in tapi_test._OUT_COUNTS:
            assert int(getattr(to, f)) == int(getattr(jo, f)), f
        for f, lim in tapi_test.MELT_LIMITS.items():
            t = np.asarray(getattr(to, f), np.float64)
            j = np.asarray(getattr(jo, f), np.float64)
            assert np.abs(t - j).max() <= lim * max(np.abs(j).max(),
                                                    1e-30), f
        calved += int(to.nbergs_calved)
        fl_calved += int(to.nbergs_calved_fl)
    assert calved > 0 and fl_calved > 0
    J, T = _leaves(js.bergs), ibp.to_numpy(ts.bergs)
    for name, t in T.items():
        if name in tapi_test.INTS:
            np.testing.assert_array_equal(t, J[name], err_msg=name)
        else:
            tapi_test._close(t[J["alive"]], J[name][J["alive"]], name)
    for f in tapi_test._OUT_FIELDS:
        tapi_test._close(getattr(to, f).numpy(), getattr(jo, f), f)

"""The coupled entry ``IcebergsModel.run`` and the interface against the
JAX package: ``prepare_forcing`` in the B, C and A staggers with the
stress inversion; 6 coupling steps with calving and footloose in both
``fl_style``s (the JAX package's uniforms plugged in); the coupler
fields, counters, budgets and interval-budget scalars; ``stock_pe`` and
``incr_mass``; the checksums bit for bit; and the budgets' closure.

Tolerance (floats, per slot): ``rtol 1e-5`` plus 2e-5 of each field's
largest magnitude, that of ``tests/test_torch_step.py``: XLA:CPU
contracts multiply-adds, torch and XLA round ``pow`` an ulp apart, and
the contact springs amplify those ulps over the steps.  The melt fields
``calving_hflx`` and ``floating_melt`` and the melt scalars are held at
every step to about twice the worst error read against the JAX package
over the 6 steps of both styles (``MELT_LIMITS``; ``pytest -s`` prints
the reading), because a berg's footloose-bits melt is the float32
difference of two nearly equal masses (``Mfl - Mnew_fl``, ~1e12 kg less
~1e9), so the bits' size, one ``pow`` ulp apart, moves a cell's melt by
up to 1e-4 of scale.  Slots, ids, cells, counters and spawn overflows
exact.
"""

import dataclasses
import io
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import api as japi
from icebergs_tpu import diag as jdiag
from icebergs_tpu.footloose import _id_uniform
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import api as tapi
from icebergs_tpu_torch import calving as tcalving
from icebergs_tpu_torch import diag as tdiag
from icebergs_tpu_torch import ids as tids
from icebergs_tpu_torch import timeutils
from icebergs_tpu_torch import trace

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5
# worst read (both styles, 6 steps): calving_hflx 7.7e-5 and
# floating_melt 9.11e-5 of scale; net_melt_heat 2.08e-5, net_melt_kg
# 2.36e-5 and fl_bits_melt_kg 1.02e-4 relative
MELT_LIMITS = {"calving_hflx": 1.6e-4, "floating_melt": 2e-4,
               "net_melt_heat": 5e-5, "net_melt_kg": 5e-5,
               "fl_bits_melt_kg": 2e-4}
INTS = ("alive", "id_cnt", "id_ij", "ine", "jne", "start_year",
        "conglom_id", "bond_idx", "bond_broken")


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _close(t, j, name, atol_scale=ATOL_SCALE):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = np.abs(j).max() if j.size else 0.
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=atol_scale * scale,
                               err_msg=name)


@pytest.mark.parametrize("vel,stress", [("B", "B"), ("C", "C"), ("A", "A"),
                                        ("A_padded", "B")])
@pytest.mark.parametrize("tau", [False, True], ids=["stress", "velocity"])
def test_prepare_forcing_matches_jax(vel, stress, tau):
    """The staggers onto the corners, the Kelvin SST and the NaN scrub
    bit for bit; the inverted stress within the tolerance (XLA:CPU
    contracts ``tau_x**2 + tau_y**2`` into a multiply-add)."""
    nx, ny = 9, 7
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, tau_is_velocity=tau)
    grid = ibt.make_uniform_grid(nx, ny, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    frc = ibt.uniform_forcing(nx, ny, sst=275.)
    rng = np.random.RandomState(1)
    shapes = {"B": (nx + 1, ny + 1), "A": (nx, ny),
              "A_padded": (nx + 2, ny + 2)}

    def field(stag, comp):
        if stag == "C":
            shp = (nx + 1, ny) if comp == "u" else (nx, ny + 1)
        else:
            shp = shapes[stag]
        a = rng.uniform(-0.4, 0.4, shp).astype(np.float32)
        a[0, 0] = np.nan
        return jnp.asarray(a)

    sss = np.asarray(frc.sss).copy()
    sss[3, 3] = np.nan
    frc = frc.replace(uo=field(vel, "u"), vo=field(vel, "v"),
                      ui=field(vel, "u"), vi=field(vel, "v"),
                      ua=field(stress, "u"), va=field(stress, "v"),
                      sss=jnp.asarray(sss))
    vs = "A" if vel == "A_padded" else vel
    jf = japi.prepare_forcing(grid, cfg, frc, vel_stagger=vs,
                              stress_stagger=stress)
    tf = tapi.prepare_forcing(
        ibp.grid_from_numpy(_leaves(grid), device=CPU),
        ibp.config_from_dict(dataclasses.asdict(cfg)),
        ibp.forcing_from_numpy(_leaves(frc), device=CPU), vel_stagger=vs,
        stress_stagger=stress)
    J, T = _leaves(jf), ibp.to_numpy(tf)
    for name, t in T.items():
        assert t.shape == J[name].shape, name
        if name in ("ua", "va") and not tau:
            _close(t, J[name], name)
        else:
            np.testing.assert_array_equal(t, J[name], err_msg=name)
    assert T["uo"].shape == (nx + 1, ny + 1)
    assert np.isfinite(T["sss"]).all()
    np.testing.assert_allclose(T["sst"], 275. - 273.15, rtol=1e-5)


def _world(style, n=40, cap=1024):
    """Tabular bergs with primed feet and footloose bits on a 16x16 grid
    of 5 km cells (two land columns), a steady calving flux along two
    coastal lines, warm windy water."""
    cfg = ibt.IcebergsConfig(
        grid_is_latlon=False, Lx=-1., use_f_plane=True, lat_ref=-60.,
        dt=1800.0, Runge_not_Verlet=False,
        use_new_predictive_corrective=True, footloose=True,
        fl_style=style, fl_youngs=1.e8, fl_strength=250.,
        allow_bergs_to_roll=False, interactive_icebergs_on=True,
        tau_calving=0.2)
    nx = 16
    msk = np.ones((nx, nx))
    msk[:, :2] = 0.
    grid = ibt.make_uniform_grid(nx, nx, 0., 0., 5000., 5000.,
                                 grid_is_latlon=False, msk=msk)
    frc = ibt.uniform_forcing(nx, nx, uo=0.05, ua=12.0, sst=3.0, sss=33.)
    rng = np.random.RandomState(0)
    k = np.arange(n)
    lon = rng.uniform(15e3, 65e3, n)
    lat = rng.uniform(20e3, 65e3, n)
    W, L = rng.uniform(1.2e3, 2e3, n), rng.uniform(2e3, 4e3, n)
    st = ibt.create_bergs(
        cap, lon=lon, lat=lat, thickness=250., width=W, length=L,
        mass=850. * 250. * W * L, mass_scaling=1.0, id_cnt=k + 1,
        id_ij=k + 7, fl_k=np.where(k % 3 == 0, 4e6, 0.),
        mass_of_fl_bits=np.where(k % 5 == 1, 1.6e12, 0.),
        mass_of_fl_bergy_bits=np.where(k % 5 == 1, 2e10, 0.),
        heat_density=rng.uniform(1e3, 2e3, n))
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    calving = np.zeros((nx + 2, nx + 2), np.float32)
    calving[4, 3:nx + 1] = 3e8
    calving[3:nx + 1, 4] = 2e8
    hflx = np.zeros_like(calving)
    hflx[4, 5:9] = 10.
    return cfg, grid, frc, st, calving, hflx


def _jax_fl_uniforms(key, style):
    """The footloose uniforms the JAX ``run`` draws from ``key``: split
    once for footloose (no tidal drift), then as ``footloose_calving``
    splits (``tests/test_torch_footloose.py``)."""
    _, sub = jax.random.split(key)
    k, s0 = jax.random.split(sub)
    _, s1 = jax.random.split(k)
    keys = (s0, s1) if style == "new_bergs" else (None, s0)

    def uniforms(stream, st):
        ids = SimpleNamespace(id_cnt=jnp.asarray(st.id_cnt.numpy()),
                              id_ij=jnp.asarray(st.id_ij.numpy()))
        return torch.tensor(np.asarray(_id_uniform(keys[stream], ids,
                                                   jnp.float32)))
    return uniforms


_OUT_FIELDS = ("calving", "berg_melt", "spread_mass", "spread_area",
               "spread_uvel", "spread_vvel", "ustar_iceberg",
               "mass_on_ocean", "fl_bits_src")
_OUT_SCALARS = ("net_calving_used", "heat_used", "calving_to_bergs",
                "heat_to_bergs", "berg_melt_kg", "bergy_src_kg",
                "bergy_melt_kg", "flb_bergy_melt_kg",
                "flb_internal_eros_kg", "fl_to_berg_kg", "flb_to_bergy_kg")
_OUT_COUNTS = ("nbergs", "contact_overflow", "contact_fallback",
               "spawn_overflow", "fl_spawn_overflow", "tickets",
               "nbergs_calved", "nbergs_calved_fl", "nbergs_melted",
               "nbergs_deleted_fl")


@pytest.mark.parametrize("style", ["new_bergs", "fl_bits"])
def test_run_matches_jax(style):
    """6 coupling steps of ``IcebergsModel.run`` (fused3 contacts,
    calving, footloose) against the JAX entry: the state per slot, every
    output, the budgets and the calving state; then the interval-budget
    tables close."""
    cfg, grid, frc, st, calving, hflx = _world(style)
    jm = japi.IcebergsModel(grid, cfg)
    tm = tapi.IcebergsModel(ibp.grid_from_numpy(_leaves(grid), device=CPU),
                            ibp.config_from_dict(dataclasses.asdict(cfg)),
                            device=CPU)
    js = jm.init_state(st, seed=3, year=2001, yearday=5.)
    ts = tm.init_state(ibp.state_from_numpy(_leaves(st), device=CPU),
                       seed=3, year=2001, yearday=5.)
    tf = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    b0 = tdiag.compute_budgets(ts.bergs, ts.calving)
    acc = tdiag.IntervalBudget()
    tgrid = tm.grid
    calved = fl_calved = 0
    worst = dict.fromkeys(MELT_LIMITS, 0.)
    for _ in range(6):
        unif = _jax_fl_uniforms(js.key, style)
        js, jo = jm.run(js, frc, jnp.asarray(calving), jnp.asarray(hflx))
        ts, to = tm.run(ts, tf, torch.as_tensor(calving),
                        torch.as_tensor(hflx), fl_uniforms=unif)
        for f in _OUT_COUNTS:
            assert int(getattr(to, f)) == int(getattr(jo, f)), f
        # the melt fields (of scale) and scalars (relative), every step
        for f in MELT_LIMITS:
            t = np.asarray(getattr(to, f), np.float64)
            j = np.asarray(getattr(jo, f), np.float64)
            err, scale = np.abs(t - j).max(), np.abs(j).max()
            worst[f] = max(worst[f], float(err / scale) if scale > 0. else
                           (float("inf") if err > 0. else 0.))
        calved += int(to.nbergs_calved)
        fl_calved += int(to.nbergs_calved_fl)
        acc.add_step(to, tgrid, cfg.dt)
    assert ts.step == 6
    assert calved > 0 and fl_calved > 0
    assert int(to.spawn_overflow) == 0 and int(to.fl_spawn_overflow) == 0
    J, T = _leaves(js.bergs), ibp.to_numpy(ts.bergs)
    for name, t in T.items():
        if name in INTS:
            np.testing.assert_array_equal(t, J[name], err_msg=name)
        else:
            _close(t[J["alive"]], J[name][J["alive"]], name)
    for f in _OUT_FIELDS:
        _close(getattr(to, f).numpy(), getattr(jo, f), f)
    print(f"{style}: worst melt error against JAX", worst)
    for f, lim in MELT_LIMITS.items():
        assert worst[f] <= lim, (f, worst[f], lim)
    for f in _OUT_SCALARS:
        _close(float(getattr(to, f)), float(getattr(jo, f)), f)
    for f in ("nbergs", "mass", "mass_of_bits", "heat", "stored_ice",
              "stored_heat", "bergy_mass", "fl_bits_mass"):
        _close(float(getattr(to.budgets, f)), float(getattr(jo.budgets, f)),
               f)
    for f in ("stored_ice", "stored_heat", "rmean_calving",
              "rmean_calving_hflx"):
        _close(getattr(ts.calving, f).numpy(), getattr(js.calving, f), f)
    np.testing.assert_array_equal(ts.calving.id_counter.numpy(),
                                  np.asarray(js.calving.id_counter))
    np.testing.assert_allclose(float(ts.current_yearday),
                               float(js.current_yearday), rtol=1e-7)
    # the category tables close (the reference's budget rows)
    errs = tdiag.report_full_budget("run", b0, to.budgets, acc,
                                    file=io.StringIO())
    assert errs["berg #"] == 0
    for row in ("stored mass", "floating mass", "berg mass",
                "fl bits mass", "stored heat"):
        assert abs(errs[row]) < 2e-3, (row, errs[row])


def test_budgets_close_and_stocks():
    """The coupled run's mass closure as ``tests/test_api.py:38-42``
    checks it (berg mass + bits + stored ice = calving used - melt), the
    water and heat stocks, and ``incr_mass``."""
    cfg, grid, frc, st, calving, hflx = _world("fl_bits")
    tm = tapi.IcebergsModel(ibp.grid_from_numpy(_leaves(grid), device=CPU),
                            ibp.config_from_dict(dataclasses.asdict(cfg)),
                            device=CPU)
    ts = tm.init_state(ibp.state_from_numpy(_leaves(st), device=CPU),
                       seed=5)
    tf = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    b0 = tdiag.compute_budgets(ts.bergs, ts.calving)
    start = float(b0.mass + b0.mass_of_bits + b0.stored_ice)
    used = melt = 0.
    for _ in range(4):
        ts, to = tm.run(ts, tf, torch.as_tensor(calving),
                        torch.as_tensor(hflx))
        used += float(to.net_calving_used)
        melt += float(to.net_melt_kg)
    b = to.budgets
    lhs = float(b.mass + b.mass_of_bits + b.stored_ice)
    np.testing.assert_allclose(lhs, start + used - melt, rtol=1e-4)
    water, heat = tm.stock_pe(ts)
    np.testing.assert_allclose(float(water), lhs, rtol=1e-6)
    assert float(heat) < 0.
    jm = japi.IcebergsModel(grid, cfg)
    js = jm.init_state(st)
    jw, jh = jm.stock_pe(js)
    tw, th = tm.stock_pe(tm.init_state(
        ibp.state_from_numpy(_leaves(st), device=CPU)))
    _close(float(tw), float(jw), "water")
    _close(float(th), float(jh), "heat")
    m0 = np.random.RandomState(2).uniform(0., 1e3, (18, 18))
    jinc = jm.incr_mass(js, jnp.asarray(m0, jnp.float32), frc)
    tinc = tm.incr_mass(tm.init_state(ibp.state_from_numpy(
        _leaves(st), device=CPU)), torch.as_tensor(m0, dtype=torch.float32),
        tf)
    _close(tinc.numpy(), jinc, "incr_mass")


def test_checksums_match_jax_bit_for_bit():
    """calving_chksum, grd_chksum3 (total and per class), grd_chksum2,
    list_chksum_per_cell and bergs_per_cell on scrambled fields."""
    cfg, grid, frc, st, calving, hflx = _world("new_bergs")
    jm = japi.IcebergsModel(grid, cfg)
    js, _ = jm.run(jm.init_state(st, seed=1), frc, jnp.asarray(calving),
                   jnp.asarray(hflx))
    rng = np.random.RandomState(8)
    calv = js.calving.replace(
        stored_heat=jnp.asarray(rng.standard_normal((18, 18)) * 1e9,
                                jnp.float32))
    tcalv = tcalving.CalvingState(
        **{k: torch.as_tensor(np.array(v)) for k, v in _leaves(calv).items()})
    jt, j3 = jdiag.calving_chksum(calv)
    tt, t3 = tdiag.calving_chksum(tcalv)
    assert int(tt) == int(jt)
    assert int(t3["chksum"]) == int(j3["chksum"])
    np.testing.assert_array_equal(t3["per_class"].numpy(),
                                  np.asarray(j3["per_class"]).astype(
                                      np.int64))
    g2, j2 = tdiag.grd_chksum2(tcalv.stored_heat), jdiag.grd_chksum2(
        calv.stored_heat)
    assert int(g2["chksum"]) == int(j2["chksum"])
    for f in ("minv", "maxv", "mean", "rms"):
        _close(float(g2[f]), float(j2[f]), f)
    tst = ibp.state_from_numpy(_leaves(js.bergs), device=CPU)
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    np.testing.assert_array_equal(
        tdiag.list_chksum_per_cell(tst, tgrid).numpy(),
        np.asarray(jdiag.list_chksum_per_cell(js.bergs, grid)))
    np.testing.assert_array_equal(
        tdiag.bergs_per_cell(tst, tgrid).numpy(),
        np.asarray(jdiag.bergs_per_cell(js.bergs, grid)))


def test_report_budget_and_clocks(capsys):
    """report_budget's closure error against the JAX function's on the
    same stocks; the tracer's clock table counts and prints its phases."""
    cfg, grid, frc, st, calving, hflx = _world("fl_bits")
    jm = japi.IcebergsModel(grid, cfg)
    js0 = jm.init_state(st)
    js1, jo = jm.run(js0, frc, jnp.asarray(calving), jnp.asarray(hflx))
    tb = [tdiag.compute_budgets(ibp.state_from_numpy(_leaves(s.bergs),
                                                     device=CPU),
                                tcalving.CalvingState(**{
                                    k: torch.as_tensor(np.array(v))
                                    for k, v in _leaves(s.calving).items()}))
          for s in (js0, js1)]
    jb = [jdiag.compute_budgets(s.bergs, s.calving) for s in (js0, js1)]
    for t, j in zip(tb, jb):
        for f in t._fields:
            _close(float(getattr(t, f)), float(getattr(j, f)), f)
    kw = dict(melt_kg=float(jo.net_melt_kg),
              calving_in_kg=float(jo.net_calving_used))
    terr = tdiag.report_budget("one step", *tb, cfg.dt, **kw)
    jerr = jdiag.report_budget("one step", *jb, cfg.dt, **kw)
    assert "budget [one step]" in capsys.readouterr().out
    assert abs(terr - jerr) <= 1e-5 * float(tb[1].mass)
    clocks = trace.Tracer()
    for _ in range(3):
        with clocks.span("calving"):
            pass
    with clocks.span("thermo"):
        pass
    assert {n: t["calls"] for n, t in clocks.totals().items()} == {
        "calving": 3, "thermo": 1}
    clocks.report("run")
    out = capsys.readouterr().out
    assert "calving" in out and "thermo" in out and "device ms" in out


def test_check_state_ids_and_dates():
    """check_state's invariants, the id helpers and offset_berg_dates
    against the JAX package's."""
    from icebergs_tpu import ids as jids
    from icebergs_tpu import timeutils as jtime
    cfg, grid, frc, st, _, _ = _world("new_bergs")
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    assert tdiag.check_state(tst, tgrid, tcfg) == []
    dup = tst.replace(id_cnt=torch.where(torch.arange(tst.capacity) == 5,
                                         tst.id_cnt[4], tst.id_cnt),
                      id_ij=torch.where(torch.arange(tst.capacity) == 5,
                                        tst.id_ij[4], tst.id_ij))
    np.testing.assert_array_equal(tids.check_for_duplicate_ids(dup),
                                  jids.check_for_duplicate_ids(
                                      st.replace(id_cnt=jnp.asarray(
                                          dup.id_cnt.numpy()),
                                          id_ij=jnp.asarray(
                                              dup.id_ij.numpy()))))
    assert tdiag.check_state(dup, tgrid, tcfg, fatal=False) == [
        "1 duplicate ids"]
    with pytest.raises(RuntimeError, match="duplicate"):
        tdiag.check_state(dup, tgrid, tcfg)
    for cnt, ij in ((3, 17), (2**31 - 1, 5), (7, 2**31 - 1)):
        packed = tids.id_from_2_ints(cnt, ij)
        assert packed == jids.id_from_2_ints(cnt, ij)
        assert tids.split_id(packed) == jids.split_id(packed)
    assert tids.convert_old_id(12345, 40, 30) == jids.convert_old_id(
        12345, 40, 30)
    assert timeutils.yearday(3, 4, 5, 6) == jtime.yearday(3, 4, 5, 6)
    later = st.replace(start_year=st.start_year + 2003,
                       start_day=st.start_day + 40.)
    jo = jtime.offset_berg_dates(later, 2002, 100.)
    to = timeutils.offset_berg_dates(
        ibp.state_from_numpy(_leaves(later), device=CPU), 2002, 100.)
    np.testing.assert_array_equal(to.start_year.numpy(),
                                  np.asarray(jo.start_year))
    np.testing.assert_array_equal(to.start_day.numpy(),
                                  np.asarray(jo.start_day))


def test_unported_entry_points_raise(tmp_path):
    """What the entry once could not serve: restarts, icebergs_end and
    the debug dump (item 12), MTS (item 16) and the halo dump of a tiled
    state (item 13) are served: the files are written, the dump stops the
    run, the halo listing is the JAX package's."""
    cfg, grid, frc, st, _, _ = _world("new_bergs")
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tm = tapi.IcebergsModel(tgrid, tcfg, device=CPU)
    ts = tm.init_state(ibp.state_from_numpy(_leaves(st), device=CPU))
    tm.save_restart(ts, str(tmp_path))
    assert (tmp_path / "icebergs.res.nc").exists()
    assert (tmp_path / "calving.res.nc").exists()
    assert int(tm.end(ts).nbergs) == int(ts.bergs.count())
    with pytest.raises(RuntimeError, match="state dumped"):
        tdiag.debug_write_and_stop(ts.bergs, tcfg,
                                   path=str(tmp_path / "debug.nc"))
    assert (tmp_path / "debug.nc").exists()
    # the halo dump (item 13's first slices, served): a tiled state's
    # listing is the JAX package's text for the same stacked slabs
    h = st.capacity // 2
    tiles = [ibp.BergState(**{f: getattr(ts.bergs, f)[k * h:(k + 1) * h]
                              for f in _leaves(ts.bergs)}) for k in (0, 1)]
    stacked = jax.tree.map(lambda x: x[:2 * h].reshape((2, h) + x.shape[1:]),
                           st)
    jo, to = io.StringIO(), io.StringIO()
    jdiag.dump_halo_state(stacked, "tiles", file=jo)
    tdiag.dump_halo_state(tiles, "tiles", file=to)
    assert to.getvalue() == jo.getvalue()
    assert to.getvalue().count("\nA ") == int(ts.bergs.count()) > 0
    # MTS (item 16, served): an outer step runs through the entry
    mts = tcfg.replace(mts=True, dem=True, iceberg_bonds_on=True,
                       interactive_icebergs_on=True, footloose=False)
    mm = tapi.IcebergsModel(tgrid, mts, device=CPU)
    _, mo = mm.run(mm.init_state(ibp.state_from_numpy(_leaves(st),
                                                      device=CPU)),
                   ibp.forcing_from_numpy(_leaves(frc), device=CPU))
    assert mo.mts is not None and mo.mts.conv_iters == 0
    assert int(mo.mts.broken_bonds) == 0 and int(mo.nbergs) > 0
    # the entry runs on the card unless told otherwise
    if torch.cuda.is_available():
        assert tapi.IcebergsModel(tgrid, tcfg).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tapi.IcebergsModel(tgrid, tcfg)


def test_run_mts_matches_jax():
    """Two MTS coupling steps of ``IcebergsModel.run`` against the JAX
    entry, which evolves by ``evolve_icebergs_mts(st, grid, frc, cfg)``:
    Part 1 on the candidate tables (K7's plain version at M = 400), the
    scan substeps, ``interp_flds``, thermodynamics and the spreading, on
    ``tests/test_torch_dem_forces.py``'s three conglomerates with the iKID
    flag set.  Counts exact; the state and the coupler fields within the
    whole-MTS-step tolerance of ``tests/test_torch_mts.py`` (rtol 1e-4 and
    2e-3 of scale: XLA:CPU's multiply-adds in the interpolation and the
    pair terms, grown over 12 stiff substeps)."""
    from test_torch_dem_forces import jax_cfg, world
    cfg = jax_cfg()
    grid, frc, st = world()
    jm = japi.IcebergsModel(grid, cfg)
    tm = tapi.IcebergsModel(ibp.grid_from_numpy(_leaves(grid), device=CPU),
                            ibp.config_from_dict(dataclasses.asdict(cfg)),
                            device=CPU)
    js = jm.init_state(st, seed=1)
    ts = tm.init_state(ibp.state_from_numpy(_leaves(st), device=CPU),
                       seed=1)
    tf = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    for _ in range(2):
        js, jo = jm.run(js, frc)
        ts, to = tm.run(ts, tf)
        for f in ("nbergs", "contact_overflow", "spawn_overflow",
                  "nbergs_melted"):
            assert int(getattr(to, f)) == int(getattr(jo, f)), f
        assert to.mts.conv_iters >= 1 and to.mts.p1_overflow is None
    J, T = _leaves(js.bergs), ibp.to_numpy(ts.bergs)
    live = J["alive"]
    for name, t in T.items():
        if name in INTS + ("n_bonds",):
            np.testing.assert_array_equal(t, J[name], err_msg=name)
        elif t.dtype.kind == "f":
            np.testing.assert_allclose(
                t[live], J[name][live], rtol=1e-4,
                atol=2e-3 * max(np.abs(J[name][live]).max(), 1e-30),
                err_msg=name)
    for f in _OUT_FIELDS[:-1] + ("floating_melt",):
        _close(getattr(to, f).numpy(), getattr(jo, f), f, 2e-3)

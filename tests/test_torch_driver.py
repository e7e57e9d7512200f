"""The port's stand-alone driver (``icebergs_tpu_torch/driver.py``) against
the JAX package's ``driver.run`` on ``tests/test_driver.py``'s and
``tests/test_driver_growth.py``'s namelists and worlds: the final state
and every output file (restart triplet, trajectories, history), the
growth events the two print, the A68 transient branch and
``--dtype float64``; the exact-restart property through the port's
restart files; a kernel that fails raises out of ``run`` (no fallback
lane); the driver and the I/O modules import no JAX; the CLI; and the
coupled entry's ``save_restart`` / ``end``.

Tolerance (floats, per slot and per file entry): ``rtol 1e-5`` plus 2e-5
of each field's largest magnitude, ``tests/test_torch_api.py``'s
(XLA:CPU contracts multiply-adds, which the port rounds apart; a few
ulps over the runs).  Integers, cells, counts and the growth events
exact; the history's per-cell hash of the bits (``list_chksum``) is
compared where the states are bitwise only.  The exact restart is
bitwise.  The DEM namelist's comparisons are in
``tests/test_torch_driver_dem.py``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import icebergs_tpu as ibt
from icebergs_tpu import api as japi
from icebergs_tpu import driver as jdrv
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.io import restart as jrio
from icebergs_tpu.io import trajectory as jtio

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import api as tapi
from icebergs_tpu_torch import diag as tdiag
from icebergs_tpu_torch import driver as tdrv
from icebergs_tpu_torch.io import restart as trio
from icebergs_tpu_torch.io import trajectory as ttio

import test_driver
import test_driver_growth
from test_torch_footloose import jax_uniforms

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5
INTS = ("alive", "ine", "jne", "start_year", "id_cnt", "id_ij",
        "conglom_id", "bond_idx", "bond_broken", "bond_id_cnt",
        "bond_id_ij")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _close(t, j, name):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = np.abs(j).max() if j.size else 0.
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=name)


def same_states(t, j, close=_close):
    """Integers exact, floats by ``close`` on the live slots."""
    J, T = _leaves(j), ibp.to_numpy(t)
    alive = J["alive"]
    for name, v in T.items():
        if name in INTS or v.dtype == bool:
            np.testing.assert_array_equal(v, J[name], err_msg=name)
        else:
            close(v[alive], J[name][alive], name)


def read_nc(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:]) for k, v in f.variables.items()}


# the history's ratio fields (a cell's sum over its spread area): where
# a berg sits on a cell's mid-line, one ulp of its position (XLA:CPU's
# multiply-adds, ROADMAP.md Queue 3) puts an area of ~1e-9 of a berg's on
# the neighbour cell in one package and none in the other, and the ratio
# there is the berg's whole velocity or 0.  They are compared on the
# cells whose spread area is above SPREAD_FLOOR of its largest in both
RATIO_FIELDS = ("spread_uvel", "spread_vvel", "ustar_iceberg")
SPREAD_FLOOR = 1e-6
# the history's cell averages (sums of a cell's bergs, averaged over the
# steps) against the largest cell: where the bergs' velocities cancel in
# a cell, the bergs' errors (held per slot to 2e-5 of the slots' scale)
# stand against a smaller cell value
HISTORY_ATOL_SCALE = 1e-4


def same_outputs(tdir, jdir, close=_close, bitwise_states=False):
    """Every file the JAX driver wrote, the port wrote too, with the
    same variables in the same order: integers exact, floats by
    ``close`` (the history's by ``HISTORY_ATOL_SCALE``, its ratio fields
    on the cells with a spread area)."""
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for fname in names:
        J, T = read_nc(os.path.join(jdir, fname)), read_nc(
            os.path.join(tdir, fname))
        assert list(T) == list(J), fname
        history = "spread_area" in J
        if history:
            a = np.minimum(J["spread_area"], T["spread_area"])
            covered = a > SPREAD_FLOOR * max(J["spread_area"].max(), 1e-30)
        for k, v in J.items():
            assert T[k].shape == v.shape and T[k].dtype == v.dtype, (fname, k)
            if k == "list_chksum" and not bitwise_states:
                continue                 # a hash of every bit of the state
            t = T[k]
            if history and k in RATIO_FIELDS:
                t, v = t[covered], v[covered]
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(t, v, err_msg=f"{fname} {k}")
            elif history and close is _close:
                np.testing.assert_allclose(
                    t, v, rtol=RTOL, err_msg=f"{fname} {k}",
                    atol=HISTORY_ATOL_SCALE * np.abs(v).max(initial=0.))
            else:
                close(t, v, f"{fname} {k}")
    return names


def run_both(tmp_path, capsys=None, port_kw=None, **kw):
    """The JAX driver and the port's (on the CPU, with ``port_kw`` too)
    on one input directory; returns (JAX state, port state, their output
    dirs, their ``KID-TPU driver`` lines)."""
    nml_path = str(tmp_path / "input.nml")
    jo, to = str(tmp_path / "out_jax"), str(tmp_path / "out_port")

    def driver_lines():
        if capsys is None:
            return []
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("KID-TPU driver:")
                and " in " not in ln and "per simulated" not in ln]
    j = jdrv.run(nml_path, str(tmp_path), jo, verbose=False, **kw)
    lines = [driver_lines()]
    t = tdrv.run(nml_path, str(tmp_path), to, verbose=False, device="cpu",
                 **kw, **(port_kw or {}))
    lines.append(driver_lines())
    return j, t, jo, to, lines


def _nml_world(tmp_path, nml=test_driver.NML, n=3):
    """``tests/test_driver.py:42``'s initial condition."""
    (tmp_path / "input.nml").write_text(nml)
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=20000.)
    grid = ibt.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    st = ibt.create_bergs(64, lon=[5000., 9000., 13000.][:n],
                          lat=[9500., 10500., 9000.][:n],
                          mass=850. * 20 * 100 * 100, thickness=20.,
                          width=100., length=100., mass_scaling=1.)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    jrio.write_restart_bergs(str(tmp_path / "icebergs.res.nc"),
                             st.replace(ine=i, jne=j, xi=xi, yj=yj), cfg)


def test_driver_matches_jax(tmp_path, capsys):
    """``tests/test_driver.py:42`` through both drivers, with the
    assertions of that test on the port's run."""
    _nml_world(tmp_path)
    j, t, jo, to, lines = run_both(tmp_path, capsys, capacity=64)
    same_states(t, j)
    names = same_outputs(to, jo)
    assert names == ["calving.res.nc", "iceberg_trajectories.nc",
                     "icebergs.res.nc", "icebergs_history.nc"]
    assert lines[0] == lines[1]
    lon = t.lon.numpy()[t.alive.numpy()]
    assert np.all(lon > np.array([5000., 9000., 13000.]))
    assert read_nc(os.path.join(to, "iceberg_trajectories.nc"))[
        "lon"].shape[0] == 12


def test_driver_reads_and_prints(tmp_path, capsys):
    """A verbose run: the budget tables, progress lines and checksum as
    the JAX driver prints them (the numbers within the tolerance), and
    a report of the loop's host reads and files."""
    _nml_world(tmp_path, test_driver.NML.replace(
        "traj_sample_hrs=1.0", "traj_sample_hrs=1.0\n  verbose_hrs=1."))
    nml = str(tmp_path / "input.nml")
    rep = {}
    tdrv.run(nml, str(tmp_path), str(tmp_path / "o"), capacity=64,
             device="cpu", report=rep)
    out = capsys.readouterr().out
    for key in ("bergs_chksum", "budget [hr 1]", "budget tables [hr 1]",
                "step 24/24 bergs=3"):
        assert key in out, key
    assert rep["steps"] == 24 and rep["loop_s"] > 0 and rep["io_s"] > 0
    # a progress line every 2 steps and a budget table every hour read
    # the device; the steps themselves read nothing
    assert rep["host_reads"] == 12 + 4
    assert rep["files"]["icebergs.res.nc"] == os.path.getsize(
        str(tmp_path / "o" / "icebergs.res.nc"))


def test_driver_float64_matches_jax(tmp_path):
    """``--dtype float64`` threads float64 through the grid, forcing and
    state as the JAX driver does with x64 on (the model then runs as
    plain PyTorch: the kernels take float32 slabs); a float64 state's
    checksum hashes both words of each value, as the JAX package's."""
    from icebergs_tpu import diag as jdiag
    _nml_world(tmp_path)
    try:
        j, t, jo, to, _ = run_both(tmp_path, capacity=64, dtype="float64")
        jcs, jn = (int(x) for x in jdiag.berg_chksum(j))
        J = _leaves(j)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert t.lon.dtype == torch.float64 and J["lon"].dtype == np.float64
    same_states(t, j)
    same_outputs(to, jo)
    cs, n = tdiag.berg_chksum(ibp.state_from_numpy(J, device=CPU))
    assert (int(cs), int(n)) == (jcs, jn)


def _growth_fl_world(tmp_path):
    """``tests/test_driver_growth.py:61``'s 4 primed parents in a 5-slot
    pool."""
    (tmp_path / "input.nml").write_text(test_driver_growth.NML)
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1., footloose=True,
                             fl_style='new_bergs', fl_youngs=1.e8,
                             fl_strength=250.)
    grid = ibt.make_uniform_grid(20, 20, 0., 0., 5000., 5000.,
                                 grid_is_latlon=False)
    T = 250.
    fa = test_driver_growth._foot_area(cfg, T)
    st = ibt.create_bergs(5, lon=[30000., 50000., 70000., 40000.],
                          lat=[30000., 50000., 70000., 60000.],
                          thickness=T, width=6000., length=8000.,
                          mass=850. * T * 6000. * 8000.,
                          mass_scaling=1., fl_k=1.5 * fa)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    jrio.write_restart_bergs(str(tmp_path / "icebergs.res.nc"),
                             st.replace(ine=i, jne=j, xi=xi, yj=yj), cfg)
    return dict(capacity=5)


def _growth_fused_world(tmp_path):
    """``tests/test_driver_growth.py:123``'s 40-berg knot, fallback cap
    8."""
    (tmp_path / "input.nml").write_text(test_driver_growth.FUSED_NML)
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.,
                             interactive_icebergs_on=True)
    rng = np.random.RandomState(0)
    n = 40
    st = ibt.create_bergs(64, lon=7700. + rng.uniform(-150., 150., n),
                          lat=7700. + rng.uniform(-150., 150., n),
                          thickness=40., width=400., length=400.,
                          mass=850. * 40. * 400. * 400., mass_scaling=1.,
                          id_cnt=np.arange(n) + 1)
    grid = ibt.make_uniform_grid(16, 16, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    jrio.write_restart_bergs(str(tmp_path / "icebergs.res.nc"),
                             st.replace(ine=i, jne=j, xi=xi, yj=yj), cfg)
    return dict(capacity=64, cfg_overrides={"fused_fallback_cap": 8})


@pytest.mark.parametrize("case", ["fl_spawn", "fused_fallback"])
def test_driver_growth_matches_jax(tmp_path, capsys, case):
    """The growth-and-re-run loop: the same events printed (capacity or
    fallback cap, at the same step), the same final capacity, the
    states and files within the tolerance.  The footloose uniforms are
    the JAX driver's ``fold_in(PRNGKey(7), n)`` draws."""
    kw = (_growth_fl_world if case == "fl_spawn"
          else _growth_fused_world)(tmp_path)
    port_kw = dict(fl_uniforms=lambda n: jax_uniforms(
        jax.random.fold_in(jax.random.PRNGKey(7), n), "new_bergs"))
    j, t, jo, to, lines = run_both(tmp_path, capsys, port_kw, **kw)
    want = ("growing capacity" if case == "fl_spawn"
            else "contact fallback cap overran")
    assert any(want in ln for ln in lines[1]), lines
    assert lines[0] == lines[1]
    assert t.capacity == j.capacity
    same_states(t, j)
    same_outputs(to, jo)
    if case == "fl_spawn":
        assert int(t.count()) == 8
        assert (t.fl_k.numpy()[t.alive.numpy()] < 0.).sum() == 4


def test_driver_transient_a68_matches_jax(tmp_path):
    """``tests/test_driver.py:78``'s A68 branch (hourly frames, the
    half-hour blend) on schema-identical synthetic files."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import run_a68
    from icebergs_tpu.io import a68
    from icebergs_tpu_torch.io import a68 as ta68
    d = tmp_path / "data"
    d.mkdir()
    run_a68.write_synthetic(str(d), ni=24, nj=16, nt=12)
    (tmp_path / "input.nml").write_text(A68_NML % d)
    cfg = ibt.IcebergsConfig(grid_is_latlon=True, grid_is_regular=True,
                             Lx=360.)
    data = a68.load_a68(str(d), cfg)
    tdata = ta68.load_a68(str(d), ibp.config_from_dict(
        dataclasses.asdict(cfg)), device=CPU)
    J = _leaves(data.grid)
    for k, v in ibp.to_numpy(tdata.grid).items():
        if k in ("lon0g", "lat0g"):      # the port's tile origin: untiled
            assert v is None
            continue
        # the untiled tile metadata: the JAX offsets None, the port's 0
        np.testing.assert_array_equal(
            v, 0 if J[k] is None and isinstance(v, int) else J[k],
            err_msg=k)
    for h in (0, 5, 40):
        jf, tf = a68.forcing_at_hour(data, h), ta68.forcing_at_hour(tdata, h)
        for k, v in _leaves(jf).items():
            np.testing.assert_array_equal(getattr(tf, k).numpy(), v)
    lon_c = float(np.asarray(data.grid.lon0)) \
        + 0.5 * data.grid.nx * float(np.asarray(data.grid.dlon))
    lat_c = float(np.asarray(data.grid.lat0)) \
        + 0.5 * data.grid.ny * float(np.asarray(data.grid.dlat))
    st = ibt.create_bergs(16, lon=[lon_c], lat=[lat_c], mass=8.5e10,
                          thickness=200., width=2000., length=2000.,
                          mass_scaling=1., id_cnt=[1])
    i, j, xi, yj = pos_to_cell(data.grid, st.lon, st.lat, 360.)
    jrio.write_restart_bergs(str(tmp_path / "icebergs.res.nc"),
                             st.replace(ine=i, jne=j, xi=xi, yj=yj), cfg)
    j, t, jo, to, _ = run_both(tmp_path, capacity=16)
    same_states(t, j)
    same_outputs(to, jo)
    assert float(t.lon[0]) != lon_c


A68_NML = """
&icebergs_driver_nml
  a68_test=.true.
  transient_a68_data_start_ind=2
  data_dir='%s/'
  ibdt=1800.
  ibhrs=2
  saverestart=.true.
/
&icebergs_nml
  grid_is_latlon=.true.
  grid_is_regular=.true.
  Lx=360.
  set_melt_rates_to_zero=.true.
  verbose_hrs=2
/
"""


def test_a68_needs_half_or_whole_hours(tmp_path):
    (tmp_path / "input.nml").write_text(
        (A68_NML % tmp_path).replace("ibdt=1800.", "ibdt=600."))
    with pytest.raises(SystemExit, match="30 min or 1 hr"):
        tdrv.run(str(tmp_path / "input.nml"), str(tmp_path),
                 str(tmp_path / "o"), device="cpu")


EXACT_NML = test_driver.NML.replace("ibhrs=4", "ibhrs=%d").replace(
    "&icebergs_nml", "&icebergs_nml\n  interactive_icebergs_on=.true.\n"
    "  spring_coef=1.e-5")


def test_exact_restart_equivalence(tmp_path):
    """``tests/test_exact_restart.py`` on the port: 5 steps, the port's
    restart written and read, 5 more steps equal 10 uninterrupted steps
    bit for bit (checksum and every field of the restart)."""
    cfg = ibp.IcebergsConfig(grid_is_latlon=False, Lx=-1.,
                             use_f_plane=True, lat_ref=30., dt=600.,
                             Runge_not_Verlet=False,
                             use_new_predictive_corrective=True,
                             interactive_icebergs_on=True, spring_coef=1e-5)
    grid = ibp.make_uniform_grid(16, 16, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, device=CPU)
    frc = ibp.uniform_forcing(16, 16, uo=0.2, ua=4., sst=3., sss=33.,
                              device=CPU)
    rng = np.random.RandomState(9)
    n = 6
    st = ibp.create_bergs(32, lon=rng.uniform(3000., 13000., n),
                          lat=rng.uniform(3000., 13000., n),
                          mass=850. * 50 * 200 * 200, thickness=50.,
                          width=200., length=200., mass_scaling=1.,
                          id_cnt=np.arange(n) + 1, device=CPU)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    step = ibp.make_step(grid, cfg, with_thermo=True)
    s_ref = st
    for _ in range(10):
        s_ref, _ = step(s_ref, frc)
    s = st
    for _ in range(5):
        s, _ = step(s, frc)
    path = str(tmp_path / "icebergs.res.nc")
    trio.write_restart_bergs(path, s, cfg)
    s2 = trio.read_restart_bergs(path, 32, grid, cfg)
    for _ in range(5):
        s2, _ = step(s2, frc)
    assert [int(x) for x in tdiag.berg_chksum(s_ref)] == \
        [int(x) for x in tdiag.berg_chksum(s2)]
    a, b = str(tmp_path / "a.nc"), str(tmp_path / "b.nc")
    trio.write_restart_bergs(a, s_ref, cfg)
    trio.write_restart_bergs(b, s2, cfg)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_driver_exact_restart(tmp_path):
    """Through the driver: 12 steps writing a restart, 12 more from it,
    equal 24 uninterrupted steps bit for bit (contacts on)."""
    _nml_world(tmp_path, EXACT_NML % 4)
    (tmp_path / "half.nml").write_text(EXACT_NML % 2)
    kw = dict(capacity=64, verbose=False, device="cpu")
    full = tdrv.run(str(tmp_path / "input.nml"), str(tmp_path),
                    str(tmp_path / "full"), **kw)
    tdrv.run(str(tmp_path / "half.nml"), str(tmp_path),
             str(tmp_path / "h1"), **kw)
    h2 = tdrv.run(str(tmp_path / "half.nml"), str(tmp_path / "h1"),
                  str(tmp_path / "h2"), **kw)
    assert [int(x) for x in tdiag.berg_chksum(full)] == \
        [int(x) for x in tdiag.berg_chksum(h2)]
    F, H = ibp.to_numpy(full), ibp.to_numpy(h2)
    for name, v in F.items():
        np.testing.assert_array_equal(H[name], v, err_msg=name)
    assert open(tmp_path / "full" / "icebergs.res.nc", "rb").read() == \
        open(tmp_path / "h2" / "icebergs.res.nc", "rb").read()


def test_failing_kernel_raises_out_of_run(tmp_path, monkeypatch):
    """No step-0 fallback lane: a kernel wrapper that fails (as a CUDA
    kernel that does not build or launch would) raises out of
    ``driver.run``."""
    from icebergs_tpu_torch.ops import segment_spread

    def broken(*a, **k):
        raise RuntimeError("K3 failed to launch")
    monkeypatch.setattr(segment_spread, "segment_spread_sums_count", broken)
    _nml_world(tmp_path)
    with pytest.raises(RuntimeError, match="K3 failed to launch"):
        tdrv.run(str(tmp_path / "input.nml"), str(tmp_path),
                 str(tmp_path / "o"), capacity=64, verbose=False,
                 device="cpu")


def test_driver_and_io_import_no_jax():
    code = ("import sys\n"
            "import icebergs_tpu_torch.driver, icebergs_tpu_torch.diagnostics\n"
            "import icebergs_tpu_torch.native\n"
            "from icebergs_tpu_torch.io import a68, namelist, restart, "
            "trajectory\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'icebergs_tpu.')) or m == 'icebergs_tpu')\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    _nml_world(tmp_path)
    tdrv.main(["--nml", str(tmp_path / "input.nml"), "--input-dir",
               str(tmp_path), "--output-dir", str(tmp_path / "o"),
               "--capacity", "64", "--device", "cpu", "--clocks"])
    out = capsys.readouterr().out
    assert "bergs_chksum" in out and "Icebergs-step" in out
    assert (tmp_path / "o" / "icebergs.res.nc").exists()


def test_model_save_restart_and_end(tmp_path):
    """``IcebergsModel.save_restart`` writes the JAX package's restart
    triplet byte for byte for the same state; ``end`` drains a
    trajectory buffer and returns the budgets."""
    cfg, grid, st = _bonded_world()
    jm = japi.IcebergsModel(grid, cfg)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tm = tapi.IcebergsModel(ibp.grid_from_numpy(_leaves(grid), device=CPU),
                            tcfg, device=CPU)
    js = jm.init_state(st)
    ts = tm.init_state(ibp.state_from_numpy(_leaves(st), device=CPU))
    jm.save_restart(js, str(tmp_path / "j"))
    tm.save_restart(ts, str(tmp_path / "t"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["bonds_iceberg.res.nc", "calving.res.nc",
                     "icebergs.res.nc"]
    for f in names:
        assert open(tmp_path / "j" / f, "rb").read() == \
            open(tmp_path / "t" / f, "rb").read(), f
    jb = jtio.record_posn(jtio.init_traj_buffer(st.capacity, 2, cfg), st,
                          cfg, day=1., year=0)
    tb = ttio.record_posn(ttio.init_traj_buffer(st.capacity, 2, tcfg,
                                                device=CPU),
                          ts.bergs, tcfg, day=1., year=0)
    jbud = jm.end(js, str(tmp_path / "j"), traj_buffer=jb)
    tbud = tm.end(ts, str(tmp_path / "t"), traj_buffer=tb)
    assert open(tmp_path / "j" / cfg.traj_name, "rb").read() == \
        open(tmp_path / "t" / cfg.traj_name, "rb").read()
    for k in ("nbergs", "mass", "heat"):
        _close(float(getattr(tbud, k)), float(getattr(jbud, k)), k)


def _bonded_world():
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0, dt=600.,
                             iceberg_bonds_on=True, dem=True, mts=True,
                             max_bonds=4,
                             length_for_manually_initialize_bonds=600.)
    grid = ibt.make_uniform_grid(10, 10, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    st = ibt.create_bergs(32, lon=[2500., 2900., 7700.],
                          lat=[2500., 2500., 7100.], mass=[1e8, 2e8, 3e8],
                          thickness=[10., 20., 30.], width=[30., 40., 50.],
                          length=[60., 70., 80.], mass_scaling=1.,
                          id_cnt=[1, 2, 3], max_bonds=4)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    from icebergs_tpu.ops import forces as jforces
    return cfg, grid, jforces.initialize_bonds_host(
        st.replace(ine=i, jne=j, xi=xi, yj=yj), cfg)


def _relocalisation_world(pkg, device_kw, n=2000, nx=32, dxy=2000.):
    """The headline world's flags (contacts, rolling, melt) at 2000 bergs
    on 32 x 32 cells of 2 km, uniform forcing: the driver's 13a world
    cut to the CPU."""
    cfg = pkg.IcebergsConfig(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=45.0,
        dt=600.0, Runge_not_Verlet=False, interactive_icebergs_on=True,
        use_new_predictive_corrective=True, allow_bergs_to_roll=True,
        fused_fallback_cap=2048)
    grid = pkg.make_uniform_grid(nx, nx, 0., 0., dxy, dxy,
                                 grid_is_latlon=False, **device_kw)
    grid = grid.replace(ocean_depth=grid.ocean_depth * 0. + 1000.)
    frc = pkg.uniform_forcing(nx, nx, uo=0.3, ua=5.0, sst=4.0, sss=33.0,
                              **device_kw)
    rng = np.random.RandomState(0)
    st = pkg.create_bergs(n, lon=rng.uniform(2 * dxy, (nx - 2) * dxy, n),
                          lat=rng.uniform(2 * dxy, (nx - 2) * dxy, n),
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.0,
                          **device_kw)
    return cfg, grid, frc, st


def test_restart_relocalisation_is_not_exact(tmp_path):
    """ROADMAP.md Queue 3 (reference side): a restart holds no ``xi`` /
    ``yj``; the reader re-localises every berg by ``pos_to_cell``, whose
    fractions differ by an ulp from those the walk carried, so with
    contacts on "4 steps + restart + 4 steps" is not "8 steps" bit for
    bit, in the JAX package as in the port (a few bergs an ulp apart).
    With the walk's fractions put back, the port's run is bitwise."""
    from icebergs_tpu import diag as jdiag

    def halves(pkg, rio, step, st, grid, cfg, frc, keep_xi=False):
        a = st
        for _ in range(8):
            a, _ = step(a, frc)
        b = st
        for _ in range(4):
            b, _ = step(b, frc)
        path = str(tmp_path / "half.nc")
        rio.write_restart_bergs(path, b, cfg)
        r = rio.read_restart_bergs(path, st.capacity, grid, cfg)
        if keep_xi:
            r = r.replace(xi=b.xi, yj=b.yj)
        for _ in range(4):
            r, _ = step(r, frc)
        return a, r

    cfg, grid, frc, st = _relocalisation_world(ibt, {})
    frc = japi.prepare_forcing(grid, cfg, frc)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    a, r = halves(ibt, jrio, ibt.make_step(grid, cfg), st, grid, cfg, frc)
    assert int(jdiag.berg_chksum(a)[0]) != int(jdiag.berg_chksum(r)[0])
    assert 0 < int((np.asarray(a.lon) != np.asarray(r.lon)).sum()) < 200

    tcfg, tgrid, tfrc, tst = _relocalisation_world(ibp, dict(device=CPU))
    tfrc = tapi.prepare_forcing(tgrid, tcfg, tfrc)
    i, j, xi, yj = ibp.pos_to_cell(tgrid, tst.lon, tst.lat, -1.0)
    tst = tst.replace(ine=i, jne=j, xi=xi, yj=yj)
    step = ibp.make_step(tgrid, tcfg)
    a, r = halves(ibp, trio, step, tst, tgrid, tcfg, tfrc)
    differ = int((a.lon != r.lon).sum())
    assert 0 < differ < 400
    lon = a.lon.numpy()
    assert float((a.lon - r.lon).abs().max()) <= float(
        np.spacing(np.abs(lon).max(), dtype=np.float32))
    a, r = halves(ibp, trio, step, tst, tgrid, tcfg, tfrc, keep_xi=True)
    F, R = ibp.to_numpy(a), ibp.to_numpy(r)
    for name in ("lon", "lat", "uvel", "vvel", "mass", "xi", "yj", "ine"):
        np.testing.assert_array_equal(R[name], F[name], err_msg=name)

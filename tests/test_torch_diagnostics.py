"""The port's diagnostics manager (``icebergs_tpu_torch/diagnostics.py``)
against the JAX package's: ``DiagManager`` accumulation and flush
(``tests/test_diagnostics.py:12``), the history file byte for byte for
the same fields, ``collect_step_fields`` from the coupled entry's
``RunOutputs`` (``tests/test_diagnostics.py:38``) and from a step's
``StepDiags`` with the forcing copies and the per-cell fields, and
``monitor_a_berg``.

Tolerance: none where both packages see the same inputs (the
accumulation is a sum in step order, the flush one division); the
fields of a coupled step within ``tests/test_torch_api.py``'s tolerance
(XLA:CPU's multiply-adds), its integer fields exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
from scipy.io import netcdf_file

import icebergs_tpu as ibt
from icebergs_tpu import diagnostics as jdg
from icebergs_tpu.api import IcebergsModel as JModel
from icebergs_tpu.grid import pos_to_cell

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import diagnostics as tdg
from icebergs_tpu_torch.api import IcebergsModel as TModel

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL_SCALE = 1e-5, 2e-5


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _grid(nx=6, ny=5):
    g = ibt.make_uniform_grid(nx, ny, 0., 0., 1000., 1000.,
                              grid_is_latlon=False)
    return g, ibp.grid_from_numpy(_leaves(g), device=CPU)


def test_diag_manager_accumulate_and_flush(tmp_path):
    """``tests/test_diagnostics.py:12`` on the port, and the same file
    as the JAX package's."""
    jg, tg = _grid()
    jm = jdg.DiagManager(jg, selected=("floating_melt", "spread_mass"))
    tm = tdg.DiagManager(tg, selected=("floating_melt", "spread_mass"))
    js, ts = jm.init_state(), tm.init_state()
    f1 = np.zeros((8, 7), np.float32)
    f1[3, 3] = 2.0
    f2 = np.zeros((8, 7), np.float32)
    f2[2, 2] = 10.0
    for k in (1, 2):
        js = jm.send_data(js, {"floating_melt": jnp.asarray(f1 * k),
                               "spread_mass": jnp.asarray(f2)})
        ts = tm.send_data(ts, {"floating_melt": torch.as_tensor(f1 * k),
                               "spread_mass": torch.as_tensor(f2)})
    assert ts.count == 2
    jp, tp = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    js = jm.flush(js, jp, time_value=1.5)
    ts = tm.flush(ts, tp, time_value=1.5)
    assert ts.count == 0
    with netcdf_file(tp, "r", mmap=False) as f:
        fm = np.asarray(f.variables["floating_melt"][:])
        sm = np.asarray(f.variables["spread_mass"][:])
        tv = np.asarray(f.variables["Time"][:])
    assert tv[0] == 1.5
    np.testing.assert_allclose(fm[0, 2, 2], 3.0)
    np.testing.assert_allclose(sm[0, 1, 1], 10.0)
    # a second record grows the unlimited Time axis in place
    js = jm.send_data(js, {"floating_melt": jnp.asarray(f1)})
    ts = tm.send_data(ts, {"floating_melt": torch.as_tensor(f1)})
    jm.flush(js, jp, time_value=2.5)
    tm.flush(ts, tp, time_value=2.5)
    assert open(jp, "rb").read() == open(tp, "rb").read()


def _coupled(n_steps=2):
    """``tests/test_diagnostics.py:38``'s world, one berg with melt."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1., use_f_plane=True,
                             dt=600.)
    jg, tg = _grid()
    frc = ibt.uniform_forcing(6, 5, sst=2.0, uo=0.1)
    st = ibt.create_bergs(8, lon=[2500., 3600.], lat=[2500., 1700.],
                          mass=1e8, thickness=20., width=40., length=50.,
                          mass_scaling=1., id_cnt=[1, 2])
    i, j, xi, yj = pos_to_cell(jg, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    jm, tm = JModel(jg, cfg), TModel(tg, tcfg, device=CPU)
    js = jm.init_state(st)
    ts = tm.init_state(ibp.state_from_numpy(_leaves(st), device=CPU))
    tf = ibp.forcing_from_numpy(_leaves(frc), device=CPU)
    for _ in range(n_steps):
        js, jo = jm.run(js, frc)
        ts, to = tm.run(ts, tf)
    return (cfg, jg, frc, js, jo), (tcfg, tg, tf, ts, to)


def _same_fields(t, j):
    assert sorted(t) == sorted(j)
    for k, v in j.items():
        a, b = t[k].numpy().astype(np.float64), np.asarray(v, np.float64)
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            scale = np.abs(b).max()
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=ATOL_SCALE * scale, err_msg=k)


def test_collect_step_fields_from_run_outputs():
    """``tests/test_diagnostics.py:38``: the RunOutputs' catalog fields,
    the same names and values as the JAX package collects."""
    (cfg, jg, frc, js, jo), (tcfg, tg, tf, ts, to) = _coupled()
    jf = jdg.collect_step_fields(jo)
    tf_ = tdg.collect_step_fields(to)
    assert "floating_melt" in tf_ and "spread_mass" in tf_
    _same_fields(tf_, jf)
    dm = tdg.DiagManager(tg, selected=tuple(tf_))
    ds = dm.send_data(dm.init_state(), tf_)
    assert ds.count == 1


def test_collect_step_fields_with_forcing_and_cells(tmp_path):
    """The driver's call: a step's fields with the forcing copies, the
    depth, the per-cell count and hash (bit for bit on one state) and
    the calving fields, within the tolerance of the JAX package's; the
    full catalog's history file byte for byte for the same fields."""
    (cfg, jg, frc, js, jo), (tcfg, tg, tf, ts, to) = _coupled()
    jff = jdg.collect_forcing_fields(frc, jg)
    tff = tdg.collect_forcing_fields(tf, tg)
    _same_fields(tff, jff)
    jst = js.bergs
    tst = ibp.state_from_numpy(_leaves(jst), device=CPU)
    jf = jdg.collect_step_fields(jo, st=jst, cfg=cfg, grid=jg,
                                 forcing_fields=jff,
                                 extra={"stored_ice": js.calving.stored_ice})
    tfd = tdg.collect_step_fields(to, st=tst, cfg=tcfg, grid=tg,
                                  forcing_fields=tff,
                                  extra={"stored_ice": ts.calving.stored_ice})
    assert "melt_m_per_year" in tfd and "uo" in tfd and "depth" in tfd
    _same_fields(tfd, jf)
    for k in ("bergs_per_cell", "list_chksum"):
        np.testing.assert_array_equal(tfd[k].numpy(), np.asarray(jf[k]))
    jm, tm = jdg.DiagManager(jg), tdg.DiagManager(tg)
    jd, td = jm.init_state(), tm.init_state()
    for _ in range(3):
        jd = jm.send_data(jd, jf)
        td = tm.send_data(td, {k: torch.as_tensor(np.array(v))
                               for k, v in jf.items()})
    jp, tp = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jm.flush(jd, jp, time_value=1.0)
    tm.flush(td, tp, time_value=1.0)
    with netcdf_file(tp, "r", mmap=False) as f:
        assert len(f.variables) == len(tdg.CATALOG) + 1
    assert open(jp, "rb").read() == open(tp, "rb").read()


def test_diag_sums_stay_on_the_device():
    """``send_data`` accumulates tensors and reads nothing: the count is
    a host int and each sum a tensor on the grid's device."""
    jg, tg = _grid()
    tm = tdg.DiagManager(tg)
    ds = tm.init_state()
    ds = tm.send_data(ds, {"melt_by_class": torch.ones(8, 7, 10),
                           "bergs_per_cell": torch.ones(8, 7,
                                                        dtype=torch.int32),
                           "not_a_field": torch.ones(1), "mass": None})
    assert ds.count == 1 and isinstance(ds.count, int)
    assert float(ds.sums["melt_by_class"][0, 0]) == 10.
    assert ds.sums["bergs_per_cell"].dtype == torch.float32
    assert all(v.device == tg.device for v in ds.sums.values())


def test_monitor_a_berg(capsys):
    (cfg, jg, frc, js, jo), (tcfg, tg, tf, ts, to) = _coupled(n_steps=1)
    assert tdg.monitor_a_berg(ts.bergs, 4294967298, label="t") is False
    import icebergs_tpu_torch.ids as tids
    pid = int(tids.ids_of_state(ts.bergs)[0])
    assert tdg.monitor_a_berg(ts.bergs, pid, label="t")
    out = capsys.readouterr().out
    assert f"monitor[t] id={pid} slot=0" in out
    jdg.monitor_a_berg(js.bergs, pid, label="t")
    jout = capsys.readouterr().out
    assert out.split("lon=")[0] == jout.split("lon=")[0]

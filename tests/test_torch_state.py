"""PyTorch port: state, grid, forcing, config and checksum against the JAX
package (bitwise), and the port's independence from jax."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.diag import berg_chksum as jax_chksum
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu.state import pack_id as jax_pack_id

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.diag import berg_chksum
from icebergs_tpu_torch.grid import cell_to_pos
from icebergs_tpu_torch.state import pack_id

torch.set_num_threads(1)
CPU = torch.device("cpu")


def leaves(obj):
    """{field: numpy} of a JAX pytree dataclass (ints stay ints)."""
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


def _bergs(n=40, cap=64, seed=0):
    rng = np.random.RandomState(seed)
    kw = dict(lon=rng.uniform(2e3, 30e3, n), lat=rng.uniform(2e3, 30e3, n),
              uvel=rng.uniform(-.3, .3, n), vvel=rng.uniform(-.3, .3, n),
              mass=rng.uniform(1e8, 1e10, n), thickness=40., width=150.,
              length=rng.uniform(100., 300., n), mass_scaling=2.,
              id_cnt=rng.permutation(n) + 1)
    return (ibt.create_bergs(cap, **kw),
            ibp.create_bergs(cap, device=CPU, **kw))


def assert_same(jax_obj, torch_obj):
    J, T = leaves(jax_obj), ibp.to_numpy(torch_obj)
    for name, t in T.items():
        if name in ("lon0g", "lat0g"):     # the port's tile origin: untiled
            assert t is None, name
            continue
        j = J[name]
        if isinstance(t, int):
            # an untiled grid's tile offsets: the JAX None, the port's 0
            assert t == (0 if j is None else j), name
        else:
            assert t.dtype == j.dtype, name
            np.testing.assert_array_equal(t, j, err_msg=name)


def test_create_bergs_grid_forcing_match_jax():
    js, ts = _bergs()
    assert_same(js, ts)
    assert_same(ibt.make_uniform_grid(20, 12, 0., 0., 2000., 2000.,
                                      grid_is_latlon=False),
                ibp.make_uniform_grid(20, 12, 0., 0., 2000., 2000.,
                                      grid_is_latlon=False, device=CPU))
    assert_same(ibt.swirl_forcing(20, 12, 2000., uo=0.3, ua=5., sst=4.,
                                  sss=33.),
                ibp.swirl_forcing(20, 12, 2000., uo=0.3, ua=5., sst=4.,
                                  sss=33., device=CPU))
    assert_same(ibt.uniform_forcing(5, 7, uo=0.1, sst=2.),
                ibp.uniform_forcing(5, 7, uo=0.1, sst=2., device=CPU))


def test_converters_round_trip():
    js, _ = _bergs()
    grid = ibt.make_uniform_grid(20, 12, 0., 0., 2000., 2000.,
                                 grid_is_latlon=False)
    frc = ibt.swirl_forcing(20, 12, 2000.)
    ts = ibp.state_from_numpy(leaves(js), device=CPU)
    tg = ibp.grid_from_numpy(leaves(grid), device=CPU)
    tf = ibp.forcing_from_numpy(leaves(frc), device=CPU)
    for j, t in ((js, ts), (grid, tg), (frc, tf)):
        assert_same(j, t)
    # and back: to_numpy feeds the *_from_numpy functions unchanged
    assert_same(js, ibp.state_from_numpy(ibp.to_numpy(ts), device=CPU))
    cfg = ibt.IcebergsConfig(dt=600., interactive_icebergs_on=True,
                             fused_fallback_cap=4096)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.resolved_contact_mode() == cfg.resolved_contact_mode()


def test_pos_to_cell_and_pack_id_match_jax():
    js, ts = _bergs(n=64)
    grid = ibt.make_uniform_grid(20, 12, 0., 0., 2000., 2000.,
                                 grid_is_latlon=False)
    tg = ibp.grid_from_numpy(leaves(grid), device=CPU)
    for j, t in zip(jax_pos_to_cell(grid, js.lon, js.lat, -1.),
                    ibp.pos_to_cell(tg, ts.lon, ts.lat, -1.)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    i, j, xi, yj = ibp.pos_to_cell(tg, ts.lon, ts.lat, -1.)
    lon, lat = cell_to_pos(tg, i, j, xi, yj)
    np.testing.assert_allclose(lon.numpy(), ts.lon.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(pack_id(ts.id_cnt, ts.id_ij).numpy(),
                                  np.asarray(jax_pack_id(js.id_cnt,
                                                         js.id_ij)))


@pytest.mark.parametrize("seed", [0, 1])
def test_berg_chksum_matches_jax(seed):
    js, _ = _bergs(seed=seed)
    rng = np.random.RandomState(seed + 10)
    # scramble every hashed field (negative floats, large bit patterns)
    # and kill a few slots so the live mask matters
    d = leaves(js)
    for f in ("axn", "ayn", "bxn", "byn", "start_day", "heat_density",
              "mass_of_bits"):
        d[f] = rng.standard_normal(d[f].shape).astype(np.float32) * 1e3
    d["alive"] = d["alive"] & (rng.uniform(size=d["alive"].shape) > 0.2)
    js = js.replace(**{k: v for k, v in d.items() if k != "alive"},
                    alive=d["alive"])
    total, n = jax_chksum(js)
    ttotal, tn = berg_chksum(ibp.state_from_numpy(d, device=CPU))
    assert int(ttotal) == int(total)
    assert int(tn) == int(n)


def test_port_imports_no_jax():
    code = ("import sys, icebergs_tpu_torch, icebergs_tpu_torch.model, "
            "icebergs_tpu_torch.cuda_build, icebergs_tpu_torch.api, "
            "icebergs_tpu_torch.calving, icebergs_tpu_torch.footloose, "
            "icebergs_tpu_torch.diag, icebergs_tpu_torch.ids, "
            "icebergs_tpu_torch.timeutils\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('icebergs_tpu.') "
            "or m == 'icebergs_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


_CFG = dict(grid_is_latlon=False, Runge_not_Verlet=False,
            interactive_icebergs_on=True)


@pytest.mark.parametrize("kw", [
    dict(mts=True, grid_is_latlon=True), dict(grid_is_latlon=True),
    dict(grid_is_regular=False), dict(hexagonal_icebergs=True)],
    ids=lambda kw: next(iter(kw)))
def test_unported_settings_raise(kw):
    """The settings that once raised are served: lat-lon and curvilinear
    grids (ROADMAP item 11) and hexagonal elements (item 22).
    ``check_ported`` passes and one step (an MTS outer step with ``mts``)
    runs on a lat-lon grid, on the same corners as a curvilinear grid,
    or with hexagons on a Cartesian one, with every live float finite.
    No setting of the JAX package raises any more."""
    cfg = ibp.IcebergsConfig(**_CFG)
    ibp.check_ported(cfg)
    cfg = cfg.replace(**kw)
    ibp.check_ported(cfg)
    cfg = cfg.replace(Lx=360. if cfg.grid_is_latlon else -1.,
                      use_f_plane=not cfg.grid_is_latlon, lat_ref=-60.)
    dlon, dlat = (0.05, 0.025) if cfg.grid_is_latlon else (2000., 2000.)
    grid = ibp.make_uniform_grid(16, 16, 0., -62. if cfg.grid_is_latlon
                                 else 0., dlon, dlat,
                                 grid_is_latlon=cfg.grid_is_latlon,
                                 device=CPU)
    if not cfg.grid_is_regular:
        grid = ibp.make_curvilinear_grid(grid.lonc.double().numpy(),
                                         grid.latc.double().numpy(),
                                         device=CPU)
    rng = np.random.RandomState(0)
    n = 40
    st = ibp.create_bergs(
        64, device=CPU, lon=grid.lonc[0, 0].item() + dlon * rng.uniform(
            2., 14., n),
        lat=grid.latc[0, 0].item() + dlat * rng.uniform(2., 14., n),
        uvel=rng.uniform(-.3, .3, n), vvel=rng.uniform(-.3, .3, n),
        mass=850. * 40. * 150. * 150., thickness=40., width=150.,
        length=150., mass_scaling=1., id_cnt=np.arange(n) + 1)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, cfg.Lx)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    frc = ibp.uniform_forcing(16, 16, uo=0.2, vo=0.1, ua=5., sst=1.,
                              sss=34., device=CPU)
    st2, d = ibp.make_step(grid, cfg)(st, frc)
    assert int(d.nbergs) == n
    live = st2.alive
    for name in ("lon", "lat", "uvel", "vvel", "xi", "yj", "mass"):
        assert bool(torch.isfinite(getattr(st2, name)[live]).all()), name
    assert bool((st2.lon[live] != st.lon[live]).any())


@pytest.mark.parametrize("kw", [
    dict(interp_mode="xla"), dict(interp_mode="kernel"),
    dict(contact_epilogue=True), dict(Runge_not_Verlet=True),
    dict(slot_sum_method="scatter"), dict(slot_sum_method="gather_mm"),
    dict(parallel_reprod=False), dict(sort_packed_permute=False),
    dict(pack_kernel=False), dict(starts_via_scatter=True),
    dict(coastal_drift=0.1, tidal_drift=0.1), dict(contact_mode="sorted"),
    dict(iceberg_bonds_on=True), dict(footloose=True),
    dict(with_calving=True)],
    ids=lambda kw: next(iter(kw)))
def test_ported_settings_accepted(kw):
    """Settings ported by the slices of ROADMAP items 15 and 9:
    ``check_ported`` takes them and the per-step path builds (per-step
    ``interp_mode="kernel"`` reads ``interp_flds``, as the JAX
    ``make_step`` does; ``with_calving`` is a ``make_step`` argument that
    routes ``make_multi_step`` off the persistent lane, as in the JAX
    package); the ``sorted`` mode builds through ``make_multi_step`` too,
    and the coupled entry takes the configuration."""
    kw = dict(kw)
    step_kw = {k: kw.pop(k) for k in list(kw) if k == "with_calving"}
    cfg = ibp.IcebergsConfig(**_CFG).replace(**kw)
    ibp.check_ported(cfg)
    grid = ibp.make_uniform_grid(4, 4, 0., 0., 1., 1., grid_is_latlon=False,
                                 device=CPU)
    ibp.make_multi_step(grid, cfg, 1, persistent=False, **step_kw)
    ibp.make_step(grid, cfg, **step_kw)
    if cfg.contact_mode == "sorted":
        ibp.make_multi_step(grid, cfg, 1, persistent=False,
                            neighbor_mode="sorted")
    ibp.IcebergsModel(grid, cfg, device=CPU)
    for impl in ("gathered", "manual", "pipelined"):
        ibp.check_ported(cfg.replace(extract_impl=impl, spread_impl=impl))
    for mode in ("fused3", "fused", "buckets", "sorted"):
        ibp.check_ported(cfg.replace(contact_mode=mode))

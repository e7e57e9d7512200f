"""The port's native host library (``icebergs_tpu_torch/csrc/kidhost.cpp``,
built by :mod:`icebergs_tpu_torch.native`) against its numpy route and
the JAX package's ``native`` (``tests/test_native_host.py``'s cases):
cell-hashed bond formation and union-find conglomerate labels, the
routes ``initialize_bonds_host`` and ``compute_conglom_ids_host`` take
above 512 elements, and what happens when the library does not build.

Tolerance: none for the bond tables, counts and labels (the same
source, the same float64 arithmetic); the bond lengths of the native
and numpy routes within 1e-12 relative before the float32 rounding
(``sqrt`` of a sum against numpy's ``hypot``), then bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import native as jnative
from icebergs_tpu.ops import forces as jforces

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch import native as tnative
from icebergs_tpu_torch.ops import forces as tforces

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _clustered(n=700, cap=1024, seed=42, **cfg_kw):
    """``tests/test_native_host.py:13``'s clustered population."""
    rng = np.random.RandomState(seed)
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.,
                             iceberg_bonds_on=True, max_bonds=6,
                             manually_initialize_bonds_from_radii=True,
                             **cfg_kw)
    centers = rng.uniform(0., 50e3, (30, 2))
    pts = centers[rng.randint(0, 30, n)] + rng.uniform(-900, 900, (n, 2))
    st = ibt.create_bergs(cap, lon=pts[:, 0], lat=pts[:, 1], mass=8.5e8,
                          thickness=100., width=400., length=400.,
                          mass_scaling=1., id_cnt=np.arange(n) + 1,
                          max_bonds=6)
    return cfg, st


def _broken_library(monkeypatch):
    def fail():
        raise RuntimeError("g++ failed (1) on kidhost.cpp:\nno compiler")
    monkeypatch.setattr(tnative, "library", fail)


@pytest.fixture(scope="module")
def built():
    if not jnative.available():
        pytest.skip("no g++ on this machine")
    return tnative.library()


def test_library_builds_in_the_package(built):
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "icebergs_tpu_torch"


def test_native_bond_init_matches_numpy_and_jax(built, monkeypatch):
    cfg, st = _clustered()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    j = jforces.initialize_bonds_host(st, cfg)          # JAX, native
    t = tforces.initialize_bonds_host(tst, tcfg)        # port, native
    for f in ("bond_idx", "bond_length", "n_bonds", "conglom_id"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.n_bonds.sum()) > 100

    _broken_library(monkeypatch)
    with pytest.warns(UserWarning, match="no compiler"):
        u = tforces.initialize_bonds_host(tst, tcfg)    # numpy, scipy
    np.testing.assert_array_equal(u.bond_idx.numpy(), t.bond_idx.numpy())
    np.testing.assert_array_equal(u.n_bonds.numpy(), t.n_bonds.numpy())
    np.testing.assert_allclose(u.bond_length.numpy(), t.bond_length.numpy(),
                               rtol=1e-12)
    # the same partition of the slots, numbered another way
    la, lb = t.conglom_id.numpy(), u.conglom_id.numpy()
    pairs = {(a, b) for a, b in zip(la, lb)}
    assert len(pairs) == len(set(la)) == len(set(lb))


def test_native_latlon_metric_matches_jax(built):
    """``tests/test_native_host.py:58``: the lat-lon metric scales the
    zonal separation by the cosine of the pair's mean latitude."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=True, Lx=360.,
                             iceberg_bonds_on=True, max_bonds=4,
                             length_for_manually_initialize_bonds=700.)
    n = 600
    rng = np.random.RandomState(1)
    lon = 10. + np.concatenate([[0., 0.01], rng.uniform(5, 8, n - 2)])
    lat = -60. + np.concatenate([[0., 0.], rng.uniform(1, 3, n - 2)])
    st = ibt.create_bergs(1024, lon=lon, lat=lat, mass=8.5e8,
                          thickness=100., width=1000., length=1000.,
                          mass_scaling=1., id_cnt=np.arange(n) + 1,
                          max_bonds=4)
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    t = tforces.initialize_bonds_host(
        tst, ibp.config_from_dict(dataclasses.asdict(cfg)))
    j = jforces.initialize_bonds_host(st, cfg)
    for f in ("bond_idx", "bond_length", "n_bonds", "conglom_id"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.bond_idx[0, 0]) == 1
    expect = (np.pi / 180.) * cfg.Rearth * 0.01 * np.cos(np.radians(-60.))
    np.testing.assert_allclose(float(t.bond_length[0, 0]), expect,
                               rtol=5e-4)


def test_native_holds_what_numpy_cannot(built, monkeypatch):
    """Above ``max_pairwise`` live elements only the native route forms
    bonds; when the library does not build, the port raises naming the
    compiler's error."""
    cfg, st = _clustered(n=3000, cap=4096, seed=3)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    t = tforces.initialize_bonds_host(tst, tcfg, max_pairwise=2048)
    np.testing.assert_array_equal(
        t.bond_idx.numpy(),
        np.asarray(jforces.initialize_bonds_host(st, cfg).bond_idx))
    _broken_library(monkeypatch)
    with pytest.raises(RuntimeError, match="no compiler"):
        tforces.initialize_bonds_host(tst, tcfg, max_pairwise=2048)


@pytest.mark.parametrize("cap", [512, 513, 2048])
def test_conglom_labels_match_jax(built, cap):
    """The labels of the JAX package bit for bit: scipy's connected
    components up to 512 slots, the native union-find (unbonded slots
    numbered after the components) above."""
    cfg, st = _clustered(n=400, cap=cap, seed=9)
    j = jforces.initialize_bonds_host(st, cfg)
    tst = ibp.state_from_numpy(_leaves(j), device=CPU)
    t = tforces.compute_conglom_ids_host(tst.replace(
        conglom_id=torch.zeros_like(tst.conglom_id)))
    np.testing.assert_array_equal(t.conglom_id.numpy(),
                                  np.asarray(j.conglom_id))
    labels = tnative.conglom_label(tst.bond_idx.numpy())
    np.testing.assert_array_equal(labels, jnative.conglom_label(
        np.asarray(j.bond_idx)))


def test_conglom_labels_fall_back_with_a_warning(built, monkeypatch):
    cfg, st = _clustered(n=400, cap=1024, seed=9)
    j = jforces.initialize_bonds_host(st, cfg)
    tst = ibp.state_from_numpy(_leaves(j), device=CPU)
    _broken_library(monkeypatch)
    with pytest.warns(UserWarning, match="conglomerate labels"):
        t = tforces.compute_conglom_ids_host(tst)
    la, lb = t.conglom_id.numpy(), np.asarray(j.conglom_id)
    assert len({(a, b) for a, b in zip(la, lb)}) == len(set(la))

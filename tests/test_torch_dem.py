"""The port's DEM pieces against the JAX package: the host-side bond
setup, the conglomerate-blocked layout and its delta analysis, and the
plain version of K4 (the MTS Part-3 substep loop) against the Pallas
kernel in interpret mode (``tests/test_dem_vmem.py``'s worlds and flag
sets).

Tolerance of the substep loop: integers (``bond_broken``, ``n_bonds``,
``nbroken``) exact; floats within 2e-3 of each field's largest
magnitude.  The JAX package's own bound between its kernel and its scan
path (5e-6, ``test_dem_vmem.py:103-109``) is not reachable across the
two packages: XLA:CPU contracts ``rx*rx + ry*ry`` into a fused
multiply-add, so the reference's bond length is 1 ulp (2.4e-4 m at
3 km) off the separately rounded value on about 10% of the bonds at the
first substep (the port's equals it); the bond stress reads that length
through ``l0 - length`` (a few metres), so the ulp becomes ~1e-4 of the
stress, and the stiff bonds (k = 5e6) grow it over the 12 substeps to
at most 1.2e-4 of scale in the fracturing world (``uvel``) and 1.5e-3 in
the elastic world (``axn_fast``, a net force of nearly cancelling bond
forces).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.ops import dem_vmem as jvmem
from icebergs_tpu.ops import forces as jforces

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import dem_substeps as tdem
from icebergs_tpu_torch.ops import forces as tforces

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 2e-3


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _cfg(**kw):
    base = dict(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=-55.0,
        dt=120.0, Runge_not_Verlet=False, mts=True, mts_sub_steps=12,
        explicit_inner_mts=True, dem=True, dem_spring_coef=5.e6,
        dem_damping_coef=1.0, poisson=0.3, interactive_icebergs_on=True,
        iceberg_bonds_on=True, spring_coef=0.00065359477124183,
        contact_spring_coef=1.e-7, contact_distance=4.e3,
        force_convergence=True, convergence_tolerance=1e-4,
        use_broken_bonds_for_substep_contact=True,
        break_bonds_on_sub_steps=True, fracture_criterion="stress",
        frac_thres_scaling=1., frac_thres_n=18.e3, frac_thres_t=100.e3,
        constant_interaction_LW=True, constant_length=3000.,
        constant_width=3000., manually_initialize_bonds=True,
        manually_initialize_bonds_from_radii=True,
        allow_bergs_to_roll=False, max_bonds=6, hexagonal_icebergs=False)
    base.update(kw)
    return ibt.IcebergsConfig(**base).normalized(warn=False)


def _unbonded(sides, jitter, seed, cap, singles=0):
    """Square 2r-lattice conglomerates of the given side lengths in a row
    on a 64 x 64 grid of 7 km cells, ``singles`` lone bergs between them,
    random velocities and ocean depths (some elements grounded)."""
    r, DXY = 1500.0, 7000.0
    rng = np.random.RandomState(seed)
    lon, lat = [], []
    ox = 2 * DXY
    for side in sides:
        px, py = np.meshgrid(np.arange(side) * 2 * r,
                             np.arange(side) * 2 * r, indexing="ij")
        lon.append(px.ravel() + ox)
        lat.append(py.ravel() + 2 * DXY)
        ox += 2 * r * side + 6 * r
        if singles:
            lon.append(ox - 3 * r + np.zeros(1))
            lat.append(2 * DXY + 10 * r + np.zeros(1))
    n = sum(map(len, lon))
    lon = np.concatenate(lon) + rng.uniform(-jitter, jitter, n)
    lat = np.concatenate(lat) + rng.uniform(-jitter, jitter, n)
    grid = ibt.make_uniform_grid(64, 64, 0., 0., DXY, DXY,
                                 grid_is_latlon=False)
    st = ibt.create_bergs(cap, lon=lon, lat=lat,
                          uvel=rng.uniform(-0.3, 0.3, n),
                          vvel=rng.uniform(-0.3, 0.3, n),
                          mass=850. * 200. * (2 * r) ** 2, thickness=200.,
                          width=2 * r, length=2 * r, mass_scaling=1.0,
                          id_cnt=np.arange(n) + 1, max_bonds=6)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.0)
    od = np.zeros(cap, np.float32)
    od[:n] = rng.uniform(120., 260., n)
    return grid, st.replace(ine=i, jne=j, xi=xi, yj=yj, od=jnp.asarray(od))


@functools.lru_cache(maxsize=None)
def _bonded(sides=(5, 5, 5, 5, 5, 5), jitter=40.0, seed=3, cap=256,
            singles=0):
    """JAX world bonded by the JAX package, with one bond pair broken."""
    cfg = _cfg()
    grid, st = _unbonded(sides, jitter, seed, cap, singles)
    st = jforces.initialize_bonds_host(st, cfg)
    bb = np.asarray(st.bond_broken).copy()
    bi = np.asarray(st.bond_idx)
    p = bi[0, 0]
    bb[0, 0] = 1
    bb[p, bi[p] == 0] = 1
    return grid, jforces.count_bonds(st.replace(bond_broken=jnp.asarray(bb)))


def test_bond_setup_matches_jax():
    """initialize_bonds_host (bond table, lengths, conglomerate labels)
    and count_bonds equal the JAX package's."""
    cfg = _cfg()
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    _, st = _unbonded((5, 4, 6), 40.0, 3, 128, singles=1)
    jst = jforces.count_bonds(jforces.initialize_bonds_host(st, cfg))
    tst = tforces.count_bonds(tforces.initialize_bonds_host(
        ibp.state_from_numpy(_leaves(st), device=CPU), tcfg))
    J, T = _leaves(jst), ibp.to_numpy(tst)
    for name in ("bond_idx", "bond_length", "n_bonds", "conglom_id"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    assert (J["bond_idx"] >= 0).sum() > 0


@pytest.mark.parametrize("block_n", [128, 256])
def test_pack_blocked_matches_jax(block_n):
    """The blocked layout slot for slot, on conglomerates of 16-64
    elements interleaved with lone bergs and dead slots; the delta
    analysis of both packed tables (None here: five lattice widths give
    more than 8 distinct deltas)."""
    _, st = _bonded((5, 8, 6, 4, 7), 10.0, 5, 512, 1)
    alive = np.asarray(st.alive).copy()
    alive[[3, 40, 41]] = False               # dead slots inside runs
    st = st.replace(alive=jnp.asarray(alive))
    jst = jvmem.pack_conglomerates_blocked(st, block_n)
    tst = tdem.pack_conglomerates_blocked(
        ibp.state_from_numpy(_leaves(st), device=CPU), block_n)
    J, T = _leaves(jst), ibp.to_numpy(tst)
    assert T["alive"].shape[0] == J["alive"].shape[0] >= block_n
    for name in T:
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    jd = jvmem.analyze_bond_deltas(jst.bond_idx, block_n)
    assert tdem.analyze_bond_deltas(tst.bond_idx, block_n) == jd
    assert tdem.analyze_bond_deltas(tst.bond_idx, block_n,
                                    max_deltas=64) == \
        jvmem.analyze_bond_deltas(jst.bond_idx, block_n, max_deltas=64)


def test_analyze_rejects_block_crossing():
    """``test_dem_vmem.py:159-168``: a bond across a block boundary has
    no delta set; the same bond inside one block has (-1, 1)."""
    bi = np.full((256, 2), -1, np.int32)
    bi[127, 0], bi[128, 0] = 128, 127
    assert tdem.analyze_bond_deltas(torch.as_tensor(bi), 128) is None
    assert jvmem.analyze_bond_deltas(jnp.asarray(bi), 128) is None
    bi2 = np.full((256, 2), -1, np.int32)
    bi2[10, 0], bi2[11, 0] = 11, 10
    assert tdem.analyze_bond_deltas(torch.as_tensor(bi2), 128) == (-1, 1)
    assert jvmem.analyze_bond_deltas(jnp.asarray(bi2), 128) == (-1, 1)


_CHECK = ("lon", "lat", "lon_old", "lat_old", "uvel", "vvel", "uvel_old",
          "vvel_old", "axn_fast", "ayn_fast", "bxn_fast", "byn_fast",
          "ang_vel", "ang_accel", "rot", "bond_length", "bond_tangd1",
          "bond_tangd2", "bond_rel_rotation", "bond_nstress",
          "bond_sstress")


@pytest.mark.parametrize("jitter,flags", [
    # heavy jitter: most bonds fracture -> broken-bond contact is live
    (40.0, {}),
    # gentle: elastic regime, short-step grounding + torque on
    (2.0, {"short_step_mts_grounding": True, "use_grounding_torque": True,
           "frac_thres_n": 1.8e5}),
])
def test_part3_plain_matches_jax(jitter, flags):
    """K4's plain version against ``part3_substeps_vmem(interpret=True)``
    on two 128-slot blocks of six 5x5 conglomerates."""
    cfg = _cfg(**flags)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    _, st = _bonded(jitter=jitter)
    block_n = 128
    st = jvmem.pack_conglomerates_blocked(st, block_n)
    st = st.replace(axn_fast=st.uvel * 1e-3, ayn_fast=st.vvel * -1e-3,
                    ang_vel=st.uvel * 1e-5)
    deltas = jvmem.analyze_bond_deltas(st.bond_idx, block_n)
    assert st.capacity == 2 * block_n and deltas
    jst, jnb = jax.jit(lambda s: jvmem.part3_substeps_vmem(
        s, cfg, deltas, block_n=block_n, interpret=True))(st)
    tst, tnb = tdem.part3_substeps_vmem(
        ibp.state_from_numpy(_leaves(st), device=CPU), tcfg, deltas,
        block_n=block_n)
    J, T = _leaves(jst), ibp.to_numpy(tst)
    assert int(tnb) == int(jnb)
    if not flags:
        assert int(jnb) > 10
    for name in ("bond_broken", "n_bonds", "alive", "bond_idx"):
        np.testing.assert_array_equal(T[name], J[name], err_msg=name)
    for name in _CHECK:
        a, b = T[name].astype(np.float64), J[name].astype(np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= TOL * scale, (name, np.abs(a - b).max()
                                                     / scale)

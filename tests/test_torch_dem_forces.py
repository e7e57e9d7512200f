"""The port's DEM force functions (``icebergs_tpu_torch/ops/dem.py``)
against the JAX package's (``icebergs_tpu/ops/dem.py``): the bond
partner tables, the bond forces with their bookkeeping and in-kernel
fracture, the same-conglomerate contact over candidate tables, the bond
table and a compacted pair list, the ordered pair-list reduction, the
outer-step fracture and the grounding drag.

The world: three bonded 6x6 conglomerates of 3 km elements in 128 slots
(two 2 km apart, the third 3.5 km above them), the iKID flag set
of ``tools/bench_dem_1m.py`` at dt 120 s, with moved old positions,
random velocities, rotations and tangential displacements, and a third
of the bonds broken, so that every term engages.

The JAX functions run op by op (``jax.disable_jit``): under ``jax.jit``
XLA:CPU contracts multiply-adds (``rx*rx + ry*ry``, the projections), a
known reference-side difference (ROADMAP.md Queue 3) that would hide
everything else.  Op by op, the partner tables, the contact sums, the
pair-list reduction, the fracture flags and the grounding drag are bit
for bit the port's.  The bond forces are not quite: torch's float32
``sqrt`` on the CPU (the AVX-512 build) rounds a near-halfway square
root 1 ulp low (``sqrt(9543050)`` gives 3089.1826, XLA and numpy the
correctly rounded 3089.1829), which hits 2 of the 768 bond lengths
here; the bond stress reads the length through ``l0 - length`` (~1e-6 of
its scale) and the force sums of those rows follow, so the bond forces
are held within ``rtol 1e-6`` plus ``2e-6`` of each field's largest
magnitude.  Integers and counts are exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu import mts as jmts
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.ops import dem as jdem
from icebergs_tpu.ops import dem_vmem as jvmem
from icebergs_tpu.ops import forces as jforces

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import dem as tdem
from icebergs_tpu_torch.ops import forces as tforces

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX, DXY, R, SIDE = 24, 7000.0, 1500.0, 6
RTOL, ATOL_SCALE = 1e-6, 2e-6

_BASE = dict(
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
    allow_bergs_to_roll=False, max_bonds=6, hexagonal_icebergs=False,
    fused_fallback_cap=128)


def leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None
                     else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def jax_cfg(**kw):
    return ibt.IcebergsConfig(**{**_BASE, **kw}).normalized(warn=False)


def port_cfg(cfg):
    return ibp.config_from_dict(dataclasses.asdict(cfg))


def tstate(js):
    return ibp.state_from_numpy(leaves(js), device=CPU)


def close(t, j, name="", rtol=RTOL, atol_scale=ATOL_SCALE):
    t = np.asarray(t.numpy() if torch.is_tensor(t) else t, np.float64)
    j = np.asarray(j, np.float64)
    scale = max(float(np.abs(j).max()), 1e-30) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_scale * scale,
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def world(jitter=40.0, seed=3, cap=128):
    """(grid, forcing, state) of the JAX package: three 6x6
    conglomerates, each bonded as one prototype by
    ``initialize_bonds_host`` (as ``tools/bench_dem_1m.py`` bonds its
    world), one bond pair broken, random velocities and ocean depths
    (some elements grounded), in the conglomerate-blocked layout of
    128-slot blocks."""
    cfg = jax_cfg()
    px, py = np.meshgrid(np.arange(SIDE) * 2 * R, np.arange(SIDE) * 2 * R,
                         indexing="ij")
    px, py = px.ravel(), py.ravel()
    per = px.size
    proto = jforces.initialize_bonds_host(ibt.create_bergs(
        64, lon=px, lat=py, mass=1., thickness=200., width=2 * R,
        length=2 * R, mass_scaling=1., max_bonds=6), cfg)
    pbond = np.asarray(proto.bond_idx)[:per]
    pblen = np.asarray(proto.bond_length)[:per]
    ext = 2 * R * (SIDE - 1)
    x0 = 2 * DXY
    origins = [(x0, x0), (x0 + ext + 2e3, x0),
               (x0 + ext + 2e3, x0 + ext + 3.5e3)]
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
                          mass=850. * 200. * (2 * R) ** 2, thickness=200.,
                          width=2 * R, length=2 * R, mass_scaling=1.0,
                          id_cnt=np.arange(n) + 1, max_bonds=6)
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


@functools.lru_cache(maxsize=None)
def moved_state(cap=128):
    """The world's state mid-substep: old positions moved up to 400 m,
    random old velocities, spins, rotations, tangential displacements
    and bond rotations, a third of the bonds broken (both directions)."""
    _, _, st = world()
    if cap != st.capacity:
        st = jax.tree.map(lambda a: jnp.concatenate(
            [a, jnp.zeros((cap - st.capacity,) + a.shape[1:], a.dtype)]),
            st)
        st = st.replace(bond_idx=st.bond_idx.at[128:].set(-1))
    N, B = st.capacity, st.max_bonds
    rng = np.random.RandomState(11)

    def r(a, shape=(N,)):
        return jnp.asarray(rng.uniform(-a, a, shape).astype(np.float32))

    bi = np.asarray(st.bond_idx)
    bb = np.asarray(st.bond_broken).copy()
    for a, k in zip(*np.nonzero((bi >= 0) & (rng.uniform(size=bi.shape)
                                             < 0.17))):
        b = bi[a, k]
        bb[a, k] = 1
        bb[b, bi[b] == a] = 1
    return jforces.count_bonds(st.replace(
        lon_old=st.lon + r(400.), lat_old=st.lat + r(400.),
        uvel_old=r(0.3), vvel_old=r(0.3), ang_vel=r(1e-4), rot=r(0.05),
        bond_tangd1=r(1., (N, B)), bond_tangd2=r(1., (N, B)),
        bond_rel_rotation=r(1e-3, (N, B)),
        bond_broken=jnp.asarray(bb)))


def eager(fn, *a, **kw):
    with jax.disable_jit():
        return fn(*a, **kw)


@pytest.mark.parametrize("cap", [128, 8192])
def test_partner_tables_match_jax(cap):
    """The static and kinematic partner tables bit for bit on every bond
    slot: against the one-hot matmul the JAX package takes up to 4096
    slots (capacity 128) and against its row gather (capacity 8192)."""
    st = moved_state(cap)
    onehot = jdem.make_bond_onehot(st) if cap <= 4096 else None
    jp = eager(jdem.bond_partner_fields, st, onehot=onehot,
               static=eager(jdem.bond_partner_static, st, onehot=onehot))
    tp = tdem.bond_partner_fields(tstate(st))
    has = np.asarray(st.bond_idx) >= 0
    assert has.sum() == 360
    assert set(tp) == set(jp)
    for name in jp:
        np.testing.assert_array_equal(tp[name].numpy()[has],
                                      np.asarray(jp[name])[has],
                                      err_msg=name)


@pytest.mark.parametrize("flags", [
    {}, {"break_bonds_on_sub_steps": False, "fracture_criterion": "none"},
    {"constant_interaction_LW": False, "orig_dem_moment_of_inertia": True},
    {"ignore_tangential_force": True, "frac_thres_n": 1.8e5}],
    ids=["sub_fracture", "no_fracture", "own_LW_orig_moi", "no_tangential"])
def test_bond_forces_match_jax(flags):
    """``dem_bond_forces`` on the shared partner table: the six force and
    torque sums and the per-bond bookkeeping within the stated
    tolerance, the per-substep fracture flags exact."""
    cfg = jax_cfg(**flags)
    st = moved_state()
    jo = eager(jdem.dem_bond_forces, st, cfg, 10.0)
    to = tdem.dem_bond_forces(tstate(st), port_cfg(cfg), 10.0)
    for name in ("F_x", "F_y", "T", "Fd_x", "Fd_y", "T_d", "bond_length",
                 "tangd1", "tangd2", "rel_rotation", "nstress", "sstress"):
        close(getattr(to, name), getattr(jo, name), name)
    if jo.broken is None:
        assert to.broken is None
    else:
        newly = np.asarray(jo.broken) != np.asarray(st.bond_broken)
        assert newly.sum() > 0
        np.testing.assert_array_equal(to.broken.numpy(),
                                      np.asarray(jo.broken))
    assert np.abs(np.asarray(jo.F_x)).max() > 0


def _nbr(st, cfg, grid):
    return eager(jforces.build_neighbor_tables, st, grid, cfg,
                 max_per_cell=16, ncells_radius=2)


def _tnbr(nbr):
    return tforces.NeighborTables(*(torch.as_tensor(np.array(x))
                                    for x in nbr))


@pytest.mark.parametrize("own_lw", [False, True])
def test_contact_forces_match_jax(own_lw):
    """``dem_contact_forces`` over the (N, 400) same-conglomerate
    candidate table with the substep contact mask, and over the bond
    table with the bond forces' partner fields (the broken-bond contact):
    bit for bit; with ``constant_interaction_LW`` and without."""
    cfg = jax_cfg(constant_interaction_LW=not own_lw)
    tcfg = port_cfg(cfg)
    grid, _, _ = world()
    st = moved_state()
    ts = tstate(st)
    nbr = _nbr(st, cfg, grid)
    m = eager(jmts._contact_masks, st, nbr, cfg)
    assert nbr.cand_idx.shape[1] == 400
    jc = eager(jdem.dem_contact_forces, st, cfg, nbr.cand_idx, m)
    tc = tdem.dem_contact_forces(ts, tcfg, torch.as_tensor(
        np.asarray(nbr.cand_idx)), torch.as_tensor(np.array(m)))
    bo = jnp.maximum(st.bond_idx, 0)
    bm = (st.bond_idx >= 0) & (st.bond_broken == 1) & st.alive[:, None] \
        & st.alive[bo]
    jb = eager(jdem.dem_contact_forces, st, cfg, bo, bm,
               part=eager(jdem.bond_partner_fields, st))
    tb = tdem.dem_contact_forces(
        ts, tcfg, ts.bond_idx.clamp(min=0), torch.as_tensor(np.array(bm)),
        part=tdem.bond_partner_fields(ts))
    for k, (t, j) in enumerate(list(zip(tc, jc)) + list(zip(tb, jb))):
        assert np.abs(np.asarray(j)).max() > 0, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=str(k))


def test_contact_forces_row_blocks_bitwise(monkeypatch):
    """The dense ``dem_contact_forces`` gathered in blocks of 5 rows (the
    last one short) gives the bits of one block."""
    cfg = jax_cfg(use_broken_bonds_for_substep_contact=False)
    tcfg = port_cfg(cfg)
    grid, _, _ = world()
    st = moved_state()
    ts = tstate(st)
    nbr = _nbr(st, cfg, grid)
    m = torch.as_tensor(np.array(eager(jmts._contact_masks, st, nbr, cfg)))
    idx = torch.as_tensor(np.asarray(nbr.cand_idx))
    one = tdem.dem_contact_forces(ts, tcfg, idx, m)
    monkeypatch.setattr(tdem, "_DENSE_BLOCK", 5 * idx.shape[1])
    blocks = tdem.dem_contact_forces(ts, tcfg, idx, m)
    assert ts.capacity % 5
    for k, (a, b) in enumerate(zip(blocks, one)):
        assert a.shape == b.shape and b.abs().max() > 0, k
        assert torch.equal(a, b), k


def test_segment_sum_matches_jax_scatter():
    """The ordered pair-list reduction bit for bit against the JAX
    package's ``.at[me].add(..., indices_are_sorted=True)`` (XLA:CPU adds
    in index order), on sums whose order shows: 5,000 pairs of mixed
    magnitudes into 300 rows, runs of 0-40 pairs, a masked tail."""
    rng = np.random.RandomState(2)
    me = np.sort(rng.randint(0, 300, 5000)).astype(np.int32)
    vals = (rng.standard_normal((5000, 4))
            * 10. ** rng.uniform(-6, 6, (5000, 1))).astype(np.float32)
    valid = np.arange(5000) < 4700
    vals[~valid] = 0.
    me[~valid] = me[0]                 # the pair list's padded tail
    j = jnp.zeros((300, 4), jnp.float32).at[jnp.asarray(me)].add(
        jnp.asarray(vals), mode="drop", indices_are_sorted=True)
    key = torch.where(torch.as_tensor(valid), torch.as_tensor(me), 300)
    t = tdem.segment_sum_sorted(torch.as_tensor(vals), key, 300)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the order shows: the exactly rounded sums differ from it
    exact = np.zeros((300, 4))
    np.add.at(exact, me[valid], vals[valid].astype(np.float64))
    assert (exact.astype(np.float32) != np.asarray(j)).any()


@pytest.mark.parametrize("skin", [4.0, 0.0])
def test_contact_forces_pairs_match_jax(skin):
    """``dem_contact_forces_pairs`` on the JAX package's frozen pair list
    (``compact_conglom_pairs``) with its per-substep mask: bit for bit,
    and equal to the dense form's sums."""
    cfg = jax_cfg(use_broken_bonds_for_substep_contact=False,
                  break_bonds_on_sub_steps=False, fracture_criterion="none",
                  mts_pair_skin=skin)
    tcfg = port_cfg(cfg)
    grid, _, _ = world()
    st = moved_state()
    ts = tstate(st)
    nbr = _nbr(st, cfg, grid)
    me, ot, pv, ov, _ = eager(jmts.compact_conglom_pairs, st, nbr, 16384,
                              cfg=cfg, dt=cfg.dt)
    assert int(ov) == 0
    pm = eager(jmts._pair_contact_masks, st, me, ot, pv, cfg)
    jc = eager(jdem.dem_contact_forces_pairs, st, cfg, me, ot, pm)
    T = [torch.as_tensor(np.array(x)) for x in (me, ot, pm, pv)]
    tc = tdem.dem_contact_forces_pairs(ts, tcfg, T[0], T[1], T[2],
                                       valid=T[3])
    dense = tdem.dem_contact_forces(
        ts, tcfg, torch.as_tensor(np.array(nbr.cand_idx)),
        torch.as_tensor(np.array(eager(jmts._contact_masks, st, nbr,
                                         cfg))))
    for k, (t, j, d) in enumerate(zip(tc, jc, dense)):
        assert np.abs(np.asarray(j)).max() > 0, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=str(k))
        close(t, d.numpy(), str(k), 1e-6, 1e-7)


@pytest.mark.parametrize("criterion,tn,tt", [
    ("stress", 1.8e4, 1.e5), ("stress", 0., 2.e3), ("stress", 0., 0.),
    ("none", 1.8e4, 1.e5)])
def test_break_bonds_matches_jax(criterion, tn, tt):
    """The outer-step fracture on the bond forces' stresses: flags,
    ``n_bonds`` and the count exact, for each threshold branch."""
    cfg = jax_cfg(fracture_criterion=criterion, frac_thres_n=tn,
                  frac_thres_t=tt, break_bonds_on_sub_steps=False)
    st = moved_state()
    jo = eager(jdem.dem_bond_forces, st, cfg, 10.0)
    st = st.replace(bond_nstress=jo.nstress, bond_sstress=jo.sstress)
    js, jn = eager(jdem.break_bonds_dem, st, cfg)
    ts, tn_ = tdem.break_bonds_dem(tstate(st), port_cfg(cfg))
    assert int(tn_) == int(jn)
    if criterion == "stress" and (tn > 0 or tt > 0):
        assert int(jn) > 0
    for name in ("bond_broken", "n_bonds"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))


@pytest.mark.parametrize("form", ["rect", "disk"])
@pytest.mark.parametrize("flags", [{}, {"constant_interaction_LW": False},
                                   {"h_to_init_grounding": 20.}])
def test_grounding_drag_matches_jax(form, flags):
    """``grounding_drag_coeff`` (the port's one function for the substep
    kernel and the scan) against ``mts._grounding_drag_coeff``, bit for
    bit, with some elements grounded."""
    cfg = jax_cfg(**flags)
    st = moved_state()
    j = eager(jmts._grounding_drag_coeff, st, cfg, form)
    ts = tstate(st)
    t = tdem.grounding_drag_coeff(port_cfg(cfg), ts.thickness, ts.od,
                                  ts.mass, ts.length, ts.width, form)
    assert (np.asarray(j) != 0).sum() > 0
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))

"""The worlds of the JAX package's tiled tests (``tests/test_parallel.py``,
``test_parallel_2d.py``, ``test_sharded_run.py``) built through the port,
and the tiled runs of the port's tests of its multi-device layer.

Imports no jax: the ``gloo`` ranks of ``tests/test_torch_multiprocess.py``
build their worlds from here.  Each world is its numpy inputs (berg
positions, config keywords, forcing keywords), so that a test can build
the JAX package's twin from the same numbers.
"""

import dataclasses

import numpy as np
import torch

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.parallel import domain as dd

CPU = torch.device("cpu")
NX, NY, DXY = 32, 8, 5000.0            # test_parallel.py, test_sharded_run.py
NX2 = NY2 = 16                         # test_parallel_2d.py
DXY2 = 4000.0
BASE = dict(grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=30.0,
            halo=2)
DRIFT = dict(BASE, dt=600.0, Runge_not_Verlet=True)
INTERACTIVE = dict(BASE, dt=60.0, Runge_not_Verlet=False,
                   interactive_icebergs_on=True)
CALVING = dict(DRIFT, dt=3600.0, initial_mass=(8.8e7,) * 10,
               mass_scaling=(1.,) * 10, distribution=(1.,) + (0.,) * 9,
               initial_mass_n=(8.8e7,) * 10, mass_scaling_n=(1.,) * 10,
               distribution_n=(1.,) + (0.,) * 9)
FOOTLOOSE = dict(BASE, lat_ref=0., dt=1800.0, Runge_not_Verlet=False,
                 use_new_predictive_corrective=True, footloose=True,
                 fl_style="new_bergs", fl_youngs=1.e8, fl_strength=250.,
                 allow_bergs_to_roll=False, displace_fl_bergs=True)
# the fused3 contact path of the JAX tests (make_step's and the run's
# keywords)
FUSED3_STEP = dict(neighbor_mode="fused3", fused_window=512,
                   fused_fallback_strip_width=140)
FUSED3_RUN = dict(neighbor_mode="fused3",
                  fused_kw=dict(window=512, fallback_strip_width=140))
BERG = dict(mass=1e8, thickness=20., width=50., length=60.,
            mass_scaling=1.0)


def drift_positions(n):
    """test_parallel.py's bergs_global: n bergs from RandomState(0)."""
    rng = np.random.RandomState(0)
    return (rng.uniform(3 * DXY, (NX - 3) * DXY, n),
            rng.uniform(2 * DXY, (NY - 2) * DXY, n))


def pair_positions(cluster: int = 4):
    """Colliding pairs straddling the 4-tile boundaries (x = 8, 16, 24
    cells) and an interior cluster of 3 or 4 (the exact fallback group)."""
    lon, lat = [], []
    for k, x in enumerate((8 * DXY, 16 * DXY, 24 * DXY)):
        lon += [x - 10.0, x + 30.0]
        lat += [4 * DXY + 120.0 * k] * 2
    lon += [5 * DXY, 5 * DXY + 35.0, 5 * DXY + 17.0, 5 * DXY + 17.0]
    lat += [3 * DXY, 3 * DXY, 3 * DXY + 30.0, 3 * DXY - 30.0]
    return np.array(lon[:6 + cluster]), np.array(lat[:6 + cluster])


def diagonal_positions():
    """test_parallel_2d.py's 6 diagonal drifters (RandomState(2))."""
    rng = np.random.RandomState(2)
    return (rng.uniform(2 * DXY2, 7 * DXY2, 6),
            rng.uniform(2 * DXY2, 7 * DXY2, 6))


def pair_positions_2d():
    """Pairs straddling x = 8 and y = 8 cells and a triple cluster."""
    return (np.array([8 * DXY2 - 10., 8 * DXY2 + 30., 3 * DXY2, 3 * DXY2,
                      5 * DXY2, 5 * DXY2 + 35., 5 * DXY2 + 17.]),
            np.array([4 * DXY2, 4 * DXY2, 8 * DXY2 - 10., 8 * DXY2 + 30.,
                      3 * DXY2, 3 * DXY2, 3 * DXY2 + 30.]))


def swirl_positions():
    """The colliding pairs and 40 drifters from RandomState(4) in the
    swirl."""
    rng = np.random.RandomState(4)
    lon, lat = pair_positions()
    return (np.concatenate([lon, rng.uniform(2 * DXY, (NX - 2) * DXY, 40)]),
            np.concatenate([lat, rng.uniform(2 * DXY, (NY - 2) * DXY, 40)]))


def world(cfg_kw, frc_kw, nx=NX, ny=NY, dxy=DXY):
    """``(cfg, grid, forcing)`` of the port on the CPU: uniform forcing,
    or the benchmark's swirl with ``frc_kw["swirl"]``."""
    cfg = ibp.IcebergsConfig(**cfg_kw)
    grid = ibp.make_uniform_grid(nx, ny, 0., 0., dxy, dxy,
                                 grid_is_latlon=False, device=CPU)
    kw = dict(frc_kw)
    if kw.pop("swirl", False):
        return cfg, grid, ibp.swirl_forcing(nx, ny, dxy, device=CPU, **kw)
    return cfg, grid, ibp.uniform_forcing(nx, ny, device=CPU, **kw)


def bergs(grid, lon, lat, capacity=64, **kw):
    """Bergs at (lon, lat) with their cells located."""
    st = ibp.create_bergs(capacity, lon=lon, lat=lat, device=CPU,
                          **{**BERG, **kw})
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    return st.replace(ine=i, jne=j, xi=xi, yj=yj)


def tiled_world(cfg, layout, nx, ny, dxy, device=CPU, **kw):
    ring = dd.Ring(layout)
    if len(ring.layout) == 2:
        return dd.make_sharded_world_2d(cfg, ring, nx=nx, ny=ny, lon0=0.,
                                        lat0=0., dlon=dxy, dlat=dxy,
                                        device=device, **kw)
    return dd.make_sharded_world(cfg, ring, nx=nx, ny=ny, lon0=0., lat0=0.,
                                 dlon=dxy, dlat=dxy, device=device, **kw)


def shard(w, frc, st, cap):
    """The local tiles' forcing and states."""
    if isinstance(w, dd.ShardedWorld2D):
        return dd.shard_forcing_2d(w, frc), dd.shard_state_2d(w, st, cap)
    return dd.shard_forcing(w, frc), dd.shard_state(w, st, cap)


def tiled_steps(cfg, frc, st, layout, nsteps, *, nx=NX, ny=NY, dxy=DXY,
                cap=32, halo_fill=True, **step_kw):
    """``nsteps`` of the tiled step after a halo fill: ``(tiles, nbergs,
    total_mass, overflow of the fill and of every step)``."""
    w = tiled_world(cfg, layout, nx, ny, dxy)
    fs, ts = shard(w, frc, st, cap)
    ovs = []
    if halo_fill:
        ts, ov = dd.make_halo_fill(w)(ts)
        ovs.append(ov)
    step = dd.make_sharded_step(w, **step_kw)
    nb = tm = None
    for _ in range(nsteps):
        ts, nb, tm, ov = step(ts, fs)
        ovs.append(ov)
    return ts, nb, tm, ovs


def untiled_steps(cfg, grid, frc, st, nsteps, **step_kw):
    step = ibp.make_step(grid, cfg, **step_kw)
    for _ in range(nsteps):
        st, _ = step(st, frc)
    return st


def calving_field(nx=NX, ny=NY):
    """test_sharded_run.py's constant calving into cells (3, 4) and
    (22, 5): one class-1 bucket every ~5 steps."""
    calving = np.zeros((nx + 2, ny + 2), np.float32)
    rate = 8.8e7 / (5 * 3600.0)
    calving[3, 4] = rate
    calving[22, 5] = rate
    return calving


def tiled_run(cfg, frc, st, layout, nsteps, *, calving=None, nx=NX, ny=NY,
              dxy=DXY, cap=48, seed=3, halo_fill=False, **run_kw):
    """``nsteps`` of the tiled run: ``(states, outputs of every step,
    overflow of every step)``."""
    w = tiled_world(cfg, layout, nx, ny, dxy)
    fs, ts = shard(w, frc, st, cap)
    if halo_fill:
        ts, _ = dd.make_halo_fill(w)(ts)
    ms = dd.init_sharded_model_state(w, ts, seed=seed)
    zero = np.zeros((nx + 2, ny + 2), np.float32)
    cs = dd.shard_calving_field(w, zero if calving is None else calving)
    hs = dd.shard_calving_field(w, zero)
    run = dd.make_sharded_run(w, **run_kw)
    outs, ovs = [], []
    for _ in range(nsteps):
        ms, out, _, ov = run(ms, fs, cs, hs)
        outs.append(out)
        ovs.append(ov)
    return ms, outs, ovs


def untiled_run(cfg, grid, frc, st, nsteps, *, calving=None, seed=3,
                **model_kw):
    model = ibp.IcebergsModel(grid, cfg, device=CPU, **model_kw)
    s = model.init_state(st, seed=seed)
    calv = None if calving is None else torch.as_tensor(calving)
    outs = []
    for _ in range(nsteps):
        s, out = model.run(s, frc, calv)
        outs.append(out)
    return s, outs


# the tile-local cell indices (a tile's are the global ones less its
# offsets)
FRAME = ("ine", "jne")


def owned_by_id(st):
    """``{field: array}`` of the owned live bergs in (id_cnt, id_ij)
    order (a BergState, or a list of tiles), but the FRAME fields."""
    if isinstance(st, (list, tuple)):
        st = dd.concat_tiles(st)
    d = ibp.to_numpy(st)
    own = d["alive"] & (d["halo_berg"] < 0.5)
    order = np.lexsort((d["id_ij"][own], d["id_cnt"][own]))
    return {k: v[own][order] for k, v in d.items()
            if isinstance(v, np.ndarray) and k not in FRAME}


def assert_bitwise(got: dict, want: dict, fields=None):
    """Every field (or ``fields``) equal bit for bit."""
    for f in fields or want:
        g, w = got[f], want[f]
        assert g.shape == w.shape, (f, g.shape, w.shape)
        if g.dtype.kind == "f":
            g, w = g.view(np.int32 if g.itemsize == 4 else np.int64), \
                w.view(np.int32 if w.itemsize == 4 else np.int64)
        assert np.array_equal(g, w), f


def tile_fields(tiles):
    """Every tile's ``{field: array}``."""
    return [{f.name: getattr(t, f.name).numpy()
             for f in dataclasses.fields(t)} for t in tiles]


def coupled_world(n=12000, nx=32, seed=0):
    """``chip_smoke.py``'s phase-10a world at ``n`` bergs on nx x nx cells
    of 2 km: the headline flags (contacts, swirl) with footloose
    (``new_bergs``), 2e7 kg/s into each cell of the outermost interior
    ring, the buckets primed at random fractions of their thresholds,
    every 50th berg a tabular berg with its foot primed and every 997th
    holding footloose bits past the promotion.  Returns ``(cfg, grid,
    forcing, state, calving flux, primed stored ice)`` on the CPU."""
    from icebergs_tpu_torch.calving import class_grids
    dxy = 2000.0
    cfg = ibp.IcebergsConfig(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=45.0,
        dt=600.0, Runge_not_Verlet=False, interactive_icebergs_on=True,
        use_new_predictive_corrective=True, allow_bergs_to_roll=False,
        fused_fallback_cap=16384, footloose=True, fl_style="new_bergs",
        fl_youngs=1.e8, fl_strength=250.)
    grid = ibp.make_uniform_grid(nx, nx, 0., 0., dxy, dxy,
                                 grid_is_latlon=False, device=CPU)
    frc = ibp.swirl_forcing(nx, nx, dxy, uo=0.3, ua=5.0, sst=4.0, sss=33.0,
                            device=CPU)
    rng = np.random.RandomState(seed)
    lon = rng.uniform(2 * dxy, (nx - 2) * dxy, n)
    lat = rng.uniform(2 * dxy, (nx - 2) * dxy, n)
    k = np.arange(n)
    tab, prom = k % 50 == 0, k % 997 == 1
    st = bergs(grid, lon, lat, capacity=2 * n,
               mass=np.where(tab, 850. * 100. * 400. * 600.,
                             850. * 40. * 150. * 150.),
               thickness=np.where(tab, 100., 40.),
               width=np.where(tab, 400., 150.),
               length=np.where(tab, 600., 150.),
               fl_k=np.where(tab, 1e5, 0.),
               mass_of_fl_bits=np.where(prom, 1.2e12, 0.))
    coast = torch.zeros(nx + 2, nx + 2, dtype=torch.bool)
    coast[1:-1, 1:-1] = True
    coast[2:-2, 2:-2] = False
    calving = torch.where(coast, 2e7, 0.).to(torch.float32)
    tb = class_grids(grid, cfg)
    u = torch.as_tensor(rng.uniform(size=tuple(tb["mass"].shape)),
                        dtype=torch.float32)
    stored = torch.where(coast[:, :, None], tb["mass"] * tb["scal"] * u, 0.)
    return cfg, grid, frc, st, calving, stored


# --------------------------------------------------------------------------
# bonds, MTS and the fold across tiles: the worlds of
# tests/test_parallel_bonds.py and tests/test_parallel_fold.py
# --------------------------------------------------------------------------

BNX, BNY, BDXY = 16, 8, 1000.0         # test_parallel_bonds.py
BONDED = dict(grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=0.,
              dt=60.0, Runge_not_Verlet=False, interactive_icebergs_on=True,
              iceberg_bonds_on=True, spring_coef=1.e-5,
              use_new_predictive_corrective=True, halo=2, max_bonds=4)
BOND_BERG = dict(mass=850. * 100 * 200 * 200, thickness=100., width=200.,
                 length=200., mass_scaling=1.)
# the iKID / A68 parameter set of the MTS ghost-sync tests
MTS_R, MTS_DXY = 1500.0, 7000.0
MTS_STABLE = dict(
    grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=-55.0,
    dt=120.0, Runge_not_Verlet=False, mts=True, mts_sub_steps=12,
    explicit_inner_mts=True, dem=True, dem_spring_coef=5.e6,
    dem_damping_coef=1.0, poisson=0.3, interactive_icebergs_on=True,
    iceberg_bonds_on=True, spring_coef=0.00065359477124183,
    contact_spring_coef=1.e-7, contact_distance=4.e3,
    use_broken_bonds_for_substep_contact=True,
    break_bonds_on_sub_steps=True, fracture_criterion="stress",
    frac_thres_scaling=1., frac_thres_n=18.e3, frac_thres_t=100.e3,
    constant_interaction_LW=True, constant_length=2 * MTS_R,
    constant_width=2 * MTS_R, manually_initialize_bonds=True,
    manually_initialize_bonds_from_radii=True,
    allow_bergs_to_roll=False, max_bonds=6,
    set_melt_rates_to_zero=True, halo=2)
MTS_FORCING = dict(uo=0.25, vo=0.05, ua=5.0, sst=-2.)
FNX = FNY = 16                         # test_parallel_fold.py
FDXY = 4000.0
FOLD = dict(grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=0.0,
            dt=600.0, Runge_not_Verlet=True, halo=2)
FOLD_BERG = dict(mass=1e8, thickness=20., width=50., length=60.,
                 mass_scaling=1.0)


def mts_config(**kw):
    return ibp.IcebergsConfig(**{**MTS_STABLE, **kw}).normalized(warn=False)


def bonded_bergs(grid, lon, lat, capacity=32, bond_length=None, **kw):
    """Bergs at (lon, lat), ids 1.. / 10.., bonded where closer than
    ``bond_length`` (``initialize_bonds_host``) and labelled."""
    from icebergs_tpu_torch.ops import forces
    n = len(lon)
    st = bergs(grid, lon, lat, capacity=capacity,
               **{**BOND_BERG, "id_cnt": np.arange(n) + 1,
                  "id_ij": np.arange(n) + 10, "max_bonds": 4, **kw})
    cfg = ibp.IcebergsConfig(**BONDED)
    st = forces.initialize_bonds_host(st, cfg.replace(
        length_for_manually_initialize_bonds=bond_length))
    return forces.compute_conglom_ids_host(st)


def mts_chain(grid, cfg, x0, y0, ux=1.0, uy=0.0, n=6, capacity=32):
    """test_parallel_bonds.py's ``mts_chain_state``: n elements along (ux,
    uy) centred on (x0, y0), velocities from RandomState(5), bonded and
    labelled."""
    from icebergs_tpu_torch.ops import forces
    t = (np.arange(n) - (n - 1) / 2.) * 2 * MTS_R
    rng = np.random.RandomState(5)
    st = bergs(grid, x0 + t * ux, y0 + t * uy, capacity=capacity,
               uvel=rng.uniform(-0.1, 0.1, n), vvel=rng.uniform(-0.1, 0.1, n),
               mass=850. * 200. * (2 * MTS_R) ** 2, thickness=200.,
               width=2 * MTS_R, length=2 * MTS_R, mass_scaling=1.,
               id_cnt=np.arange(n) + 1, max_bonds=6)
    st = forces.initialize_bonds_host(st, cfg)
    return forces.compute_conglom_ids_host(st)


def folded_world(cfg, layout, nx=FNX, ny=FNY, dxy=FDXY, device=CPU):
    return dd.make_sharded_world_2d(cfg, dd.Ring(layout), nx=nx, ny=ny,
                                    lon0=0., lat0=0., dlon=dxy, dlat=dxy,
                                    folded_north=True, device=device)


def edge_pair(nx=BNX):
    """``(cfg, grid, forcing, state)``: test_parallel_bonds.py's bonded
    pair straddling the tile edge at x = 8 km (2 tiles of 16 x 8 cells of
    1 km; 4 tiles with nx 32)."""
    cfg = ibp.IcebergsConfig(**BONDED)
    grid = ibp.make_uniform_grid(nx, BNY, 0., 0., BDXY, BDXY,
                                 grid_is_latlon=False, device=CPU)
    frc = ibp.uniform_forcing(nx, BNY, uo=0.2, sst=-2., device=CPU)
    return cfg, grid, frc, bonded_bergs(grid, [7800., 8200.], [4500., 4500.],
                                        capacity=64 if nx > BNX else 32,
                                        bond_length=500.)


def corner_pair():
    """The bonded pair diagonal across the 2 x 2 corner at (8, 8) km."""
    cfg = ibp.IcebergsConfig(**BONDED)
    grid = ibp.make_uniform_grid(16, 16, 0., 0., BDXY, BDXY,
                                 grid_is_latlon=False, device=CPU)
    frc = ibp.uniform_forcing(16, 16, uo=0.2, vo=0.1, sst=-2., device=CPU)
    return cfg, grid, frc, bonded_bergs(grid, [7800., 8200.], [7800., 8200.],
                                        bond_length=800.)


def mts_chain_world(layout=(2,), **cfg_kw):
    """test_parallel_bonds.py's MTS chain of 6 elements straddling the
    edge at 8 cells (16 x 8 cells of 7 km), or on a 2 x 2 layout the
    diagonal chain through the corner (16 x 16)."""
    cfg = mts_config(**cfg_kw)
    ny = 16 if len(layout) == 2 else 8
    grid = ibp.make_uniform_grid(16, ny, 0., 0., MTS_DXY, MTS_DXY,
                                 grid_is_latlon=False, device=CPU)
    frc = ibp.uniform_forcing(16, ny, device=CPU, **MTS_FORCING)
    if len(layout) == 2:
        s2 = 1.0 / np.sqrt(2.)
        st = mts_chain(grid, cfg, 8 * MTS_DXY, 8 * MTS_DXY, ux=s2, uy=s2)
    else:
        st = mts_chain(grid, cfg, 8 * MTS_DXY, 4.3 * MTS_DXY)
    return cfg, grid, frc, st


def fold_crossing():
    """test_parallel_fold.py's berg heading north 100 m below the folded
    edge of 16 x 16 cells of 4 km."""
    cfg = ibp.IcebergsConfig(**FOLD)
    grid = ibp.make_uniform_grid(FNX, FNY, 0., 0., FDXY, FDXY,
                                 grid_is_latlon=False, device=CPU)
    frc = ibp.uniform_forcing(FNX, FNY, sst=2.0, device=CPU)
    st = bergs(grid, [12123.0], [FNY * FDXY - 100.], vvel=[1.0],
               id_cnt=[7], **FOLD_BERG)
    return cfg, grid, frc, st


def tiled_bond_run(world_fn, layout, nsteps, *, device=CPU, cap=16,
                   width=16, mts=False, folded=False, **step_kw):
    """``nsteps`` of the tiled step (``mts``: the tiled MTS step) on the
    world ``world_fn()`` builds: a halo fill first but for MTS (whose
    step exchanges first).  Returns ``(tiles, owned count, overflow of
    the fill and of every step, the step)``."""
    cfg, grid, frc, st = world_fn()
    w = tiled_world(cfg, layout, grid.nx, grid.ny, float(grid.dlon),
                    device=device, **(dict(folded_north=True) if folded
                                      else {}))
    fs, ts = shard(w, frc, st, cap)
    ovs = []
    if mts:
        step = dd.make_sharded_mts_step(w, **step_kw)
    else:
        ts, ov = dd.make_halo_fill(w, width)(ts)
        ovs.append(ov)
        step = dd.make_sharded_step(w, exchange_width=width, **step_kw)
    nb = None
    for _ in range(nsteps):
        ts, nb, _, ov = step(ts, fs)
        ovs.append(ov)
    return ts, nb, ovs, step

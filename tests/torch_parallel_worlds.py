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


def tiled_world(cfg, layout, nx, ny, dxy):
    ring = dd.Ring(layout)
    if len(ring.layout) == 2:
        return dd.make_sharded_world_2d(cfg, ring, nx=nx, ny=ny, lon0=0.,
                                        lat0=0., dlon=dxy, dlat=dxy,
                                        device=CPU)
    return dd.make_sharded_world(cfg, ring, nx=nx, ny=ny, lon0=0., lat0=0.,
                                 dlon=dxy, dlat=dxy, device=CPU)


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

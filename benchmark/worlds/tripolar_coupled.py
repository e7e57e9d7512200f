"""The coupled world on a tripolar grid.

The benchmark plays the ocean model and the coupler: it makes every
input of the coupled step itself, from the configuration and the seed,
as plain tensors (:func:`inputs`), and hands the same values to the port
(:func:`build`, into the port's own containers) and to the plain
reference.

- The grid: GFDL OM4's nominal 0.25-degree tripolar layout, ``nx`` x
  ``ny`` cells from ``lat0``: regular in latitude and longitude up to
  ``lat_join``, a two-pole cap above it whose rows follow great circles
  to the fold; the cell metrics as the ocean hands them to KID (``dx``
  the northern edge, ``dy`` the eastern edge, both haversine, ``area =
  dx dy``); land south of ``land_south_of`` and on the cap's four polar
  cells; an ocean of ``ocean_depth`` metres elsewhere.
- The forcing: an analytic climatology of the Southern Ocean in
  summer (no sea ice, a flat sea surface): the Antarctic Circumpolar
  Current and the westerlies, the coastal current and the polar
  easterlies, meanders of the current, and the sea-surface temperature
  rising from the freezing point at the coast.
- The calving: the observed Antarctic discharge, spread evenly over the
  coast cells (every ocean cell whose southern neighbour is land), into
  buckets that hold, from the seed, a uniform fraction of each class's
  spawn threshold (a calving field in steady state).
- The bergs: ``n`` bergs in ``capacity`` slots over the ocean from
  ``land_south_of`` to ``seed_north_of``, each of a calving class drawn
  in proportion to the rate at which KID spawns that class, with the
  class's thickness and scaling and a length and width melted back to a
  fraction of the class's drawn from the seed.

Everything random is drawn on the device with a ``torch.Generator``
seeded from ``--seed``.
"""

import types

import numpy as np
import torch

# the calving classes of KID's southern hemisphere (Martin and Adcroft
# 2010, Table 1; the namelist defaults): mass (kg), the share of the
# calving flux, the number of bergs one model berg stands for, thickness
CLASS_MASS = (8.8e7, 4.1e8, 3.3e9, 1.8e10, 3.8e10, 7.5e10, 1.2e11, 2.2e11,
              3.9e11, 7.4e11)
CLASS_SHARE = (0.24, 0.12, 0.15, 0.18, 0.12, 0.07, 0.03, 0.03, 0.03, 0.02)
CLASS_SCALING = (2000., 200., 50., 20., 10., 5., 2., 1., 1., 1.)
CLASS_THICKNESS = (40., 67., 133., 175., 250., 250., 250., 250., 250.,
                   250.)
LOW_RATIO = 1.5                       # length over width of a new berg
REARTH = 6360000.0
SECONDS_PER_YEAR = 365. * 86400.

# the small size for runs on the CPU, written over a configuration: a
# coarse grid and its bergs crowded into the two degrees off the coast,
# so that spawns, bounces and, where they are on, contacts all happen
TINY = {"grid": {"nx": 360, "ny": 240, "seed_north_of": -68.0},
        "bergs": {"n": 12000, "capacity": 16384}}
# the CPU runs' variants of the small size: the configuration's
# discharge, and one that spawns a few bergs every step
VARIANTS = {"observed": {},
            "heavy": {"calving": {"discharge_kg_per_year": 1e17}}}


def class_dims(rho):
    """``(length, width)`` of each class's new berg (KID's class tables:
    area = mass / (rho thickness), L = sqrt(area LoW), W = sqrt(area /
    LoW))."""
    A = np.asarray(CLASS_MASS) / (rho * np.asarray(CLASS_THICKNESS))
    return np.sqrt(A * LOW_RATIO), np.sqrt(A / LOW_RATIO)


def _sph(lon, lat):
    p = np.pi / 180.
    lon, lat = np.broadcast_arrays(np.asarray(lon) * p, np.asarray(lat) * p)
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=-1)


def _slerp(a, b, t):
    """Points at fractions ``t`` along the great circles from ``a`` to
    ``b`` (unit vectors, ``...x3``)."""
    om = np.arccos(np.clip((a * b).sum(-1), -1., 1.))[..., None]
    s = np.sin(om)
    safe = np.where(s > 1e-12, s, 1.)
    t = np.asarray(t)[..., None]
    return np.where(s > 1e-12, (np.sin((1. - t) * om) * a
                                + np.sin(t * om) * b) / safe,
                    (1. - t) * a + t * b)


def tripolar_corners(nx, ny, lat0, lat_join=65., lat_poles=75.):
    """Corner longitudes and latitudes, (nx+1, ny+1) float64."""
    ny_cap = max(2, int(round(ny * (90. - lat_join) / (90. - lat0))))
    ny_ll = ny - ny_cap
    lons = 360. * np.arange(nx + 1) / nx
    lonc = np.repeat(lons[:, None], ny + 1, axis=1)
    latc = np.empty((nx + 1, ny + 1))
    latc[:, :ny_ll + 1] = lat0 + (lat_join - lat0) * np.arange(ny_ll + 1) \
        / ny_ll
    half = nx // 2
    t = np.arange(half + 1) / half
    p1, p2 = _sph(90., lat_poles), _sph(270., lat_poles)
    pole = np.array([0., 0., 1.])
    fold = np.where((t <= 0.5)[:, None],
                    _slerp(p1, pole, np.minimum(2. * t, 1.)),
                    _slerp(pole, p2, np.maximum(2. * t - 1., 0.)))
    fold = np.concatenate([fold, fold[:nx - half][::-1]])[:nx + 1]
    q = _sph(lons, lat_join)
    k = np.arange(1, ny_cap + 1) / ny_cap
    v = _slerp(q[:, None, :], fold[:, None, :], k[None, :])
    latc[:, ny_ll + 1:] = np.degrees(np.arcsin(np.clip(v[..., 2], -1., 1.)))
    cap_lon = np.degrees(np.arctan2(v[..., 1], v[..., 0]))
    # longitudes continuous along each column
    col = np.concatenate([lonc[:, ny_ll:ny_ll + 1], cap_lon], axis=1)
    col = np.degrees(np.unwrap(np.radians(col), axis=1))
    lonc[:, ny_ll + 1:] = col[:, 1:]
    return lonc, latc


def _haversine(lon1, lat1, lon2, lat2):
    p = np.pi / 180.
    a = np.sin((lat2 - lat1) * p / 2) ** 2 + np.cos(lat1 * p) \
        * np.cos(lat2 * p) * np.sin((lon2 - lon1) * p / 2) ** 2
    return 2 * REARTH * np.arcsin(np.sqrt(np.clip(a, 0., 1.)))


def _pad(a):
    return np.pad(a, 1)


def inputs(conf, seed, device):
    """Every input of the coupled step, as plain float32 (and int32)
    tensors on ``device``: ``grid``, ``forcing``, ``bergs`` (the live
    rows), ``calving`` (kg/s a cell), ``stored`` (kg a cell and class)."""
    g, b, c, f = conf["grid"], conf["bergs"], conf["calving"], \
        conf["forcing"]
    nx, ny = g["nx"], g["ny"]
    lonc, latc = tripolar_corners(nx, ny, g["lat0"])
    dx = _haversine(lonc[:-1, 1:], latc[:-1, 1:], lonc[1:, 1:], latc[1:, 1:])
    dy = _haversine(lonc[1:, :-1], latc[1:, :-1], lonc[1:, 1:], latc[1:, 1:])
    latm = 0.25 * (latc[:-1, :-1] + latc[1:, :-1] + latc[:-1, 1:]
                   + latc[1:, 1:])
    ocean = latm >= g["land_south_of"]
    for i in (nx // 4 - 1, nx // 4, 3 * nx // 4 - 1, 3 * nx // 4):
        ocean[i, ny - 1] = False
    coast = np.zeros_like(ocean)
    coast[:, 1:] = ocean[:, 1:] & ~ocean[:, :-1] & (latm[:, 1:] < 0.)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    grid = types.SimpleNamespace(
        nx=nx, ny=ny, lonc=t(lonc), latc=t(latc), msk=t(_pad(ocean)),
        dx=t(_pad(dx)), dy=t(_pad(dy)), area=t(_pad(dx * dy)),
        ocean_depth=t(_pad(np.where(ocean, g["ocean_depth"], 0.))),
        lat_center=t(_pad(latm)))
    forcing = climatology(grid, f, device)

    # the observed discharge, evenly over the coast cells
    flux = c["discharge_kg_per_year"] / SECONDS_PER_YEAR / coast.sum()
    calving = t(_pad(np.where(coast, flux, 0.)))

    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    cap = torch.tensor(np.asarray(CLASS_MASS) * np.asarray(CLASS_SCALING),
                       dtype=torch.float32, device=device)
    u = torch.rand((nx + 2, ny + 2, len(CLASS_MASS)), generator=gen,
                   device=device)
    stored = torch.where((calving > 0.)[:, :, None], cap * u, 0.)

    bergs = seed_bergs(grid, g, b, conf["model"].get("rho_bergs", 850.), gen,
                       ocean, latm, device)
    return types.SimpleNamespace(grid=grid, forcing=forcing, bergs=bergs,
                                 calving=calving, stored=stored,
                                 capacity=b["capacity"])


def climatology(grid, f, device):
    """The forcing at the corners (velocities, m/s) and centres
    (temperature C, salinity psu; sea surface, sea ice: none)."""
    lon = grid.lonc.double()
    lat = grid.latc.double()

    def bump(centre, width):
        return torch.exp(-((lat - centre) / width) ** 2)

    rad = torch.pi / 180.
    uo = f["acc_u"] * bump(f["acc_lat"], f["acc_width"]) \
        - f["coastal_u"] * bump(f["coastal_lat"], f["coastal_width"])
    vo = f["meander_v"] * torch.sin(f["meander_waves"] * lon * rad) \
        * bump(f["acc_lat"], f["acc_width"])
    ua = f["westerly_u"] * bump(f["westerly_lat"], f["westerly_width"]) \
        - f["easterly_u"] * bump(f["coastal_lat"], f["coastal_width"])
    va = f["wind_v"] * torch.cos(2. * lon * rad)
    latm = grid.lat_center.double()
    sst = (f["sst_coast"] + f["sst_per_degree"]
           * (latm - f["sst_coast_lat"])).clamp(max=f["sst_max"])
    zc = torch.zeros_like(grid.lonc)
    zp = torch.zeros_like(grid.msk)
    return types.SimpleNamespace(
        uo=uo.float(), vo=vo.float(), ui=zc, vi=zc.clone(), ua=ua.float(),
        va=va.float(), ssh=zp, sst=sst.float(),
        sss=torch.full_like(zp, f["sss"]), cn=zp.clone(), hi=zp.clone())


def seed_bergs(grid, g, b, rho, gen, ocean, latm, device):
    """The live bergs' fields (float32, int32), from the seed."""
    n = b["n"]
    cells = torch.as_tensor(np.argwhere(ocean & (latm < g["seed_north_of"])),
                            device=device)
    pick = cells[torch.randint(len(cells), (n,), generator=gen,
                               device=device)]
    i, j = pick[:, 0], pick[:, 1]
    w = torch.rand((2, n), generator=gen, device=device,
                   dtype=torch.float64) * 0.9 + 0.05
    lonc, latc = grid.lonc.double(), grid.latc.double()
    lon = (lonc[i, j] + w[0] * (lonc[i + 1, j] - lonc[i, j])).float()
    lat = (latc[i, j] + w[1] * (latc[i, j + 1] - latc[i, j])).float()
    xi = ((lon.double() - lonc[i, j]) / (lonc[i + 1, j] - lonc[i, j])
          ).float()
    yj = ((lat.double() - latc[i, j]) / (latc[i, j + 1] - latc[i, j])
          ).float()
    # classes in proportion to KID's spawn rate of each: its share of the
    # flux over the mass of one spawn
    mass_c = np.asarray(CLASS_MASS)
    rate = np.asarray(CLASS_SHARE) / (mass_c * np.asarray(CLASS_SCALING))
    k = torch.multinomial(torch.as_tensor(rate / rate.sum(), device=device),
                          n, replacement=True, generator=gen)
    L0, W0 = class_dims(rho)
    frac = torch.rand(n, generator=gen, device=device, dtype=torch.float64) \
        * (1. - b["melted_back_to"]) + b["melted_back_to"]

    def tab(v):
        return torch.as_tensor(np.asarray(v), device=device)[k]

    T = tab(CLASS_THICKNESS)
    L, W = tab(L0) * frac, tab(W0) * frac
    return types.SimpleNamespace(
        n=n, lon=lon, lat=lat, ine=i.to(torch.int32), jne=j.to(torch.int32),
        xi=xi, yj=yj, thickness=T.float(), length=L.float(),
        width=W.float(), mass=(rho * T * L * W).float(),
        mass_scaling=tab(CLASS_SCALING).float(),
        start_mass=tab(mass_c).float(),
        id_ij=((i + 1) + grid.nx * j).to(torch.int32),
        id_cnt=(1_000_000 + torch.arange(n, device=device)).to(torch.int32))


class World:
    def __init__(self, cfg, grid, frc, bergs, calving, stored):
        self.cfg, self.grid, self.frc = cfg, grid, frc
        self.bergs, self.calving, self.stored = bergs, calving, stored


def build(kid, conf, seed, device):
    """The port's world: the inputs in the port's containers."""
    x = inputs(conf, seed, device)
    return program_world(kid, conf, x, device)


def program_world(kid, conf, x, device):
    cfg = kid.IcebergsConfig(**conf["model"])
    g = x.grid
    grid = kid.Grid(
        nx=g.nx, ny=g.ny, lonc=g.lonc, latc=g.latc,
        cosc=torch.ones_like(g.lonc), sinc=torch.zeros_like(g.lonc),
        msk=g.msk, area=g.area, dx=g.dx, dy=g.dy,
        ocean_depth=g.ocean_depth, lat_center=g.lat_center,
        lon0=g.lonc[0, 0].clone(), lat0=g.latc[0, 0].clone(),
        dlon=g.lonc[1, 0] - g.lonc[0, 0], dlat=g.latc[0, 1] - g.latc[0, 0])
    f = x.forcing
    frc = kid.Forcing(uo=f.uo, vo=f.vo, ui=f.ui, vi=f.vi, ua=f.ua, va=f.va,
                      ssh=f.ssh, sst=f.sst, sss=f.sss, cn=f.cn, hi=f.hi)
    b = x.bergs

    def h(v):
        return v.cpu().numpy()
    st = kid.create_bergs(
        x.capacity, lon=h(b.lon), lat=h(b.lat), mass=h(b.mass),
        thickness=h(b.thickness), width=h(b.width), length=h(b.length),
        mass_scaling=h(b.mass_scaling), id_cnt=h(b.id_cnt), id_ij=h(b.id_ij),
        start_mass=h(b.start_mass), device=device)
    n = b.n

    def slab(v, fill=0):
        out = torch.full((x.capacity,), fill, dtype=v.dtype, device=device)
        out[:n] = v
        return out
    st = st.replace(ine=slab(b.ine), jne=slab(b.jne), xi=slab(b.xi),
                    yj=slab(b.yj))
    return World(cfg, grid, frc, st, x.calving, x.stored)


"""The plain reference of the coupled entry: KID's coupling step written
out from the model's equations, one berg a row, in float64.

It takes the inputs the benchmark made (``worlds/<world>.inputs``) and
nothing else: no state, table or layout of the port.  A step, in KID's
order (Martin and Adcroft 2010; Stern et al. 2017 for the contacts):

1. the calving buckets take their shares of the flux; every full bucket
   of an ocean cell spawns up to two bergs of its class at the cell's
   centre;
2. the environment at each berg: the corner velocities by KID's default
   bilinear weights (``old_bug_bilin``: the weights mirrored), the cell's
   temperature;
3. the velocity-Verlet step with the semi-implicit drag and Coriolis
   solve, wave radiation and the contact forces of every pair closer
   than the sum of its radii (a spring and critical damping, the damping
   scaled by the pair's relative speed), the contacts found exactly by
   binning the bergs into their cells;
4. the walk to the new cell, bouncing off land;
5. the melt (buoyant convection, basal and wave erosion), by operator
   splitting, and the death of fully melted bergs;
6. the mass, area and momentum spread over each berg's 3 x 3 cells; the
   coupler's fields and the budgets.

With ``interactive_icebergs_on`` off (KID's default) step 3 has no
pairs: no search is made and every contact term is a sum over none.

It covers the configuration the benchmark runs (a lat-lon grid whose
bergs stay in the rows below the tripolar cap; no sea ice, a flat sea
surface; no bergy bits, rolling, footloose or grounding) and refuses any
other.  ``lower=True`` stores every float of the berg state but the
positions in bfloat16 after each step: the lower-precision control.  The
comparison that decides ``correct`` is ``compare.numbers``.
"""

import math
import types

import torch

from ..entries.answers import ROW_FIELDS
from .compare import numbers  # noqa: F401  (this entry's comparison)

# KID's constants (src/icebergs.F90:68-80)
RHO_SW, RHO_AIR, GRAVITY = 1025., 1.1, 9.8
CD_AV, CD_AH, CD_WV, CD_WH = 1.3, 0.0055, 0.9, 0.0012
OMEGA = 7.292e-5
POSN_EPS = 0.05
SPAWN_MAX = 2                      # bergs a bucket spawns a step
KEY = 32
F64 = torch.float64

# the configuration this reference covers: each key, the value it needs
COVERS = dict(grid_is_latlon=True, use_f_plane=False, grid_is_regular=False,
              Runge_not_Verlet=False, use_new_predictive_corrective=True,
              allow_bergs_to_roll=False, footloose=False, mts=False,
              old_bug_bilin=True, LoW_ratio=1.5)
# KID's defaults of the settings it reads (contacts: off)
DEFAULTS = dict(interactive_icebergs_on=False, rho_bergs=850.,
                Rearth=6360000., spring_coef=1e-8,
                contact_distance=0., contact_spring_coef=0.,
                bergy_bit_erosion_fraction=0., tidal_drift=0.,
                coastal_drift=0., cdrag_grounding=0., speed_limit=0.,
                tau_calving=0., cdrag_icebergs=1.5e-3, utide_icebergs=0.,
                ustar_icebergs_bg=0.001, ocean_drag_scale=1.)
# the calving classes are the world's (KID's defaults), not the model's
CLASS_KEYS = ("initial_mass", "distribution", "mass_scaling",
              "initial_thickness", "separate_distrib_for_n_hemisphere")


def settings(model):
    """The model's settings, refused where this reference does not cover
    them."""
    s = dict(DEFAULTS, **model)
    for k, v in COVERS.items():
        if s.get(k, v) != v:
            raise ValueError(f"the reference does not cover {k}={s[k]!r}")
    if s["contact_distance"] or s["contact_spring_coef"] not in (
            0., s["spring_coef"]):
        raise ValueError("the reference covers KID's original contacts")
    for k in ("bergy_bit_erosion_fraction", "tidal_drift", "coastal_drift",
              "cdrag_grounding", "speed_limit", "tau_calving"):
        if s[k]:
            raise ValueError(f"the reference does not cover {k}={s[k]!r}")
    for k in CLASS_KEYS:
        if k in model:
            raise ValueError(f"the reference takes KID's default {k}")
    return types.SimpleNamespace(**s)


class Grid:
    def __init__(self, g, device):
        self.nx, self.ny = g.nx, g.ny
        self.lonc, self.latc = g.lonc.to(device, F64), g.latc.to(device, F64)
        self.msk = g.msk.to(device, F64)
        self.area = g.area.to(device, F64)
        self.dx, self.dy = g.dx.to(device, F64), g.dy.to(device, F64)
        # the rows of cells below the cap, each cell a lon-lat rectangle
        flat = (self.latc == self.latc[:1]).all(0) \
            & (self.lonc == self.lonc[:, :1]).all(0)
        rect = flat[:-1] & flat[1:]
        self.rect_rows = int(torch.nonzero(~rect)[0]) if (~rect).any() \
            else self.ny


def _modulo(x, ref):
    """``x`` within 180 degrees of ``ref``."""
    return torch.remainder(x - (ref - 180.), 360.) + (ref - 180.)


def xiyj(grid, lon, lat, i, j):
    """A position's place in cell (i, j) of the rectangular rows."""
    x1, x2 = grid.lonc[i, j], grid.lonc[i + 1, j]
    y1, y2 = grid.latc[i, j], grid.latc[i, j + 1]
    return (_modulo(lon, x1) - x1) / (x2 - x1), (lat - y1) / (y2 - y1)


def cell_pos(grid, i, j, xi, yj):
    x1, x2 = grid.lonc[i, j], grid.lonc[i + 1, j]
    y1, y2 = grid.latc[i, j], grid.latc[i, j + 1]
    return x1 + xi * (_modulo(x2, x1) - x1), y1 + yj * (y2 - y1)


def walk(grid, lon, lat, i, j):
    """KID's ``adjust_index_and_ground``: at most four steps of one cell
    in x then in y toward the new position; a step into land, or off the
    grid, bounces the berg just inside its cell."""
    msk = grid.msk
    for _ in range(4):
        xi, yj = xiyj(grid, lon, lat, i, j)
        inside = (xi >= 0.) & (xi < 1.) & (yj >= 0.) & (yj < 1.)
        west, east = xi < 0., xi >= 1.
        ti = (i - west.long() + east.long()).clamp(0, grid.nx - 1)
        wet = msk[ti + 1, j + 1] > 0.
        go = ~inside & (west | east)
        bounce = go & (~wet | (ti == i))
        i = torch.where(go & wet, ti, i)
        south, north = yj < 0., yj >= 1.
        tj = (j - south.long() + north.long()).clamp(0, grid.ny - 1)
        wet = msk[i + 1, tj + 1] > 0.
        go = ~inside & (south | north)
        bounce = bounce | (go & (~wet | (tj == j)))
        j = torch.where(go & wet, tj, j)
        xi, yj = xiyj(grid, lon, lat, i, j)
        blon, blat = cell_pos(grid, i, j, xi.clamp(POSN_EPS, 1. - POSN_EPS),
                              yj.clamp(POSN_EPS, 1. - POSN_EPS))
        lon = torch.where(bounce, blon, lon)
        lat = torch.where(bounce, blat, lat)
    xi, yj = xiyj(grid, lon, lat, i, j)
    bad = (xi < 0.) | (xi >= 1.) | (yj <= 0.) | (yj > 1.)
    xc, yc = xi.clamp(POSN_EPS, 1. - POSN_EPS), yj.clamp(POSN_EPS,
                                                         1. - POSN_EPS)
    clon, clat = cell_pos(grid, i, j, xc, yc)
    return (torch.where(bad, clon, lon), torch.where(bad, clat, lat), i, j,
            torch.where(bad, xc, xi), torch.where(bad, yc, yj))


def environment(grid, frc, b):
    """The forcing at each berg: corner fields by KID's default bilinear
    weights, mirrored (``old_bug_bilin``), centre fields by the cell."""
    i, j, xi, yj = b.i, b.j, b.xi, b.yj

    def corners(f):
        f00, f10, f01, f11 = f[i, j], f[i + 1, j], f[i, j + 1], \
            f[i + 1, j + 1]
        return (f11 * (1. - xi) + f01 * xi) * (1. - yj) \
            + (f10 * (1. - xi) + f00 * xi) * yj

    c = (i + 1, j + 1)
    b.uo, b.vo = corners(frc.uo), corners(frc.vo)
    b.ua, b.va = corners(frc.ua), corners(frc.va)
    b.sst = frc.sst[c]


def pair_geometry(grid, b, s):
    """Every pair of bergs closer than the sum of their radii (R =
    sqrt(L W / pi)), found by binning the bergs into their cells and
    testing each against the bergs of its own and the eight neighbouring
    cells; the pair terms of KID's ``calculate_force`` that depend on the
    positions alone."""
    n = b.lon.shape[0]
    R = torch.sqrt(b.length * b.width / math.pi)
    span = torch.minimum(grid.dx[b.i + 1, b.j + 1], grid.dy[b.i + 1, b.j + 1])
    if n and float((2. * R.max()) / span.min()) >= 1.:
        raise ValueError("a pair could span more than one cell")
    nx, ny = grid.nx, grid.ny
    cell = b.j * nx + b.i
    order = torch.argsort(cell)
    count = torch.bincount(cell, minlength=nx * ny)
    start = torch.cumsum(count, 0) - count
    A, B = [], []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            ii, jj = b.i + di, b.j + dj
            ok = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny)
            nc = (jj * nx + ii).clamp(0, nx * ny - 1)
            cnt = torch.where(ok, count[nc], 0)
            a = torch.repeat_interleave(torch.arange(n, device=b.lon.device),
                                        cnt)
            first = torch.cumsum(cnt, 0) - cnt
            k = torch.arange(a.shape[0], device=a.device) - first[a]
            bb = order[start[nc[a]] + k]
            rx, ry, r = separation(b, a, bb, s)
            keep = (a != bb) & (r > 0.) & (r < R[a] + R[bb])
            A.append(a[keep])
            B.append(bb[keep])
    a, bb = torch.cat(A), torch.cat(B)
    rx, ry, r = separation(b, a, bb, s)
    crit = R[a] + R[bb]
    mm = torch.minimum(b.mass[a], b.mass[bb]) / b.mass[a]
    spring = s.spring_coef * mm * (crit - r)
    radial = 2. * math.sqrt(s.spring_coef)
    return types.SimpleNamespace(
        a=a, b=bb, n=n, IA_x=torch.zeros(n, dtype=F64, device=a.device
                                         ).index_add_(0, a, spring * rx / r),
        IA_y=torch.zeros(n, dtype=F64, device=a.device
                         ).index_add_(0, a, spring * ry / r),
        P11=rx * rx / (r * r), P12=rx * ry / (r * r), P22=ry * ry / (r * r),
        crad=radial * mm, ctan=radial / 4. * mm)


def no_pairs(b):
    """The pair terms with no pairs (contacts off)."""
    n, dev = b.lon.shape[0], b.lon.device
    e = torch.zeros(0, dtype=F64, device=dev)
    ei = torch.zeros(0, dtype=torch.long, device=dev)
    z = torch.zeros(n, dtype=F64, device=dev)
    return types.SimpleNamespace(a=ei, b=ei, n=n, IA_x=z, IA_y=z.clone(),
                                 P11=e, P12=e, P22=e, crad=e, ctan=e)


def separation(b, a, c, s):
    """``(rx, ry, r)`` in metres from berg ``c`` to berg ``a``: the
    differences of lon and lat times the metric at their mean latitude."""
    k = math.pi / 180. * s.Rearth
    mid = 0.5 * (b.lat[a] + b.lat[c])
    rx = (b.lon[a] - b.lon[c]) * (torch.cos(mid * (math.pi / 180.)) * k)
    ry = (b.lat[a] - b.lat[c]) * k
    return rx, ry, torch.sqrt(rx * rx + ry * ry)


def contact(pg, b, u1, v1):
    """The contact terms at berg velocities ``(u1, v1)``: the spring
    accelerations and the damping's implicit matrix and explicit part,
    summed over each berg's partners."""
    a, c = pg.a, pg.b
    u2, v2 = b.uvel[c], b.vvel[c]
    u0, v0 = b.uvel[a], b.vvel[a]

    def pmag(p11, p12, p22, coef):
        du1, dv1 = u2 - u1[a], v2 - v1[a]
        du0, dv0 = u2 - u0, v2 - v0
        m1 = torch.hypot(p11 * du1 + p12 * dv1, p12 * du1 + p22 * dv1)
        m0 = torch.hypot(p11 * du0 + p12 * dv0, p12 * du0 + p22 * dv0)
        return coef * 0.5 * (m1 + m0)

    wr = pmag(pg.P11, pg.P12, pg.P22, pg.crad)
    wt = pmag(1. - pg.P11, -pg.P12, 1. - pg.P22, pg.ctan)
    d11 = wr * pg.P11 + wt * (1. - pg.P11)
    d12 = wr * pg.P12 - wt * pg.P12
    d22 = wr * pg.P22 + wt * (1. - pg.P22)

    def total(v):
        return torch.zeros(pg.n, dtype=F64, device=a.device).index_add_(
            0, a, v)
    return types.SimpleNamespace(
        P11=total(d11), P12=total(d12), P22=total(d22),
        Pu_x=total(d11 * u2 + d12 * v2), Pu_y=total(d12 * u2 + d22 * v2))


def accel(b, pg, s, dt):
    """KID's ``accel`` for the Verlet step: the accelerations ``(ax, ay)``
    and the explicit parts ``(axn, ayn, bxn, byn)`` the next step
    carries."""
    u0, v0 = b.uvel, b.vvel
    ustar, vstar = u0 + b.axn * (dt / 2.), v0 + b.ayn * (dt / 2.)
    f = 2. * OMEGA * torch.sin(b.lat * (math.pi / 180.))
    M, T, W, L = b.mass.clamp(min=1e-30), b.thickness, b.width, b.length
    D = (s.rho_bergs / RHO_SW) * T
    F = T - D
    # wave radiation along the wind
    wu, wv = b.ua - b.uo, b.va - b.vo
    w2 = wu * wu + wv * wv
    ampl = 0.5 * 0.02025 * w2
    lw = 0.32 * w2
    Cr = 0.06 * ((L - 0.125 * lw) / ((0.25 * lw - 0.125 * lw) + 1e-30)
                 ).clamp(0., 1.)
    wave = 0.5 * RHO_SW / M * Cr * GRAVITY * ampl * torch.minimum(ampl, F) \
        * (2. * W * L) / (W + L).clamp(min=1e-30)
    wind = torch.hypot(b.ua, b.va)
    calm = wind == 0.
    wind = torch.where(calm, 1., wind)
    gx = torch.where(calm, 0., wave * b.ua / wind)
    gy = torch.where(calm, 0., wave * b.va / wind)
    c_ocn = RHO_SW / M * s.ocean_drag_scale * (0.5 * CD_WV * W * D
                                               + CD_WH * W * L)
    c_atm = RHO_AIR / M * (0.5 * CD_AV * W * F + CD_AH * W * L)

    axn = gx + pg.IA_x + f * vstar
    ayn = gy + pg.IA_y - f * ustar
    un, vn = u0, v0
    for it in range(2):
        ia = contact(pg, b, u0, v0) if it == 0 else contact(pg, b, un, vn)
        d_ocn = c_ocn * 0.5 * (torch.hypot(un - b.uo, vn - b.vo)
                               + torch.hypot(u0 - b.uo, v0 - b.vo))
        d_atm = c_atm * 0.5 * (torch.hypot(un - b.ua, vn - b.va)
                               + torch.hypot(u0 - b.ua, v0 - b.va))
        rx = axn / 2. - d_ocn * (ustar - b.uo) - d_atm * (ustar - b.ua) \
            - ((ia.P11 * ustar + ia.P12 * vstar) - ia.Pu_x)
        ry = ayn / 2. - d_ocn * (vstar - b.vo) - d_atm * (vstar - b.va) \
            - ((ia.P12 * ustar + ia.P22 * vstar) - ia.Pu_y)
        lam = d_ocn + d_atm
        a11 = 1. + dt * lam + dt * ia.P11
        a22 = 1. + dt * lam + dt * ia.P22
        a12 = -dt * f / 2. + dt * ia.P12
        a21 = dt * f / 2. + dt * ia.P12
        det = a11 * a22 - a12 * a21
        ax = (a22 * rx - a12 * ry) / det
        ay = (a11 * ry - a21 * rx) / det
        un, vn = ustar + dt * ax, vstar + dt * ay
    axn = gx + pg.IA_x + f * vn
    ayn = gy + pg.IA_y - f * un
    return ax, ay, axn, ayn, ax - axn / 2., ay - ayn / 2.


def melt(b, s, dt):
    """KID's melt by operator splitting: ``(new mass, thickness, width,
    length, mass melted)``."""
    perday = 1. / 86400.
    dvo = torch.hypot(b.uvel - b.uo, b.vvel - b.vo)
    dva = torch.hypot(b.ua - b.uo, b.va - b.vo)
    sea = 1.5 * torch.sqrt(dva) + 0.1 * dva
    sst = b.sst
    Mv = (7.62e-3 * sst + 1.29e-3 * sst * sst).clamp(min=0.) * perday
    Mb = (0.58 * dvo ** 0.8 * (sst + 4.)
          / b.length.clamp(min=1e-30) ** 0.2).clamp(min=0.) \
        * perday
    # wave erosion; with no sea ice its damping factor 1 + cos(0) is 2
    Me = ((1. / 12.) * (sst + 2.) * sea * 2.).clamp(min=0.) * perday
    M, T, W, L = b.mass, b.thickness, b.width, b.length
    rho = M / (T * W * L).clamp(min=1e-30)
    # basal melt thins the berg, buoyant convection and then erosion
    # narrow its sides
    Tn = (T - Mb * dt).clamp(min=0.)
    dMb = rho * W * L * torch.minimum(Mb * dt, T)
    dv = Mv * dt
    Ln1, Wn1 = (L - dv).clamp(min=0.), (W - dv).clamp(min=0.)
    dWv, dLv = torch.minimum(dv, W), torch.minimum(dv, L)
    dMv = rho * Tn * (dWv * L + dLv * W - dWv * dLv)
    de = Me * dt
    dWe, dLe = torch.minimum(de, Wn1), torch.minimum(de, Ln1)
    Ln, Wn = (Ln1 - de).clamp(min=0.), (Wn1 - de).clamp(min=0.)
    dMe = rho * Tn * (dWe * Ln1 + dLe * Wn1 - dWe * dLe)
    dM = dMb + dMv + dMe
    return M - dM, Tn, torch.minimum(Wn, Ln), torch.maximum(Wn, Ln), dM


def spread(grid, frc, b, s):
    """Each berg's mass, area and area-weighted velocity over its 3 x 3
    cells (KID's original weights: the part of a centred cell-sized
    square in each neighbour, lost over land to the berg's own cell);
    the coupler's spread fields."""
    x, y = b.xi, b.yj
    m = {(di, dj): grid.msk[b.i + 1 + di, b.j + 1 + dj]
         for di in (-1, 0, 1) for dj in (-1, 0, 1)}
    wx = {-1: (0.5 - x).clamp(0., 0.5), 1: (x - 0.5).clamp(0., 0.5)}
    wy = {-1: (0.5 - y).clamp(0., 0.5), 1: (y - 0.5).clamp(0., 0.5)}
    wx[0] = (1. - (wx[-1] + wx[1])).clamp(min=0.)
    wy[0] = (1. - (wy[-1] + wy[1])).clamp(min=0.)
    area = b.length * b.width * b.scaling
    vals = [b.mass * b.scaling, area, b.uvel * area, b.vvel * area]
    w = {k: wx[k[0]] * wy[k[1]] * m[k] for k in m if k != (0, 0)}
    w[(0, 0)] = 1. - sum(w.values())
    out = torch.zeros(4, grid.nx + 2, grid.ny + 2, dtype=F64,
                      device=x.device)
    for (di, dj), wk in w.items():
        flat = (b.i + 1 + di) * (grid.ny + 2) + (b.j + 1 + dj)
        for k, v in enumerate(vals):
            out[k].view(-1).index_add_(0, flat, wk * v)
    mass_on, area_on, u_on, v_on = out
    wet = grid.msk > 0.
    spread_mass = torch.where(wet, mass_on / grid.area.clamp(min=1e-30), 0.)
    spread_area = torch.where(wet, area_on / grid.area.clamp(min=1e-30), 0.)
    has = area_on > 0.
    su = torch.where(has, u_on / area_on.clamp(min=1e-30), 0.)
    sv = torch.where(has, v_on / area_on.clamp(min=1e-30), 0.)
    uo = torch.zeros_like(su)
    vo = torch.zeros_like(sv)
    uo[1:-1, 1:-1] = 0.25 * (frc.uo[:-1, :-1] + frc.uo[1:, :-1]
                             + frc.uo[:-1, 1:] + frc.uo[1:, 1:])
    vo[1:-1, 1:-1] = 0.25 * (frc.vo[:-1, :-1] + frc.vo[1:, :-1]
                             + frc.vo[:-1, 1:] + frc.vo[1:, 1:])
    du, dv = su - uo, sv - vo
    ustar = torch.sqrt(s.cdrag_icebergs * (du * du + dv * dv
                                           + s.utide_icebergs ** 2)
                       ).clamp(min=s.ustar_icebergs_bg)
    return dict(spread_mass=spread_mass, spread_area=spread_area,
                spread_uvel=su, spread_vvel=sv,
                ustar_iceberg=torch.where(spread_area == 0., 0., ustar),
                mass_on_ocean=mass_on)


class Model:
    """The reference's coupled model: the inputs, the calving classes and
    the berg rows (float64)."""

    def __init__(self, x, conf, world, device):
        self.s = settings(conf["model"])
        self.dt = float(self.s.dt)
        self.grid = Grid(x.grid, device)
        f = x.forcing
        if any(bool((getattr(f, k) != 0).any())
               for k in ("ssh", "ui", "vi", "cn", "hi")):
            raise ValueError("the reference covers no sea ice and a flat "
                             "sea surface")
        self.frc = types.SimpleNamespace(**{k: v.to(device, F64)
                                            for k, v in vars(f).items()})
        self.calving = x.calving.to(device, F64)
        self.stored = x.stored.to(device, F64)
        self.counter = torch.zeros(self.grid.nx + 2, self.grid.ny + 2,
                                   dtype=torch.long, device=device)
        L0, W0 = world.class_dims(self.s.rho_bergs)

        def tab(v):
            return torch.tensor(v, dtype=F64, device=device)
        self.cls = types.SimpleNamespace(
            mass=tab(world.CLASS_MASS), share=tab(world.CLASS_SHARE),
            scaling=tab(world.CLASS_SCALING),
            thickness=tab(world.CLASS_THICKNESS), L=tab(L0), W=tab(W0))
        self.capacity = x.capacity
        b = x.bergs
        z = torch.zeros(b.n, dtype=F64, device=device)
        self.b = types.SimpleNamespace(
            key=_key(b.id_ij, b.id_cnt), i=b.ine.long(), j=b.jne.long(),
            **{k: getattr(b, k).to(device, F64) for k in (
                "lon", "lat", "xi", "yj", "mass", "thickness", "width",
                "length", "start_mass")},
            scaling=b.mass_scaling.to(device, F64),
            start_lon=b.lon.to(device, F64), start_lat=b.lat.to(device, F64),
            uvel=z, vvel=z.clone(), axn=z.clone(), ayn=z.clone(),
            bxn=z.clone(), byn=z.clone(), heat=z.clone())

    def calve(self):
        """The buckets, then the spawn; returns (residual flux, spawned)."""
        g, c, dt = self.grid, self.cls, self.dt
        self.stored = self.stored + dt * self.calving[:, :, None] * c.share
        residual = self.calving * (1. - float(c.share.sum()))
        cap = c.mass * c.scaling
        want = torch.floor(self.stored / cap).clamp(0, SPAWN_MAX).long()
        interior = torch.zeros_like(g.msk, dtype=torch.bool)
        interior[1:-1, 1:-1] = True
        want = torch.where((interior & (g.msk > 0.))[:, :, None], want, 0)
        I, J, K = torch.nonzero(want, as_tuple=True)
        reps = want[I, J, K]
        I, J, K = (torch.repeat_interleave(v, reps) for v in (I, J, K))
        first = torch.cumsum(reps, 0) - reps
        m = torch.arange(I.shape[0], device=I.device) \
            - torch.repeat_interleave(first, reps)
        i, j = I - 1, J - 1
        nc = K.numel()
        if nc:
            lon = 0.25 * (g.lonc[i, j] + g.lonc[i + 1, j] + g.lonc[i, j + 1]
                          + g.lonc[i + 1, j + 1])
            lat = 0.25 * (g.latc[i, j] + g.latc[i + 1, j] + g.latc[i, j + 1]
                          + g.latc[i + 1, j + 1])
            cnt = self.counter[I, J] + 1 + m * len(c.mass) + K
            new = dict(key=_key((i + 1) + g.nx * j, cnt), i=i, j=j, lon=lon,
                       lat=lat, xi=torch.full_like(lon, 0.5),
                       yj=torch.full_like(lon, 0.5), mass=c.mass[K],
                       thickness=c.thickness[K], width=c.W[K],
                       length=c.L[K], scaling=c.scaling[K],
                       start_mass=c.mass[K], start_lon=lon,
                       start_lat=lat)
            for k in vars(self.b):
                v = new.get(k, torch.zeros_like(lon))
                setattr(self.b, k, torch.cat([getattr(self.b, k), v]))
        self.stored = self.stored - want * cap
        self.counter = self.counter + want.sum(-1)
        return residual, nc

    def step(self, lower=False):
        """One coupling step; returns its outputs."""
        s, g, dt, frc = self.s, self.grid, self.dt, self.frc
        residual, calved = self.calve()
        b = self.b
        if b.lon.shape[0] > self.capacity:
            raise ValueError("more bergs than slots")
        environment(g, frc, b)
        pg = (pair_geometry(g, b, s) if s.interactive_icebergs_on
              else no_pairs(b))
        ax, ay, axn, ayn, bxn, byn = accel(b, pg, s, dt)
        u = (b.uvel + dt / 2. * b.axn) + dt * ax
        v = (b.vvel + dt / 2. * b.ayn) + dt * ay
        b.uvel, b.vvel, b.axn, b.ayn, b.bxn, b.byn = u, v, axn, ayn, bxn, byn
        u2, v2 = u + dt / 2. * (axn + bxn), v + dt / 2. * (ayn + byn)
        k = math.pi / 180. * s.Rearth
        lon = b.lon + dt * u2 / (torch.cos(b.lat * (math.pi / 180.)) * k)
        lat = b.lat + dt * v2 / k
        if bool((b.j + 4 >= g.rect_rows).any()):
            raise ValueError("a berg came within reach of the tripolar cap")
        b.lon, b.lat, b.i, b.j, b.xi, b.yj = walk(g, lon, lat, b.i, b.j)

        mass, T, W, L, dM = melt(b, s, dt)
        w = b.scaling / (dt * g.area[b.i + 1, b.j + 1])
        # the melt each berg hands its cell this step: floating melt, its
        # heat, the bergs' melt
        last = types.SimpleNamespace(
            key=b.key, i=b.i, j=b.j, residual=residual,
            cols=torch.stack([dM * w, dM * b.heat * w, dM * w]))
        died = mass <= 0.
        b.mass, b.thickness, b.width, b.length = mass, T, W, L
        keep = ~died
        for name in vars(b):
            setattr(b, name, getattr(b, name)[keep])
        if lower:
            for name in ("uvel", "vvel", "axn", "ayn", "bxn", "byn", "mass",
                         "thickness", "width", "length", "heat", "scaling"):
                setattr(b, name, getattr(b, name).to(torch.bfloat16).to(F64))
        counts = dict(nbergs=b.lon.shape[0], nbergs_calved=calved,
                      nbergs_melted=int(died.sum()))
        return spread(g, frc, b, s), counts, last, pg

    def budgets(self):
        b = self.b
        return dict(nbergs=float(b.lon.shape[0]),
                    mass=float((b.mass * b.scaling).sum()),
                    heat=float((b.mass * b.scaling * b.heat).sum()),
                    mass_of_bits=0., stored_ice=float(self.stored.sum()),
                    stored_heat=0.)

    def snapshot(self):
        """The state as ``entries.answers.state`` gives a judged
        side's."""
        b = self.b
        h = (lambda v: v.detach().cpu().numpy())
        rows = {k: h(getattr(b, k)) for k in ROW_FIELDS}
        rows.update(key=h(b.key), i=h(b.i), j=h(b.j),
                    mass_scaling=h(b.scaling), heat_density=h(b.heat))
        return dict(bergs=rows, stored=h(self.stored),
                    counter=h(self.counter))

    def load(self, snap):
        """Start from a judged side's state (``entries.answers.state``)."""
        dev = self.stored.device
        r = snap["bergs"]

        def t(v, dtype=F64):
            return torch.as_tensor(v).to(dev, dtype)
        z = torch.zeros(len(r["key"]), dtype=F64, device=dev)
        self.b = types.SimpleNamespace(
            key=t(r["key"], torch.long), i=t(r["i"], torch.long),
            j=t(r["j"], torch.long), scaling=t(r["mass_scaling"]),
            heat=t(r["heat_density"]),
            **{k: t(r[k]) for k in ROW_FIELDS}, uo=z, vo=z, ua=z, va=z,
            sst=z)
        self.stored = t(snap["stored"])
        self.counter = t(snap["counter"], torch.long)

    def answer_bergs(self):
        b = self.b
        h = (lambda v: v.detach().cpu().numpy())
        floats = {k: h(getattr(b, k)) for k in ROW_FIELDS
                  if k not in ("xi", "yj")}
        floats["mass_scaling"] = h(b.scaling)
        floats["heat_density"] = h(b.heat)
        return dict(key=h(b.key), ine=h(b.i), jne=h(b.j), fx=h(b.i + b.xi),
                    fy=h(b.j + b.yj), floats=floats)

    def outputs(self, out, last):
        """A step's coupler fields, and the melt each berg handed its
        cell (summed where the judged side puts the berg)."""
        h = (lambda v: v.detach().cpu().numpy())
        g = self.grid
        return dict(coupler={k: h(v) for k, v in out.items()},
                    cell_melt=dict(key=h(last.key), i=h(last.i),
                                   j=h(last.j), cols=h(last.cols),
                                   residual=h(last.residual),
                                   wet=h((g.msk > 0.).to(F64)),
                                   names=("floating_melt", "calving_hflx",
                                          "berg_melt"),
                                   shape=(g.nx + 2, g.ny + 2)))


def _key(id_ij, id_cnt):
    return (id_ij.long() << KEY) | (id_cnt.long() & 0xffffffff)


def run(x, conf, world, steps, device, lower=False, judged=None):
    """The reference's episode of ``steps`` coupling steps from the
    inputs ``x``: its counts a step, its last budgets and, for the
    metric readers, its contacts a step where contacts are on (and, with
    ``lower``, its own answer, as a judged side's); and,
    given the ``judged`` side's answer, the reference's step from the
    state that side's last step started from (``step``, and that state
    as ``step0``)."""
    model = Model(x, conf, world, device)
    counts, contacts = {}, []
    for k in range(steps):
        if k == steps - 1:
            before = model.snapshot()
        out, c, last, pg = model.step(lower=lower)
        for name, v in c.items():
            counts.setdefault(name, []).append(v)
        if model.s.interactive_icebergs_on:
            contacts.append(dict(engaged=int(pg.a.numel()),
                                 partners=int(torch.unique(pg.b).numel())))
    ans = dict(counts=counts, budgets=model.budgets())
    if model.s.interactive_icebergs_on:
        ans["readers"] = dict(contacts=contacts)
    if lower:
        ans["own"] = dict(bergs=model.answer_bergs(), counts=counts,
                          budgets=model.budgets(), overflow=0,
                          before=before, **model.outputs(out, last))
    if judged is not None:
        one = Model(x, conf, world, device)
        one.load(judged["before"])
        ans["step0"] = one.answer_bergs()
        out, _, last, _ = one.step()
        ans["step"] = dict(bergs=one.answer_bergs(),
                           **one.outputs(out, last))
    return ans

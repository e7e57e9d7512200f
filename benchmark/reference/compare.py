"""The comparison that decides ``correct``, bergs matched by id.

The judged side's last step of the episode is held against the
reference's step from the state that step started from: KID's default
interpolation (``old_bug_bilin``) jumps at cell edges, so over an
episode a berg that one rounding puts across an edge on one side and
not the other drifts apart by far more than the rounding; from a common
state only the last cell of such a berg can differ.  The step counters
and budgets are held against the reference's own episode from the seed.

- ``rows_differ``: live ids on one side only, and matched bergs whose
  cell on the judged side does not hold the reference's position (to
  within ``EDGE`` of a cell: a berg on a cell's edge may fall either
  way by a rounding).
- ``motion_gap``: the positions (the distance between the two sides'
  places, in metres) and velocities, the largest gap between the two
  sides as a share of how far the reference moved it in the step (the
  farthest berg's displacement; the largest change of a velocity).
- ``state_gap``: the same over every other float field the reference
  keeps, a field that hardly moved scaled by 1e-5 of its largest
  magnitude.
- ``coupler_gap``: the last step's coupler fields (the per-cell averages
  weighted by the cell's berg area), the largest gap as a share of the
  field's largest magnitude.  The melt a berg hands the ocean lands in
  its cell on the judged side (see ``rows_differ``).
- ``counts_differ``: the episode's step counters (spawns, melted
  bergs, live bergs), the summed gaps.
- ``budget_gap``: the budgets at the episode's end, the largest relative
  gap.
- ``overflow``: the port's own drops past a cap (the exact fallback,
  the spawns): the configuration guarantees none.
"""

import math

import numpy as np

FLOOR = 1e-5      # of a field's largest magnitude: the scale of a still field
TINY = 1e-30
EDGE = 1e-3       # of a cell
METRES_PER_DEGREE = math.pi / 180. * 6360000.0
MOTION = ("uvel", "vvel")
# coupler fields that are per-cell averages over the bergs in the cell
RATIO = ("spread_uvel", "spread_vvel", "ustar_iceberg")


def _gap(p, r):
    p, r = p.astype(np.float64), r.astype(np.float64)
    d = np.abs(p - r)
    pn, rn = np.isnan(p), np.isnan(r)
    d[pn & rn] = 0.
    d[pn != rn] = np.inf
    return float(d.max(initial=0.))


def _absmax(x):
    x = x.astype(np.float64)
    return float(np.abs(x[np.isfinite(x)]).max(initial=0.))


def unique_keys(b):
    """The rows' keys made unique: the id scheme can give two bergs of
    different classes spawned in one cell the same id, so the k-th row of
    one id, in order of start mass and birth place, gets k in the bits
    above the id's 53."""
    key, f = b["key"], b["floats"]
    order = np.lexsort((f["start_lat"], f["start_lon"], f["start_mass"],
                        key))
    ks = key[order]
    first = np.searchsorted(ks, ks)
    occ = np.empty_like(key)
    occ[order] = np.arange(len(ks)) - first
    return key | (occ << 53)


def bergs(p, r, r0):
    """``(rows_differ, motion_gap, state_gap, worst field)``."""
    common, ip, ir = np.intersect1d(unique_keys(p), unique_keys(r),
                                    assume_unique=True, return_indices=True)
    rows = len(p["key"]) + len(r["key"]) - 2 * len(common)
    fx, fy = r["fx"][ir], r["fy"][ir]
    pi, pj = p["ine"][ip], p["jne"][ip]
    rows += int(((fx < pi - EDGE) | (fx > pi + 1 + EDGE)
                 | (fy < pj - EDGE) | (fy > pj + 1 + EDGE)).sum())
    _, a, b = np.intersect1d(common, unique_keys(r0), assume_unique=True,
                             return_indices=True)
    rf = r["floats"]
    moved = _metres(rf["lon"][ir][a], rf["lat"][ir][a], r0["floats"]["lon"][b],
                    r0["floats"]["lat"][b])
    gaps = _metres(p["floats"]["lon"][ip], p["floats"]["lat"][ip],
                   rf["lon"][ir], rf["lat"][ir])
    motion = gaps.max(initial=0.) / max(moved.max(initial=0.), TINY)
    worst, gap = None, 0.
    for name, rv in rf.items():
        if name in ("lon", "lat"):
            continue
        pv = p["floats"].get(name)
        if pv is None:
            return rows, np.inf, np.inf, name
        pv, rv = pv[ip], rv[ir]
        scale = FLOOR * _absmax(rv)
        if name in r0["floats"] and len(a):
            moved = rv[a].astype(np.float64) - r0["floats"][name][b]
            scale = max(scale, _absmax(moved))
        g = _gap(pv, rv) / max(scale, TINY)
        if name in MOTION:
            motion = max(motion, g)
        elif worst is None or g > gap:
            worst, gap = name, g
    return rows, motion, gap, worst


def _metres(lon1, lat1, lon2, lat2):
    """Distances between places, in metres (the lat-lon metric at the
    mean latitude)."""
    lat1, lat2 = lat1.astype(np.float64), lat2.astype(np.float64)
    dx = (lon1.astype(np.float64) - lon2) * np.cos(
        np.radians(0.5 * (lat1 + lat2))) * METRES_PER_DEGREE
    dy = (lat1 - lat2) * METRES_PER_DEGREE
    return np.hypot(dx, dy)


def coupler(ans, judged):
    """An answer's coupler fields.  Where it gives its last step's melt
    a berg (``cell_melt``: the reference's, and the control's), the melt
    fields are its sums over the cells the bergs of ``judged`` hold (its
    own cell for a berg ``judged`` lacks), and the residual calving plus
    the melt over the ocean."""
    c = dict(ans["coupler"])
    m = ans.get("cell_melt")
    if m is None:
        return c
    i, j = m["i"].copy(), m["j"].copy()
    keys = judged["key"]
    if len(keys):
        order = np.argsort(keys, kind="stable")
        at = np.clip(np.searchsorted(keys[order], m["key"]), 0,
                     len(keys) - 1)
        found = keys[order][at] == m["key"]
        i[found] = judged["ine"][order][at][found]
        j[found] = judged["jne"][order][at][found]
    for name, col in zip(m["names"], m["cols"]):
        out = np.zeros(m["shape"])
        np.add.at(out, (i + 1, j + 1), col)
        c[name] = out
    c["calving"] = m["residual"] + c["floating_melt"] * m["wet"]
    return c


def _weighted(c, name):
    """A coupler field as the ocean takes it in: the per-cell averages
    (velocities, ustar) times the cell's berg area, so that a cell that
    holds a sliver of one berg weighs as little as it does there."""
    v = c.get(name)
    if v is None or name not in RATIO or "spread_area" not in c:
        return v
    return v.astype(np.float64) * c["spread_area"]


def numbers(p, ref):
    """The numbers compared, by name, and the worst fields: the judged
    side's last step against the reference's step from the same state
    (``ref["step"]``, ``ref["step0"]``); its counters and budgets against
    the reference's own episode."""
    step = ref["step"]
    rows, motion, state, worst = bergs(p["bergs"], step["bergs"],
                                       ref["step0"])
    pc, rc = coupler(p, p["bergs"]), coupler(step, p["bergs"])
    cworst, cgap = None, 0.
    for name in rc:
        rv, pv = _weighted(rc, name), _weighted(pc, name)
        g = np.inf if pv is None else _gap(pv, rv) / max(_absmax(rv), TINY)
        if cworst is None or g > cgap:
            cworst, cgap = name, g
    counts = 0.
    for name, rv in ref["counts"].items():
        pv = p["counts"].get(name)
        if pv is None or len(pv) != len(rv):
            counts = np.inf
            break
        counts += float(np.abs(np.subtract(pv, rv, dtype=np.float64)).sum())
    budget = max((abs(p["budgets"].get(n, np.inf) - v) / max(abs(v), TINY)
                  for n, v in ref["budgets"].items()), default=0.)
    nums = dict(rows_differ=rows, motion_gap=motion, state_gap=state,
                coupler_gap=cgap, counts_differ=counts, budget_gap=budget,
                overflow=p["overflow"])
    return nums, dict(state=worst, coupler=cworst)

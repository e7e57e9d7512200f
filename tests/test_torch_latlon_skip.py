"""K2's and K5's lat-lon skips, in float32 on the CPU: the lower bound of
r2 that ``csrc/latlon.cuh`` forms for a chunk of candidates (the warp's
box against the chunk's box) never exceeds the bound of each lane's pair
with a candidate (its own gaps, with the chunk's factor kx), which never
exceeds the plain metric's r2, so neither the chunk skip nor the
candidate skip (a warp vote over the lanes' bounds, with the group filter
outside each lane's own conglomerate) drops an engaged pair.  Both
kernels' chunk sizes are taken: 16 candidates without the group filter,
32 with it.

The bound's plain mirrors (``extract.latlon_kx``, ``extract.gap2_metric``)
take the kernel's operations in its order; the pairs are measured by the
plain metric (``grid.pair_separation``, the mean latitude's cosine).  The
worlds are seeded: a warp's box of 32 bergs and a chunk of 16 or 32
candidates per trial, in latitude bands from 89.9 S to 89.9 N, with boxes that shrink
to one point and candidates straight north or east of it (where the bound
meets r2), and radii that put each pair's threshold crit^2 * slack within
an ulp of its r2.
"""

import numpy as np
import pytest
import torch

from icebergs_tpu_torch.grid import pair_separation
from icebergs_tpu_torch.ops import extract

REARTH = 6360000.
BANDS = (-89.9, -75., -52.5, -10., 0., 33., 70., 89.9)


def _trials(lat0, ch, n=1500, seed=0):
    """Per trial: the warp's 32 bergs and the chunk's ``ch`` candidates
    (float32 lon, lat) near latitude ``lat0``; a third of the warps sit on
    one point, and their candidates lie straight north, south, east or
    west of it."""
    rng = np.random.RandomState(seed + int(abs(lat0) * 10))
    h = rng.choice([1e-4, 1e-2, 0.3, 2.], size=(n, 1))
    lat_c = np.clip(lat0 + rng.uniform(-1, 1, (n, 1)) * h, -89.9, 89.9)
    lon_c = rng.uniform(-180., 180., (n, 1))
    lat1 = np.clip(lat_c + rng.uniform(-1, 1, (n, 32)) * h, -89.9, 89.9)
    lon1 = lon_c + rng.uniform(-1, 1, (n, 32)) * h
    point = rng.uniform(size=(n, 1)) < 1 / 3
    lat1 = np.where(point, lat1[:, :1], lat1)
    lon1 = np.where(point, lon1[:, :1], lon1)
    d = rng.uniform(-3, 3, (n, ch)) * h * rng.choice(
        [1e-3, 0.1, 1.], size=(n, ch))
    north = rng.uniform(size=(n, ch)) < 0.5
    lat2 = np.where(point & north, lat1[:, :1] + d,
                    lat_c + rng.uniform(-2, 2, (n, ch)) * h)
    lon2 = np.where(point & north, lon1[:, :1],
                    lon_c + rng.uniform(-2, 2, (n, ch)) * h)
    lat2 = np.where(point & ~north, lat1[:, :1], lat2)
    lon2 = np.where(point & ~north, lon1[:, :1] + d, lon2)
    lat2 = np.clip(lat2, -89.9, 89.9)
    f = [torch.from_numpy(a.astype(np.float32))
         for a in (lon1, lat1, lon2, lat2)]
    return f


def _bounds(lon1, lat1, lon2, lat2):
    """(chunk bound (n, 1), each lane's pair bound (n, 32, ch), r2 (n,
    32, ch)), as the kernels form them."""
    zero = torch.zeros(())
    wlo_x, whi_x = lon1.amin(1, keepdim=True), lon1.amax(1, keepdim=True)
    wlo_y, whi_y = lat1.amin(1, keepdim=True), lat1.amax(1, keepdim=True)
    clo_x, chi_x = lon2.amin(1, keepdim=True), lon2.amax(1, keepdim=True)
    clo_y, chi_y = lat2.amin(1, keepdim=True), lat2.amax(1, keepdim=True)
    kx = extract.latlon_kx(torch.maximum(wlo_y.abs(), whi_y.abs()),
                           torch.maximum(clo_y.abs(), chi_y.abs()), REARTH)

    def gaps(lo_a, hi_a, lo_b, hi_b):
        return torch.maximum(torch.maximum(lo_b - hi_a, lo_a - hi_b), zero)
    chunk = extract.gap2_metric(gaps(wlo_x, whi_x, clo_x, chi_x),
                                gaps(wlo_y, whi_y, clo_y, chi_y), kx, REARTH)
    pair = extract.gap2_metric(
        (lon1[:, :, None] - lon2[:, None, :]).abs(),
        (lat1[:, :, None] - lat2[:, None, :]).abs(), kx[:, :, None], REARTH)
    rx, ry = pair_separation(lon1[:, :, None], lat1[:, :, None],
                             lon2[:, None, :], lat2[:, None, :], True,
                             REARTH)
    return chunk, pair, rx * rx + ry * ry


@pytest.mark.parametrize("ch", [16, 32])
@pytest.mark.parametrize("lat0", BANDS)
def test_candidate_bound_below_r2(lat0, ch):
    """Every pair's r2 is at least its own bound, which is at least the
    chunk's; the pair bound meets r2 on straight-line pairs."""
    lon1, lat1, lon2, lat2 = _trials(lat0, ch)
    chunk, pair, r2 = _bounds(lon1, lat1, lon2, lat2)
    assert r2.dtype == pair.dtype == chunk.dtype == torch.float32
    assert bool((pair <= r2).all())
    assert bool((chunk[:, :, None] <= pair).all())
    assert int((chunk[:, :, None] == r2).sum()) > 100
    assert int((pair == r2).sum()) > 1000


@pytest.mark.parametrize("ch,group", [(16, False), (32, True)],
                         ids=["ch16", "ch32_group"])
@pytest.mark.parametrize("lat0", BANDS)
@pytest.mark.parametrize("cd", [0., 50.])
def test_candidate_skip_keeps_engaged_pairs_at_threshold(lat0, cd, ch,
                                                         group):
    """Radii chosen so that crit^2 * slack lies within an ulp of r2 for
    each candidate's pair with lane 0: a lane that engages a candidate (r2
    > 0 and r2 <= crit^2 * slack, crit = max(R1 + R2, cd), with ``group``
    outside its own conglomerate) always votes that it may (its bound <=
    crit^2 * slack, the same group test), so the warp never skips it."""
    lon1, lat1, lon2, lat2 = _trials(lat0, ch, seed=1)
    _, pair, r2 = _bounds(lon1, lat1, lon2, lat2)
    slack = torch.tensor(extract._SLACK, dtype=torch.float32)
    n = lon1.shape[0]
    rng = np.random.RandomState(2)
    R1 = torch.from_numpy(rng.uniform(0.2, 0.6, (n, 32)).astype(
        np.float32)) * torch.sqrt(r2[:, :1, :].amax(2).clamp(min=1.))
    R1[:, 0] = R1[:, 1:].amax(1)
    # the candidate radius that sets lane 0's threshold at its r2, nudged
    # by -2 .. 2 ulps
    crit0 = torch.sqrt(r2[:, 0, :] / slack)
    nudge = torch.from_numpy(rng.randint(-2, 3, (n, ch)))
    for _ in range(2):
        up, down = nudge > 0, nudge < 0
        crit0 = torch.where(up, torch.nextafter(crit0, torch.tensor(
            float("inf"))), crit0)
        crit0 = torch.where(down, torch.nextafter(crit0, torch.tensor(
            0.)), crit0)
        nudge = nudge - up.long() + down.long()
    rad2 = crit0 - R1[:, :1]
    crit = torch.maximum(R1[:, :, None] + rad2[:, None, :],
                         torch.tensor(cd, dtype=torch.float32))
    thr = crit * crit * slack
    engaged = (r2 > 0.) & (r2 <= thr)
    dx = lon1[:, :, None] - lon2[:, None, :]
    dy = lat1[:, :, None] - lat2[:, None, :]
    may = ((dx != 0.) | (dy != 0.)) & (pair <= thr)
    if group:
        # conglomerate ids of the lanes and the candidates, a third shared
        other = torch.from_numpy(rng.randint(0, 3, (n, 32, 1))
                                 != rng.randint(0, 3, (n, 1, ch)))
        engaged &= other
        may &= other
    assert not bool((engaged & ~may).any())
    # a lane's own slot (equal coordinates) has r2 = 0: never engaged
    assert not bool((engaged & (dx == 0.) & (dy == 0.)).any())
    # the cases sit at the edge: lane 0's r2 within an ulp of its
    # threshold, on both sides, and some of them voted out
    ulp = torch.nextafter(thr[:, 0, :], torch.tensor(float("inf"))) \
        - thr[:, 0, :]
    edge = (r2[:, 0, :] - thr[:, 0, :]).abs() <= ulp
    assert int(edge.sum()) > 1000
    assert int((edge & engaged[:, 0, :]).sum()) > 100
    assert int((edge & ~engaged[:, 0, :]).sum()) > 100
    assert int((edge & ~may[:, 0, :]).sum()) > 100

"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests carry the ``cuda`` marker
and skip without a GPU.  On a machine with one:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(the conftest configures jax, which such a machine need not have).
"""

import types

import numpy as np
import pytest
import torch

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.grid import pair_separation
from icebergs_tpu_torch.ops import dem_substeps as k4
from icebergs_tpu_torch.ops import extract, forces, pack, prepass
from icebergs_tpu_torch.ops import interp_sorted as k6
from icebergs_tpu_torch.ops import segment_spread as ss
from icebergs_tpu_torch.ops import sorted as srt
from icebergs_tpu_torch.ops import thermo
from icebergs_tpu_torch.ops.fused_contact import contact_features
from icebergs_tpu_torch.ops.interp_table import interp_cell_table
from icebergs_tpu_torch.ops.pairs import eval_pair_ia_kernel

from torch_k2_boundary import k2_boundary_counts

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _world(device, n=20000, nx=64, dxy=2000., seed=0, cluster=0):
    """A sorted world; ``cluster`` bergs are put in one cell, (20, 30)."""
    cfg = ibp.IcebergsConfig(
        grid_is_latlon=False, Lx=-1.0, use_f_plane=True, lat_ref=45.0,
        dt=600.0, Runge_not_Verlet=False, interactive_icebergs_on=True,
        use_new_predictive_corrective=True)
    grid = ibp.make_uniform_grid(nx, nx, 0., 0., dxy, dxy,
                                 grid_is_latlon=False, device=device)
    frc = ibp.swirl_forcing(nx, nx, dxy, sst=4., sss=33., device=device)
    rng = np.random.RandomState(seed)
    lon = rng.uniform(2 * dxy, (nx - 2) * dxy, n)
    lat = rng.uniform(2 * dxy, (nx - 2) * dxy, n)
    lon[:cluster] = (20.5 + rng.uniform(-0.45, 0.45, cluster)) * dxy
    lat[:cluster] = (30.5 + rng.uniform(-0.45, 0.45, cluster)) * dxy
    st = ibp.create_bergs(n + 512, lon=lon, lat=lat, mass=7.65e8,
                          thickness=40., width=150., length=150.,
                          device=device)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    st, cs = srt.sort_state_by_cell(st.replace(ine=i, jne=j, xi=xi, yj=yj),
                                    grid)
    return cfg, grid, frc, st, cs


def test_permute_kernel_bitwise(dev):
    g = torch.Generator(device="cpu").manual_seed(0)
    R = torch.randint(-2**31, 2**31 - 1, (37, 5003), generator=g,
                      dtype=torch.int32).to(dev)
    for idx in (torch.randperm(5003, generator=g),
                torch.randint(0, 5003, (9001,), generator=g)):
        idx = idx.to(torch.int32).to(dev)
        before = pack.permute_cols_u32.launches
        out = pack.permute_cols_u32(R, idx)
        assert pack.permute_cols_u32.launches == before + 1
        assert torch.equal(out, pack.permute_cols_u32_plain(R, idx))


def _k1_columns(g, dev, C, nsrc):
    """C int32 columns as K1's callers hand them over: 1-D tensors, the
    strided columns of a 2-D leaf, and None (zeros) for every fifth."""
    R = torch.randint(-2**31, 2**31 - 1, (C, nsrc), generator=g,
                      dtype=torch.int32).to(dev)
    leaf = R[:3].T.contiguous()                      # (nsrc, 3)
    cols = [leaf[:, b] for b in range(leaf.shape[1])]
    cols += [None if c % 5 == 4 else R[c] for c in range(3, C)]
    return cols


@pytest.mark.parametrize("C", [2, 16, 49, 89, 150])
@pytest.mark.parametrize("pattern", ["random", "near_identity",
                                     "table_sorted", "table_unsorted",
                                     "dead"])
def test_permute_entries_bitwise(dev, C, pattern):
    """Every K1 entry bitwise against its plain version at each index
    pattern the paths give it: a random order, a near-identity order (the
    persistent re-sort), cell keys into a table, sorted and unsorted, and
    dead keys (idx == nsrc reads 0)."""
    g = torch.Generator(device="cpu").manual_seed(C)
    n = 70_001
    nsrc = 5_003 if pattern.startswith("table") else n
    cols = _k1_columns(g, dev, C, nsrc)
    if pattern == "random":
        idx = torch.randperm(n, generator=g)
    elif pattern == "near_identity":
        idx = torch.arange(n)
        sw = torch.randint(0, n - 40, (n // 50,), generator=g)
        d = torch.randint(1, 40, (n // 50,), generator=g)
        idx[sw], idx[sw + d] = idx[sw + d].clone(), idx[sw].clone()
    elif pattern == "table_unsorted":
        idx = torch.randint(0, nsrc + 1, (n,), generator=g)
    elif pattern == "table_sorted":
        idx = torch.randint(0, nsrc + 1, (n,), generator=g).sort().values
    else:
        idx = torch.where(torch.rand(n, generator=g) < 0.3, nsrc,
                          torch.randperm(n, generator=g))
    idx = idx.to(torch.int32).to(dev)
    ref = pack.permute_cols_u32_plain(cols, idx)
    before = pack.permute_cols_u32.launches
    assert torch.equal(pack.permute_cols_u32(cols, idx), ref)
    assert pack.permute_cols_u32.launches == before + -(-C // 128)
    assert torch.equal(pack.permute_cols_u32(cols, idx, via_rows=True), ref)
    if C <= 128:
        before = (pack.pack_rows_u32.launches, pack.gather_rows_u32.launches)
        T = pack.pack_rows_u32(cols)
        assert torch.equal(T, pack.pack_rows_u32_plain(cols))
        out = pack.gather_rows_u32(T, idx)
        assert (pack.pack_rows_u32.launches,
                pack.gather_rows_u32.launches) == (before[0] + 1,
                                                   before[1] + 1)
        assert torch.equal(out, ref)
        assert torch.equal(out, pack.gather_rows_u32_plain(T, idx))
        # rows of a wider table (strided rows: ldt > C)
        W = torch.cat([T, T[:, :3]], dim=1)[:, :C]
        assert torch.equal(pack.gather_rows_u32(W, idx), ref)


def _k2_world(dev, n=16_000, nx=40, dxy=1000., seed=0):
    """A sorted feature slab built to defeat K2's chunk culling: radii up
    to 1.5 cells, bergs on cell edges, pairs placed one ulp inside, on and
    outside crit*crit*slack, dead and fl_k == -1 rows, and conglomerate
    ids shared by neighbours.  Returns (PT, key_s, cell_starts, grid)."""
    from types import SimpleNamespace
    rng = np.random.RandomState(seed)
    lon = rng.uniform(0., nx * dxy, n).astype(np.float32)
    lat = rng.uniform(0., nx * dxy, n).astype(np.float32)
    # radii above a cell west of 10 km, small ones elsewhere
    rad = np.where((rng.uniform(size=n) < 0.2) & (lon < 10 * dxy),
                   rng.uniform(500., 1500., n),
                   rng.uniform(20., 150., n)).astype(np.float32)
    # every tenth berg on a cell edge
    e = np.arange(0, n, 10)
    lon[e] = (np.floor(lon[e] / dxy) * dxy).astype(np.float32)
    # boundary pairs: berg k + 1 at rx = d (exact: both lons on the 2^-8
    # grid) east of berg k, and R2 chosen so that crit*crit*slack equals
    # d*d where a float R2 gives it; then a third moved 2^-8 m out
    slack = np.float32(1. + 1e-6)
    b = np.arange(1, n - 1, 7)
    b = b[lon[b] < (nx - 4) * dxy]
    lon[b] = np.floor(lon[b])
    d = (np.floor(np.sqrt((rad[b] + rad[b + 1]).astype(np.float64) ** 2)
                  * 256.) / 256.).astype(np.float32)
    target = d * d
    r2_est = (np.sqrt(target.astype(np.float64) / float(slack))
              - rad[b]).astype(np.float32)
    cand = (r2_est.view(np.int32)[:, None]
            + np.arange(-8, 9, dtype=np.int32)[None]).view(np.float32)
    crit = rad[b][:, None] + cand
    thr = crit * crit * slack
    pick = np.abs(thr.astype(np.float64) - target[:, None]).argmin(1)
    rad[b + 1] = cand[np.arange(b.size), pick]
    out = rng.uniform(size=b.size) < 1. / 3.
    lon[b + 1] = lon[b] + d + np.where(out, np.float32(1. / 256.), 0.)
    lat[b + 1] = lat[b]
    i = np.clip((lon // dxy).astype(np.int64), 0, nx - 1)
    j = np.clip((lat // dxy).astype(np.int64), 0, nx - 1)
    alive = rng.uniform(size=n) > 0.03
    key = np.where(alive, j * nx + i, nx * nx)
    order = np.argsort(key, kind="stable")
    PT = np.zeros((extract.PT_NF, n), np.float32)
    PT[extract.PT_LON], PT[extract.PT_LAT] = lon, lat
    for r in (extract.PT_U, extract.PT_V, extract.PT_AREA, extract.PT_MASS):
        PT[r] = rng.standard_normal(n)
    PT[extract.PT_RAD] = rad
    PT[extract.PT_ALIVE] = alive
    PT[extract.PT_KEY] = key
    PT[extract.PT_GRP] = rng.randint(0, 3, n) + (np.arange(n) // 50) * 3
    PT[extract.PT_FLK] = np.where(rng.uniform(size=n) < 0.02, -1., 0.)
    PT = torch.as_tensor(np.ascontiguousarray(PT[:, order])).to(dev)
    key_s = torch.as_tensor(key[order].astype(np.int32)).to(dev)
    cs = srt.starts_from_sorted_key(key_s, nx * nx)
    return PT, key_s, cs, SimpleNamespace(nx=nx, ny=nx)


def _k2_boundary_world(dev, block_n, radius, latlon, nx=64, ny=16, seed=0):
    """The slab of :func:`k2_boundary_counts` at window width 4 *
    ``block_n``, then a dead tail of at least 2 * ``block_n`` rows that
    leaves N % block_n != 0 and fills an all-dead block; bergs placed at
    random inside their cells (1 km cells, or 0.01 degree from 30 E, 60 S
    on a lat-lon grid), radii 50-300 m, dead, fl_k == -1 rows and shared
    conglomerate ids.  Returns (PT, key_s, cell_starts, grid, window,
    blocks)."""
    from types import SimpleNamespace
    wl = 4 * block_n
    counts, blocks = k2_boundary_counts(nx, ny, block_n, radius, wl, seed)
    live = int(counts.sum())
    ndead = 2 * block_n + 37
    ndead += (live + ndead) % block_n == 0
    n = live + ndead
    ncells = nx * ny
    rng = np.random.RandomState(seed)
    key = np.concatenate([np.repeat(np.arange(ncells), counts),
                          np.full(ndead, ncells)])
    x = key % nx + rng.uniform(0.05, 0.95, n)
    y = key // nx + rng.uniform(0.05, 0.95, n)
    PT = np.zeros((extract.PT_NF, n), np.float32)
    PT[extract.PT_LON], PT[extract.PT_LAT] = (
        (30. + 0.01 * x, -60. + 0.01 * y) if latlon else (1e3 * x, 1e3 * y))
    for r in (extract.PT_U, extract.PT_V, extract.PT_AREA):
        PT[r] = rng.standard_normal(n)
    PT[extract.PT_MASS] = rng.uniform(1e7, 1e9, n)
    PT[extract.PT_RAD] = rng.uniform(50., 300., n)
    PT[extract.PT_ALIVE] = (key < ncells) & (rng.uniform(size=n) > 0.03)
    PT[extract.PT_KEY] = key
    PT[extract.PT_GRP] = rng.randint(0, 3, n) + (np.arange(n) // 50) * 3
    PT[extract.PT_FLK] = np.where(rng.uniform(size=n) < 0.02, -1., 0.)
    window = wl - 200
    assert extract.window_lanes(window) == wl
    key_s = torch.as_tensor(key.astype(np.int32)).to(dev)
    return (torch.as_tensor(PT).to(dev), key_s,
            srt.starts_from_sorted_key(key_s, ncells),
            SimpleNamespace(nx=nx, ny=ny), window, blocks)


# K2's instantiations: (block_n, radius, group, variant, epilogue)
_K2_FORMS = {"fused3": (128, 1, False, None, False),
             "part1": (256, 2, True, None, False),
             "generic": (128, 1, False, "generic", False),
             "generic_group": (256, 2, True, "generic", False),
             "fused3_epi": (128, 1, False, None, True),
             "generic_epi": (128, 1, False, "generic", True)}


@pytest.mark.parametrize("latlon", [False, True], ids=["cartesian",
                                                      "latlon"])
@pytest.mark.parametrize("form", list(_K2_FORMS))
@pytest.mark.parametrize("world", ["culling", "boundary"])
def test_extract_kernel_builds_block_tables(dev, world, form, latlon):
    """Every K2 instantiation, Cartesian and lat-lon, builds its strips and
    bad flags in the kernel: the bad flags it writes equal
    ``block_tables``' and every output row the plain version's on those
    tables, bitwise (the epilogue's spring sums on rows with at most two
    exact pairs), one launch a call.  Worlds: ``_k2_world`` at window 288
    (on a lat-lon grid its metres read as 1e-5 degree from 30 E, 60 S) and
    one at each edge of the bad rule (``_k2_boundary_world``): window need
    exactly WL and WL + 1, a span of exactly nx - (2r+1) cells and one
    more, an all-dead block and a partial tail block."""
    from types import SimpleNamespace
    bn, radius, group, variant, epi = _K2_FORMS[form]
    if world == "boundary":
        PT, key_s, cs, grid, window, blocks = _k2_boundary_world(
            dev, bn, radius, latlon)
    else:
        PT, key_s, cs, grid = _k2_world(dev)
        window, blocks = 288, None
        if latlon:
            PT = PT.clone()
            PT[extract.PT_LON] = 30. + 1e-5 * PT[extract.PT_LON]
            PT[extract.PT_LAT] = -60. + 1e-5 * PT[extract.PT_LAT]
    rearth = 6360000.
    cfg = SimpleNamespace(contact_distance=0., grid_is_latlon=latlon,
                          Rearth=rearth, contact_spring_coef_eff=1e-8)
    before = (extract.extract_sorted.launches,
              extract.extract_sorted.epilogue_launches)
    out, bad_block = extract.extract_sorted(
        PT, key_s, cs, grid, cfg, block_n=bn, window=window, radius=radius,
        exclude_same_group=group, variant=variant, epilogue=epi)
    assert (extract.extract_sorted.launches,
            extract.extract_sorted.epilogue_launches) == (
        before[0] + (not epi), before[1] + epi)
    N = PT.shape[1]
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, bn,
                                           window, radius)
    assert torch.equal(bad_block,
                       bad[:, None].expand(-1, bn).reshape(-1)[:N])
    plain, nexact = extract.extract_sorted_plain(
        PT, cs, c_lo, c_hi, bad, bn, 0., exclude_same_group=group,
        epilogue=epi, spring=1e-8 if epi else 0., exact_counts=True,
        rearth=rearth if latlon else None)
    sums = [extract.EX_IAX, extract.EX_IAY] if epi else []
    rest = [r for r in range(extract.EX_NOUT) if r not in sums]
    assert torch.equal(out[rest], plain[rest])
    if epi:
        few = nexact <= 2
        assert torch.equal(out[sums][:, few], plain[sums][:, few])
    assert int((plain[extract.EX_CNT] > 0).sum()) > 100
    assert extract.kernel_config(bn, radius, group, variant, epilogue=epi,
                                 latlon=latlon)[0] == (
        form + ("_ll" if latlon else ""))
    if blocks is not None:
        flags = bad.cpu()
        assert [bool(flags[blocks[k]]) for k in ("wl", "wl+1", "span",
                                                 "span+1")] == [
            False, True, False, True]
        ncells = grid.nx * grid.ny
        assert N % bn and bool((key_s[::bn] == ncells).any())


@pytest.mark.parametrize("block_n,radius,group,variant", [
    (128, 1, False, None), (256, 2, True, None), (128, 1, False, "generic"),
    (256, 2, True, "generic"), (64, 1, False, None), (32, 2, True, None),
    (256, 1, False, None)])
@pytest.mark.parametrize("cd", [0., 2500.])
def test_extract_kernel_defeats_culling(dev, block_n, radius, group, variant,
                                        cd):
    """K2 bitwise against its plain version on a world where the chunk
    skip is tight: both compiled instantiations (BN 128 radius 1; BN 256
    radius 2 with the conglomerate filter), the generic one forced onto
    their shapes, and generic shapes, with crit set by the radii and by a
    contact_distance above R1 + R2."""
    from types import SimpleNamespace
    PT, key_s, cs, grid = _k2_world(dev)
    cfg = SimpleNamespace(contact_distance=cd, grid_is_latlon=False)
    before = extract.extract_sorted.launches
    out, bad_block = extract.extract_sorted(
        PT, key_s, cs, grid, cfg, block_n=block_n, window=1024,
        radius=radius, exclude_same_group=group, variant=variant)
    assert extract.extract_sorted.launches == before + 1
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny,
                                           block_n, 1024, radius)
    plain = extract.extract_sorted_plain(PT, cs, c_lo, c_hi, bad, block_n,
                                         cd, exclude_same_group=group)
    assert torch.equal(out, plain)
    assert int((plain[extract.EX_CNT] > 0).sum()) > 1000
    assert int(bad.sum()) < bad.numel() // 2
    compiled = {(128, 1, False): "fused3", (256, 2, True): "part1"}
    expect = None if variant else compiled.get((block_n, radius, group))
    assert extract.kernel_config(block_n, radius, group, variant)[0] == (
        expect or ("generic_group" if group else "generic"))


@pytest.mark.parametrize("window", [160, 16])
def test_extract_kernel_matches_plain(dev, window):
    cfg, grid, frc, st, cs = _world(dev)
    PT, key_s = contact_features(st, grid, cfg)
    out, bad_block = extract.extract_sorted(PT, key_s, cs, grid, cfg,
                                            block_n=128, window=window)
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, 128,
                                           window)
    plain = extract.extract_sorted_plain(PT, cs, c_lo, c_hi, bad, 128, 0.)
    assert torch.equal(out, plain)
    # at 160 only the block holding the dead tail is flagged
    assert int(bad.sum()) > 10 if window == 16 else int(bad.sum()) <= 1
    assert int((out[extract.EX_CNT] > 0).sum()) > 0


def _epi_inputs(dev, world):
    """(PT, key_s, cell_starts, grid, cfg) for K2's epilogue: the sparse
    sorted world of ``_world``, its first n rows, or the culling world
    of ``_k2_world`` (dense, radii up to 1.5 cells, boundary pairs)."""
    from types import SimpleNamespace
    if world == "dense":
        PT, key_s, cs, grid = _k2_world(dev)
        cfg = SimpleNamespace(contact_distance=0.,
                              contact_spring_coef_eff=1e-8,
                              grid_is_latlon=False)
        return PT, key_s, cs, grid, cfg
    cfg, grid, frc, st, cs = _world(dev)
    PT, key_s = contact_features(st, grid, cfg)
    if world != "sparse":
        n = int(world)
        PT, key_s = PT[:, :n].contiguous(), key_s[:n].contiguous()
        cs = srt.starts_from_sorted_key(key_s, grid.nx * grid.ny)
    return PT, key_s, cs, grid, cfg


@pytest.mark.parametrize("world", ["0", "1", "1000", "sparse", "dense"])
def test_extract_epilogue_kernel_matches_plain(dev, world):
    """K2's pair-epilogue instantiation against its plain version: every
    row but the spring sums bitwise, the spring sums bitwise on the rows
    with at most two exact pairs and within 1e-5 + 1e-6 of scale on the
    others, two calls bitwise, one launch a call counted apart from the
    search alone."""
    PT, key_s, cs, grid, cfg = _epi_inputs(dev, world)
    before = (extract.extract_sorted.launches,
              extract.extract_sorted.epilogue_launches)
    out, bad_block = extract.extract_sorted(PT, key_s, cs, grid, cfg,
                                            block_n=128, window=1024,
                                            epilogue=True)
    assert (extract.extract_sorted.launches,
            extract.extract_sorted.epilogue_launches) == (
        before[0], before[1] + 1)
    again, _ = extract.extract_sorted(PT, key_s, cs, grid, cfg,
                                      block_n=128, window=1024,
                                      epilogue=True)
    assert torch.equal(out, again)
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, 128,
                                           1024)
    plain, nexact = extract.extract_sorted_plain(
        PT, cs, c_lo, c_hi, bad, 128, 0., epilogue=True,
        spring=cfg.contact_spring_coef_eff, exact_counts=True)
    sums = [extract.EX_IAX, extract.EX_IAY]
    rest = [r for r in range(extract.EX_NOUT) if r not in sums]
    assert torch.equal(out[rest], plain[rest])
    few = nexact <= 2
    assert torch.equal(out[sums][:, few], plain[sums][:, few])
    a, b = out[sums][:, ~few], plain[sums][:, ~few]
    if b.numel():
        assert bool(((a - b).abs() <= 1e-5 * b.abs()
                     + 1e-6 * plain[sums].abs().max()).all())
    if world in ("sparse", "dense"):
        ex = out[extract.EX_F1 + 6]
        assert int((ex > 0).sum()) > 100
        assert bool((out[extract.EX_IAX][few] != 0).any())
    assert extract.kernel_config(128, 1, False, epilogue=True)[0] == (
        "fused3_epi")


@pytest.mark.parametrize("impl", ["gathered", "manual"])
def test_epilogue_runs_with_gathered_extraction_only(dev, impl):
    """``contact_epilogue`` launches the epilogue instantiation with the
    gathered extraction window only; with ``"manual"`` the search alone
    runs, as in the JAX package."""
    from icebergs_tpu_torch.ops.fused_contact import make_ia_fn_fused3
    cfg, grid, frc, st, cs = _world(dev)
    cfg = cfg.replace(contact_epilogue=True, extract_impl=impl)
    before = (extract.extract_sorted.launches,
              extract.extract_sorted.epilogue_launches)
    ia_fn, stats = make_ia_fn_fused3(st, grid, cfg, block_n=128,
                                     cell_starts=cs, fallback_cap=8192)
    ia = ia_fn(st.uvel, st.vvel)
    epi = impl == "gathered"
    assert (extract.extract_sorted.launches,
            extract.extract_sorted.epilogue_launches) == (
        before[0] + (not epi), before[1] + epi)
    assert int(stats.overflow) == 0
    assert bool(torch.isfinite(ia.IA_x).all())


def _pass_columns(n, ncols, seed):
    """(ncols, n) float32 columns for K3's pass-through: normal values,
    with -0.0 in every third column's every seventh row and, in every
    fourth column, each odd row the negation of the row before (sums that
    cancel exactly within a cell)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    M = torch.randn(ncols, n, generator=g)
    M[::3, ::7] = -0.0
    M[1::4, 1::2] = -M[1::4, 0:n - 1:2][:, :M[1::4, 1::2].shape[1]]
    return M


@pytest.mark.parametrize("ncols,K", [(43, 16), (16, 5), (7, 1), (57, 16),
                                     (100, 32), (43, 32)])
@pytest.mark.parametrize("tree", [True, False])
def test_segment_sums_assoc_kernel_matches_plain(dev, ncols, K, tree):
    """K3's pass-through (``segment_sums``, the slot-sum spreading's
    per-cell sums) bitwise against its plain version in the slot tree and
    sequentially, on a world with a 700-berg cell and dead rows, with
    -0.0 and exactly cancelling values, one launch a call."""
    cfg, grid, frc, st, cs = _world(dev, cluster=700)
    M = _pass_columns(st.capacity, ncols, ncols)
    cols = [c.to(dev) for c in M]
    before = ss.segment_sums.launches
    S = ss.segment_sums(cols, cs, K, tree)
    assert ss.segment_sums.launches == before + 1
    Sp = ss._sums_plain(torch.stack(cols), cs, K, tree)
    assert torch.equal(S, Sp)
    # -0.0 sums come out +0.0 on both sides
    assert torch.equal(S.view(torch.int32), Sp.view(torch.int32))
    assert int((cs[1:] - cs[:-1]).max()) >= 700
    assert int(cs[-1]) < st.capacity


@pytest.mark.parametrize("form", ["matrix", "matrix_view", "rows",
                                  "full_table"])
@pytest.mark.parametrize("tree", [True, False])
def test_segment_sums_column_forms(dev, form, tree):
    """K3's pass-through on the column forms its callers hand it, bitwise
    to the plain version in one launch: an (F, N) matrix (the
    ``"gather"`` methods' block sums, read by base and row stride), a view
    of a wider matrix (a row stride past N), the matrix's rows as a list
    (read by address), and as many separate columns as the kernel's
    address table holds."""
    cfg, grid, frc, st, cs = _world(dev, cluster=700)
    N = st.capacity
    ncols = ss.MAX_TABLE_COLS if form == "full_table" else 23
    M = _pass_columns(N + 5, ncols, 7).to(dev)
    if form == "matrix_view":
        cols = M[:, 3:N + 3]
    elif form == "full_table":
        cols = [c[:N].clone() for c in M]
    else:
        M = M[:, :N].contiguous()
        cols = M if form == "matrix" else list(M)
    before = ss.segment_sums.launches
    S = ss.segment_sums(cols, cs, 16, tree)
    assert ss.segment_sums.launches == before + 1
    ref = torch.stack(list(cols))
    assert torch.equal(S, ss._sums_plain(ref, cs, 16, tree))


@pytest.mark.parametrize("form", ["strided_column", "strided_matrix",
                                  "over_table"])
def test_segment_sums_refuses_forms_it_cannot_read(dev, form):
    """K3's pass-through raises, and launches nothing, on columns it does
    not read in place: a column of stride 2, a matrix whose columns are
    strided, and more separate columns than its address table holds."""
    cfg, grid, frc, st, cs = _world(dev)
    N = st.capacity
    if form == "over_table":
        cols = [c.clone() for c in _pass_columns(
            N, ss.MAX_TABLE_COLS + 1, 7).to(dev)]
    elif form == "strided_column":
        M = _pass_columns(2 * N, 3, 3).to(dev)
        cols = [M[0, ::2], M[1, :N], M[2, :N]]
    else:
        cols = _pass_columns(N, 3, 3).to(dev).T.contiguous().T
    before = ss.segment_sums.launches
    with pytest.raises(ValueError):
        ss.segment_sums(cols, cs, 16, True)
    assert ss.segment_sums.launches == before


def test_segment_spread_kernel_matches_plain(dev):
    cfg, grid, frc, st, cs = _world(dev)
    st2, melt = thermo.thermodynamics(st, grid, frc, cfg)
    _, rows = ss.build_rows(st2, grid, frc, cfg, melt.deferred_cols[:3],
                            key_alive=st.alive)
    rows = torch.stack(rows)
    tbl = ss.cell_tables(grid)
    S, bad = ss.segment_spread_sums(rows, cs, tbl, cfg, 3)
    assert not bool(bad.any())
    assert torch.equal(S, ss.segment_spread_sums_plain(rows, cs, tbl, cfg))


@pytest.mark.parametrize("n_extra", [3, 14, 9])
@pytest.mark.parametrize("window,K", [(None, 16), (128, 16), (128, 5),
                                      (128, 1)])
def test_segment_spread_kernel_associations(dev, n_extra, window, K):
    """K3 bitwise against its plain version in both associations on a
    clustered world: one cell holds 700 rows (more than K, and its CTA's
    rows more than a staging round), so the tree's slot K-1 and a cell
    spanning chunks are exercised.  The auto window takes the sequential
    sums, window 128 the slot tree (K = 5 pads the tree's odd levels,
    K = 1 is one slot); each compiled width (3, 14) and the generic one
    (9, and forced onto 3), the payload as a matrix and as a list."""
    cfg, grid, frc, st, cs = _world(dev, cluster=700)
    cfg = cfg.replace(reprod_max_per_cell=K)
    st2, melt = thermo.thermodynamics(st, grid, frc, cfg)
    _, rows = ss.build_rows(st2, grid, frc, cfg,
                            melt.deferred_cols[:n_extra], key_alive=st.alive)
    M = torch.stack(rows)
    tbl = ss.cell_tables(grid)
    assert int((cs[1:] - cs[:-1]).max()) >= 700
    before = ss.segment_spread_sums.launches
    S, bad, nbad = ss.segment_spread_sums_count(M, cs, tbl, cfg, n_extra,
                                                window=window)
    assert ss.segment_spread_sums.launches == before + 1
    assert int(nbad) == int(bad.sum())
    assert torch.equal(bad, ss.window_bad(cs, grid.nx * grid.ny,
                                          M.shape[1], 128, window))
    assert (int(nbad) > 0) == (window is not None)
    plain = ss.segment_spread_sums_plain(M, cs, tbl, cfg,
                                         tree=window is not None)
    assert torch.equal(S, plain)
    assert torch.equal(ss.segment_spread_sums(rows, cs, tbl, cfg, n_extra,
                                              window=window)[0], plain)
    if n_extra == 3:
        assert torch.equal(ss.segment_spread_sums(
            M, cs, tbl, cfg, 3, window=window, variant="generic")[0], plain)
    expect = {3: "extra3", 14: "extra14"}.get(n_extra, "generic")
    assert ss.kernel_config(n_extra, K)[0] == expect


@pytest.mark.parametrize("window", [160, 16])
def test_prepass_kernel_matches_plain(dev, window):
    """K5 against its plain version: exact, in bad blocks too, and the
    bad flags the kernel builds equal the TPU rule's (block_tables)."""
    cfg, grid, frc, st, cs = _world(dev)
    P, key_s = prepass.prepass_features(st, grid, cfg)
    before = prepass.contact_prepass_sorted.launches
    got = prepass.contact_prepass_sorted(P, key_s, cs, grid, cfg,
                                         block_n=128, window=window)
    assert prepass.contact_prepass_sorted.launches == before + 1
    c_lo, c_hi, bad = prepass.block_tables(key_s, cs, grid.nx, grid.ny, 128,
                                           window)
    ref = prepass.prepass_sorted_plain(P, cs, c_lo, c_hi, 128, window, 0.)
    for a, b in zip(got[:3], ref):
        assert torch.equal(a, b)
    assert torch.equal(got[3], bad[:, None].expand(-1, 128).reshape(-1)[
        :P.shape[0]])
    # K5's 8-aligned 160-row window is tight for 128-row blocks at ~5
    # bergs per cell: some blocks go bad at 160, nearly all at 16
    assert (int(bad.sum()) > 100 if window == 16
            else 0 < int(bad.sum()) < bad.numel())
    assert int((got[0] > 0).sum()) > 0


@pytest.mark.parametrize("block_n,radius,group,variant", [
    (128, 1, False, None), (128, 1, False, "generic"), (256, 2, True, None),
    (64, 1, False, None), (32, 2, True, None), (128, 2, False, None)])
@pytest.mark.parametrize("cd,window", [(0., 1024), (2500., 1024),
                                       (0., 40)])
def test_prepass_kernel_defeats_culling(dev, block_n, radius, group, variant,
                                        cd, window):
    """K5 bitwise against its plain version (counts, partner slots, bad
    flags) on K2's culling-adversarial world (radii above a cell, bergs on
    cell edges, pairs at exactly crit*crit*slack, dead and fl_k == -1
    rows, shared conglomerate ids): the compiled instantiation (BN 128,
    radius 1), the generic one forced onto it, generic shapes with and
    without the group filter, crit set by the radii and by a
    contact_distance above R1 + R2, and a 40-row window that truncates
    strips and flags blocks bad."""
    from types import SimpleNamespace
    PT, key_s, cs, grid = _k2_world(dev)
    P = torch.stack([PT[r] for r in (
        extract.PT_LON, extract.PT_LAT, extract.PT_RAD, extract.PT_FLK,
        extract.PT_ALIVE, extract.PT_KEY, extract.PT_GRP)]
        + [torch.zeros_like(PT[0])], dim=1).contiguous()
    cfg = SimpleNamespace(contact_distance=cd, grid_is_latlon=False)
    before = prepass.contact_prepass_sorted.launches
    got = prepass.contact_prepass_sorted(
        P, key_s, cs, grid, cfg, block_n=block_n, window=window,
        radius=radius, exclude_same_group=group, variant=variant)
    assert prepass.contact_prepass_sorted.launches == before + 1
    c_lo, c_hi, bad = prepass.block_tables(key_s, cs, grid.nx, grid.ny,
                                           block_n, window, radius)
    ref = prepass.prepass_sorted_plain(P, cs, c_lo, c_hi, block_n, window,
                                       cd, exclude_same_group=group)
    for a, b in zip(got[:3], ref):
        assert torch.equal(a, b)
    assert torch.equal(got[3], bad[:, None].expand(-1, block_n).reshape(-1)[
        :P.shape[0]])
    assert int((ref[0] > 0).sum()) > (1000 if window > 40 else 100)
    assert (int(bad.sum()) > bad.numel() // 2 if window == 40
            else int(bad.sum()) < bad.numel() // 2)
    expect = ("fused" if (block_n, radius, group, variant)
              == (128, 1, False, None)
              else "generic_group" if group else "generic")
    assert prepass.kernel_config(block_n, radius, group, variant)[0] == expect


@pytest.mark.parametrize("pmag", [True, False])
def test_pair_eval_kernel_matches_plain(dev, pmag):
    """K7 against forces.eval_pair_ia on the bucket tables: the sums are
    taken in another order (lanes and a shuffle tree), so within 1e-5
    relative plus 1e-6 of each field's scale; the spring sums pass
    through."""
    cfg, grid, frc, st, _ = _world(dev)
    cfg = cfg.replace(scale_damping_by_pmag=pmag)
    st = st.replace(uvel=st.uvel + 0.1, vvel=st.vvel - 0.05)
    nbr = forces.build_neighbor_tables(st, grid, cfg, max_per_cell=16)
    pd = forces.precompute_pair_data(st, cfg, nbr.cand_idx, nbr.cand_valid,
                                     partner_st=st)
    vel = (st.uvel, st.vvel, st.uvel * 0.9, st.vvel * 1.1)
    before = eval_pair_ia_kernel.launches
    got = eval_pair_ia_kernel(pd, cfg, *vel)
    assert eval_pair_ia_kernel.launches == before + 1
    ref = forces.eval_pair_ia(pd, cfg, *vel)
    assert int(pd.active.sum()) > 100
    assert torch.equal(got.IA_x, ref.IA_x)
    for f in ("P11", "P12", "P22", "Pu_x", "Pu_y"):
        a, b = getattr(got, f).cpu().numpy(), getattr(ref, f).cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max(), err_msg=f)


K7_SUMS = ("P11", "P12", "P22", "Pu_x", "Pu_y")


def _k7_pairs(dev, n, m, mask, seed=0):
    """Synthetic (n, m) pair slabs from numpy: projections of random unit
    normals, positive damping coefficients, partner velocities; every
    slot finite.  ``mask``: "le2" (at most two active pairs a row, at
    random slots), "all" (every pair active), "mixed" (rows of 0 to 12
    active pairs), "offset" ("mixed" with the mask stored one byte past
    a 16-byte boundary) or "bonds" (a bond table: a row's first 0 to m
    slots hold bonds, each active, as an over-stretched legacy bond is,
    with probability 1/2)."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(0., 2 * np.pi, (n, m))
    nx, ny = np.cos(th), np.sin(th)
    slab = {"P11": nx * nx, "P12": nx * ny, "P22": ny * ny,
            "crad": rng.uniform(1e-3, 1e-2, (n, m)),
            "ctan": rng.uniform(1e-4, 1e-3, (n, m)),
            "u2": rng.randn(n, m) * 0.2, "v2": rng.randn(n, m) * 0.2}
    if mask == "all":
        act = np.ones((n, m), bool)
    elif mask == "bonds":
        nb = rng.randint(0, m + 1, n)
        act = (np.arange(m)[None, :] < nb[:, None]) & (rng.rand(n, m) < .5)
    else:
        k = rng.randint(0, 3 if mask == "le2" else 13, n)
        act = rng.rand(n, m).argsort(1) < k[:, None]
    a = torch.as_tensor(act, device=dev)
    if mask == "offset":
        buf = torch.zeros(n * m + 16, dtype=torch.bool, device=dev)
        a = buf[1:1 + n * m].view(n, m)
        a.copy_(torch.as_tensor(act, device=dev))
    t = {f: torch.as_tensor(v.astype(np.float32), device=dev)
         for f, v in slab.items()}
    spring = [torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
              for _ in range(2)]
    pd = forces.PairData(a, *spring, **t)
    vel = [torch.as_tensor((rng.randn(n) * 0.2).astype(np.float32),
                           device=dev) for _ in range(4)]
    return pd, vel


# (M, mask): M 2305 takes tiles of 16 rows read in two 32 KB groups; its
# dense sums of 2305 terms would need a wider tolerance than K7's
_K7_SHAPES = [(m, mask) for m in (216, 144, 27)
              for mask in ("le2", "all", "mixed", "offset")] + [
    (2305, mask) for mask in ("le2", "mixed", "offset")]


@pytest.mark.parametrize("pmag", [True, False])
@pytest.mark.parametrize("m,mask", _K7_SHAPES)
@pytest.mark.parametrize("n", [0, 1, 1000])
def test_pair_eval_kernel_shapes(dev, n, m, mask, pmag):
    """K7 against its plain version at unaligned rows (M 216 and 144, odd
    M 27 and 2305), N of 0, 1 and not a multiple of the tile: bitwise on
    rows with at most two active pairs, within 1e-5 relative plus 1e-6 of
    each field's scale elsewhere (the sums' order); bitwise from run to
    run; contiguous fields; one launch a call (none at N = 0)."""
    cfg = ibp.IcebergsConfig(scale_damping_by_pmag=pmag)
    pd, vel = _k7_pairs(dev, n, m, mask)
    if mask == "offset" and n:
        assert pd.active.data_ptr() % 16 == 1
    before = eval_pair_ia_kernel.launches
    got = eval_pair_ia_kernel(pd, cfg, *vel)
    again = eval_pair_ia_kernel(pd, cfg, *vel)
    assert eval_pair_ia_kernel.launches == before + (2 if n else 0)
    ref = forces.eval_pair_ia(pd, cfg, *vel)
    assert got.IA_x is pd.IA_x and got.IA_y is pd.IA_y
    assert got.P21 is got.P12
    le2 = pd.active.sum(1) <= 2
    for f in K7_SUMS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.shape == (n,) and a.is_contiguous(), f
        assert torch.equal(a, getattr(again, f)), f
        assert torch.equal(a[le2], b[le2]), f
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-6 * (np.abs(b).max() if n else 0.),
            err_msg=f)
    if mask == "le2":
        assert bool(le2.all())
    elif n == 1000:
        assert int((~le2).sum()) > 500


@pytest.mark.parametrize("pmag", [True, False])
@pytest.mark.parametrize("m", [4, 6, 8])
@pytest.mark.parametrize("n", [1, 1000, 50_000])
def test_pair_eval_kernel_bond_widths(dev, n, m, pmag):
    """K7 at the bond table's widths (M = max_bonds: 4, 6 or 8) with bond
    masks: bitwise on rows with at most two active pairs, within 1e-5
    relative plus 1e-6 of each field's scale elsewhere, bitwise from run
    to run, one launch a call."""
    cfg = ibp.IcebergsConfig(scale_damping_by_pmag=pmag)
    pd, vel = _k7_pairs(dev, n, m, "bonds", seed=m)
    before = eval_pair_ia_kernel.launches
    got = eval_pair_ia_kernel(pd, cfg, *vel)
    again = eval_pair_ia_kernel(pd, cfg, *vel)
    assert eval_pair_ia_kernel.launches == before + 2
    ref = forces.eval_pair_ia(pd, cfg, *vel)
    le2 = pd.active.sum(1) <= 2
    for f in K7_SUMS:
        a, b = getattr(got, f), getattr(ref, f)
        assert torch.equal(a, getattr(again, f)), f
        assert torch.equal(a[le2], b[le2]), f
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max(), err_msg=f)
    if n == 50_000:
        assert int((~le2).sum()) > 1000


def test_interp_sorted_kernel_matches_plain(dev):
    """K6 against its plain version: bitwise (the same expressions, each
    operation rounded once on both sides)."""
    cfg, grid, frc, st, _ = _world(dev)
    ncells = grid.nx * grid.ny
    key = torch.where(st.alive, st.jne * grid.nx + st.ine,
                      ncells).to(torch.int32)
    tbl = interp_cell_table(grid, frc, cfg)
    before = k6.interp_sorted.launches
    rows = k6.interp_sorted(tbl, key, st.xi, st.yj, grid, cfg)
    assert k6.interp_sorted.launches == before + 1
    assert torch.equal(rows, k6.interp_sorted_plain(tbl, key, st.xi, st.yj,
                                                    cfg))


_ITEM15 = {
    "persistent_rk4_epilogue": (dict(Runge_not_Verlet=True,
                                     contact_epilogue=True), {}),
    "persistent_knobs_scatter": (dict(
        sort_packed_permute=False, pack_kernel=False,
        starts_via_scatter=True, slot_sum_method="scatter"), {}),
    "fused3_xla_noreprod": (dict(interp_mode="xla", parallel_reprod=False),
                            dict(persistent=False, neighbor_mode="fused3",
                                 with_class_melt=True)),
    "fused3_gather": (dict(slot_sum_method="gather",
                           reprod_max_per_cell=5),
                      dict(persistent=False, neighbor_mode="fused3"))}


def _bonded_world(dev, nx=32, dxy=2000., seed=5):
    """100 rafts of 4x4 bergs 140 m apart, bonded by radius
    (``initialize_bonds_host``, on the host), among 400 loose bergs, on
    the grid of :func:`_world`; dt 60 s for the legacy springs."""
    cfg, grid, frc, _, _ = _world(dev, n=16, nx=nx, dxy=dxy)
    cfg = cfg.replace(iceberg_bonds_on=True, dt=60.,
                      manually_initialize_bonds=True,
                      manually_initialize_bonds_from_radii=True)
    rng = np.random.RandomState(seed)
    org = rng.uniform(3 * dxy, (nx - 3) * dxy, (100, 2))
    k = np.arange(16)
    rafts = (org[:, None, :] + np.stack([k % 4, k // 4], 1)[None] * 140.
             ).reshape(-1, 2)
    pos = np.concatenate([rafts, rng.uniform(2 * dxy, (nx - 2) * dxy,
                                             (400, 2))])
    st = ibp.create_bergs(2560, lon=pos[:, 0], lat=pos[:, 1], mass=3.4e8,
                          thickness=40., width=100., length=100.,
                          uvel=rng.uniform(-.1, .1, len(pos)),
                          device=torch.device("cpu"))
    st = forces.initialize_bonds_host(st, cfg)
    i, j, xi, yj = ibp.pos_to_cell(grid.to("cpu"), st.lon, st.lat, -1.0)
    return cfg, grid, frc, st.replace(ine=i, jne=j, xi=xi, yj=yj).to(dev)


@pytest.mark.parametrize("path", ["persistent", "fused3", "fused",
                                  "buckets", "persistent_fused_kernel",
                                  "sorted", "bonded_fused3",
                                  "bonded_persistent", "footloose_fused3",
                                  "hexagons", "bonded_hexagons"]
                         + sorted(_ITEM15))
def test_step_on_card_matches_cpu(dev, path):
    """Two steps of each path on the card against the CPU (the plain
    versions): integers and counters exact, floats within the CPU parity
    tolerance.  ``hexagons``: chip_smoke.py phase 14a's flags, the fast
    lane with hexagonal elements (the slot sums' K3 pass-through, not
    K3); ``bonded_hexagons``: the same on bonded elements (hexagons
    oriented by their bonds)."""
    cfg, grid, frc, st, _ = _world(dev, n=5000, nx=32)
    cfg = cfg.replace(fused_fallback_cap=8192)
    kw = {}
    if path == "hexagons":
        cfg = cfg.replace(hexagonal_icebergs=True)
    elif path == "bonded_hexagons":
        cfg, grid, frc, st = _bonded_world(dev)
        cfg = cfg.replace(fused_fallback_cap=8192, hexagonal_icebergs=True)
        kw = dict(neighbor_mode="fused3")
    elif path == "sorted":
        kw = dict(persistent=False, neighbor_mode="sorted", max_per_cell=24)
    elif path in ("bonded_fused3", "bonded_persistent"):
        # per-step fused3, or the default route: the persistent lane,
        # which re-sorts the slab and remaps bond_idx every step
        cfg, grid, frc, st = _bonded_world(dev)
        cfg = cfg.replace(fused_fallback_cap=8192)
        kw = dict(neighbor_mode="fused3")
        if path == "bonded_fused3":
            kw.update(persistent=False)
    elif path == "footloose_fused3":
        # make_step's footloose branch (the default hash uniforms): the
        # primed bits become bergs, whose interactivity is then adjusted
        cfg = cfg.replace(footloose=True, fl_style="new_bergs",
                          fl_youngs=1.e8)
        k = torch.arange(st.capacity, device=dev)
        st = ibp.state.grow_capacity(st.replace(
            fl_k=torch.where(k % 3 == 0, 5e5, 0.),
            mass_of_fl_bits=torch.where(k % 7 == 1, 1.3e12, 0.)), 8192)
        kw = dict(persistent=False, neighbor_mode="fused3")
    elif path in _ITEM15:
        cfg = cfg.replace(**_ITEM15[path][0])
        kw = _ITEM15[path][1]
    elif path == "persistent_fused_kernel":
        cfg = cfg.replace(interp_mode="kernel")
        kw = dict(neighbor_mode="fused")
    elif path != "persistent":
        kw = dict(persistent=False, neighbor_mode=path)
        if path == "buckets":
            kw.update(max_per_cell=24)
    outs = []
    for d in (dev, torch.device("cpu")):
        s, ov, fb, _ = ibp.make_multi_step(grid.to(d), cfg, 2,
                                           with_stats=True, **kw)(
            st.to(d), frc.to(d))
        outs.append((ibp.to_numpy(s), int(ov), int(fb)))
    (g, gov, gfb), (c, cov, cfb) = outs
    assert (gov, gfb) == (cov, cfb) and gov == 0
    for name in ("alive", "id_cnt", "ine", "jne"):
        np.testing.assert_array_equal(g[name], c[name])
    live = g["alive"]
    if path == "footloose_fused3":
        assert live.sum() > int(st.count()), "no footloose berg was born"
    for name in ("lon", "lat", "uvel", "vvel", "mass"):
        a, b = g[name][live], c[name][live]
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=2e-5 * np.abs(b).max())


def _dem_cfg(**kw):
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
        allow_bergs_to_roll=False, max_bonds=6, hexagonal_icebergs=False,
        fused_fallback_cap=256)
    base.update(kw)
    return ibp.IcebergsConfig(**base).normalized(warn=False)


def _dem_world(cfg, jitter, units=6, side=5, gap=3.85e3, seed=3,
               block_n=128, max_bonds=6, hex_units=()):
    """``units`` bonded side x side conglomerates in a row, ``gap`` apart
    (beyond the bonding radius, inside the contact distance),
    on a 64 x 64 grid of 7 km cells, built on the CPU and packed into
    ``block_n``-slot blocks; random velocities and ocean depths.  The
    units in ``hex_units`` are hexagonally packed (up to six bonds an
    element, so slots 4-5 are used in their warps only); the others bond
    through at most four slots."""
    r, dxy = 1500.0, 7000.0
    rng = np.random.RandomState(seed)
    ix, iy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    ix, iy = ix.ravel(), iy.ravel()
    pitch = 2 * r * (side - 1) + gap
    lon, lat = [], []
    for u in range(units):
        if u in hex_units:
            px, py = ix * r * np.sqrt(3.), iy * 2 * r + (ix % 2) * r
        else:
            px, py = ix * 2 * r, iy * 2 * r
        lon.append(px + 2 * dxy + u * pitch)
        lat.append(py + 2 * dxy)
    lon, lat = np.concatenate(lon), np.concatenate(lat)
    n = lon.size
    lon = lon + rng.uniform(-jitter, jitter, n)
    lat = lat + rng.uniform(-jitter, jitter, n)
    cpu = torch.device("cpu")
    grid = ibp.make_uniform_grid(64, 64, 0., 0., dxy, dxy,
                                 grid_is_latlon=False, device=cpu)
    frc = ibp.uniform_forcing(64, 64, uo=0.25, vo=0.05, ua=5.0, sst=-2.,
                              sss=34., device=cpu)
    st = ibp.create_bergs(256, lon=lon, lat=lat,
                          uvel=rng.uniform(-0.3, 0.3, n),
                          vvel=rng.uniform(-0.3, 0.3, n),
                          mass=850. * 200. * (2 * r) ** 2, thickness=200.,
                          width=2 * r, length=2 * r, mass_scaling=1.0,
                          id_cnt=np.arange(n) + 1, max_bonds=max_bonds,
                          od=rng.uniform(120., 260., n), device=cpu)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = forces.count_bonds(forces.initialize_bonds_host(
        st.replace(ine=i, jne=j, xi=xi, yj=yj), cfg))
    st = k4.pack_conglomerates_blocked(st, block_n)
    st = st.replace(axn_fast=st.uvel * 1e-3, ayn_fast=st.vvel * -1e-3,
                    ang_vel=st.uvel * 1e-5)
    deltas = k4.analyze_bond_deltas(st.bond_idx, block_n)
    assert deltas
    return grid, frc, st, deltas


_LLK = dict(grid_is_latlon=True, Lx=360., use_f_plane=False)
_HEXK = {"hexagonal_icebergs": True}
# hexagonally packed units: six bonds an interior element; the hexagonal
# bonding radius (4.03 km) reaches across 3.85 km gaps, so 4.5 km
_HEXW = {"gap": 4.5e3, "hex_units": tuple(range(6))}
_ELASTIC = {"frac_thres_n": 1.8e5}

# (instantiation, forced, jitter (m), config changes, world changes): the
# DEM world's flag set at both block sizes and with slots 4-5 used in some
# warps only, the generic instantiation forced onto that flag set, then
# each flag the generic instantiation reads, and other slot counts; then
# the lat-lon form (the world in degrees from latitude "lat": mid-latitude
# and near 80 S) and the hexagonal one, each at both block sizes, with
# bonds breaking (40 m) and without (2 m), and the generic instantiation
# forced onto both flag sets
_K4_CASES = [
    ("dem", False, 40.0, {}, {}),
    ("dem", False, 40.0, {}, {"block_n": 512}),
    ("dem", False, 40.0, {}, {"hex_units": (2,)}),
    ("dem", False, 40.0, {}, {"hex_units": (1,), "block_n": 512}),
    ("generic", True, 40.0, {}, {"hex_units": (1,), "block_n": 512}),
    ("generic", False, 2.0, {"short_step_mts_grounding": True,
                             "use_grounding_torque": True,
                             "frac_thres_n": 1.8e5}, {}),
    # the hexagonal bonding radius (4.03 km) reaches across 3.85 km gaps
    ("dem_hex", False, 40.0, {"hexagonal_icebergs": True}, {"gap": 4.5e3}),
    ("generic", False, 40.0, {"orig_dem_moment_of_inertia": True}, {}),
    ("generic", False, 40.0, {"ignore_tangential_force": True}, {}),
    ("generic", False, 40.0, {"scale_damping_by_pmag": False}, {}),
    ("generic", False, 40.0, {"constant_interaction_LW": False}, {}),
    ("generic", False, 40.0, {}, {"max_bonds": 4}),
    ("generic", False, 40.0, {}, {"max_bonds": 8, "hex_units": (2,)}),
    ("dem_ll", False, 40.0, _LLK, {"lat": -60.0}),
    ("dem_ll", False, 40.0, _LLK, {"lat": -60.0, "block_n": 512}),
    ("dem_ll", False, 40.0, _LLK, {"lat": -79.5}),
    ("dem_ll", False, 40.0, _LLK, {"lat": -79.5, "block_n": 512,
                                   "hex_units": (1,)}),
    ("dem_ll", False, 2.0, dict(_LLK, **_ELASTIC), {"lat": -60.0}),
    ("dem_ll", False, 2.0, dict(_LLK, **_ELASTIC), {"lat": -79.5,
                                                    "block_n": 512}),
    ("generic", True, 40.0, _LLK, {"lat": -79.5, "block_n": 512}),
    ("dem_hex", False, 40.0, _HEXK, _HEXW),
    ("dem_hex", False, 40.0, _HEXK, dict(_HEXW, block_n=512)),
    ("dem_hex", False, 2.0, dict(_HEXK, **_ELASTIC), _HEXW),
    ("dem_hex", False, 2.0, dict(_HEXK, **_ELASTIC),
     dict(_HEXW, block_n=512)),
    ("generic", True, 40.0, _HEXK, dict(_HEXW, block_n=512)),
]


@pytest.mark.parametrize("variant,forced,jitter,flags,world", _K4_CASES)
def test_dem_substeps_kernel_matches_plain(dev, variant, forced, jitter,
                                           flags, world):
    """K4 against its plain version on the card, in every instantiation:
    integers exact, floats bitwise (both round every operation
    separately: -fmad=false, IEEE sqrtf / sinf / cosf / division).  A
    lat-lon case builds its bonds in metres and moves the world to
    degrees."""
    world = dict(world)
    lat = world.pop("lat", None)
    cfg = _dem_cfg(**flags)
    bond_cfg = cfg if lat is None else _dem_cfg(**{
        k: v for k, v in flags.items() if k not in _LLK})
    _, _, st, deltas = _dem_world(bond_cfg, jitter, **world)
    if lat is not None:
        st = _to_degrees_at(st, lat)
    block_n = world.get("block_n", 128)
    assert (k4.instantiation(cfg, st.max_bonds) == variant) != forced
    st = st.to(dev)
    before = k4.part3_substeps_vmem.launches
    out, nb = k4.part3_substeps_vmem(st, cfg, deltas, block_n=block_n,
                                     variant=variant if forced else None)
    assert k4.part3_substeps_vmem.launches == before + 1
    ref, nbp = k4.part3_substeps_plain(st, cfg, deltas, block_n=block_n)
    assert int(nb) == int(nbp)
    if jitter > 10.0:
        assert int(nb) > 10
    for name in ("bond_broken", "n_bonds") + k4._CAR_FIELDS \
            + k4._BOND_FIELDS:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


@pytest.mark.parametrize("theta", [0., 0.7, 133.])
def test_hexagon_spreading_on_card_matches_cpu(dev, theta):
    """The hexagon geometry on the card against the CPU at 100k
    hexagons: bitwise at orientation 0; else within 8 ulps of (7 x extent
    x apothem + area): the card's cos and sin round up to an ulp apart
    from the CPU's (at 133 degrees every corner moves), and the clipping
    carries that to 4.4 such ulps on an edge nearly parallel to an axis
    (H100, 100k hexagons)."""
    from icebergs_tpu_torch.ops import hexagon as hexo
    g = torch.Generator().manual_seed(4)
    n = 100_000
    x0, y0 = (torch.rand(n, generator=g) * 2 - 1 for _ in range(2))
    H = torch.rand(n, generator=g) * 0.99 + 0.01
    th = torch.full((n,), theta)
    cpu = hexo.hexagon_into_quadrants_using_triangles(x0, y0, H, th)
    card = hexo.hexagon_into_quadrants_using_triangles(
        *(t.to(dev) for t in (x0, y0, H, th)))
    ext = torch.maximum(x0.abs(), y0.abs()).double() + 2 * H.double()
    tol = 8 * 2 ** -23 * (7 * ext * H.double() + cpu[0].double())
    for c, k in zip(cpu, card):
        if theta == 0.:
            assert torch.equal(k.cpu(), c)
        else:
            assert bool(((k.cpu().double() - c.double()).abs()
                         <= tol).all())


def test_extract_grouped_kernel_matches_plain(dev):
    """K2 with the conglomerate filter at radius 2 against its plain
    version on the sorted view of a bonded world."""
    cfg = _dem_cfg()
    grid, _, st, _ = _dem_world(cfg, 10.0)
    grid, st = grid.to(dev), st.to(dev)
    st, cs = srt.sort_state_by_cell(st, grid)
    PT, key_s = contact_features(st, grid, cfg, exclude_same_group=True)
    out, _ = extract.extract_sorted(PT, key_s, cs, grid, cfg, block_n=32,
                                    window=512, radius=2,
                                    exclude_same_group=True)
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, 32,
                                           512, radius=2)
    plain = extract.extract_sorted_plain(PT, cs, c_lo, c_hi, bad, 32,
                                         float(cfg.contact_distance),
                                         exclude_same_group=True)
    assert torch.equal(out, plain)
    cnt = out[extract.EX_CNT]
    assert int((cnt > 0).sum()) > 0
    own = extract.extract_sorted(PT, key_s, cs, grid, cfg, block_n=32,
                                 window=512, radius=2)[0]
    assert bool((own[extract.EX_CNT] >= cnt).all())
    assert int(own[extract.EX_CNT].sum()) > int(cnt.sum())


@pytest.mark.parametrize("shape", ["square", "hexagons"])
def test_dem_step_on_card_matches_cpu(dev, shape):
    """One MTS outer step (Part 1 through K1/K2, K4, K1/K3 spreading) on
    the card against the CPU: integers and the MTS counters exact,
    floats within 2e-3 of scale (an ulp where the two libraries' sin /
    pow round differently, grown by the stiff bonds over 12 substeps).
    ``hexagons``: hexagonally packed units with ``hexagonal_icebergs`` and
    ``radius_based_drag`` (K4's ``F_HEX``; the hexagon spreading, oriented
    by the bonds, through the slot sums)."""
    if shape == "square":
        cfg = _dem_cfg()
        grid, frc, st, deltas = _dem_world(cfg, 8.0)
    else:
        cfg = _dem_cfg(hexagonal_icebergs=True, radius_based_drag=True)
        grid, frc, st, deltas = _dem_world(cfg, 8.0, gap=4.5e3,
                                           hex_units=tuple(range(6)))
    outs = []
    for d in (dev, torch.device("cpu")):
        multi = ibp.make_multi_step(grid.to(d), cfg, 1, with_stats=True,
                                    mts_substep_kernel="vmem",
                                    mts_vmem_deltas=deltas,
                                    mts_vmem_block_n=128)
        s, ov, fb, _ = multi(st.to(d), frc.to(d))
        sd = multi.step_diags[0]
        outs.append((ibp.to_numpy(s), int(ov), int(fb), sd.conv_iters,
                     int(sd.broken_bonds), int(sd.p1_fallback)))
    (g, *gc), (c, *cc) = outs
    assert gc == cc and gc[0] == 0
    for name in ("alive", "id_cnt", "ine", "jne", "bond_broken", "n_bonds"):
        np.testing.assert_array_equal(g[name], c[name])
    live = g["alive"]
    for name in ("lon", "lat", "uvel", "vvel", "ang_vel", "bond_nstress"):
        a, b = g[name][live], c[name][live]
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=2e-3 * np.abs(b).max())


@pytest.mark.parametrize("style", ["new_bergs", "fl_bits"])
def test_coupled_run_on_card_matches_cpu(dev, style):
    """``IcebergsModel.run`` with calving and footloose (fused3 contacts,
    the default hash uniforms) for 3 steps on the card against the CPU:
    slots, ids, cells and every counter exact, floats within the CPU
    parity tolerance; both spawn paths run."""
    cfg, grid, frc, st, _ = _world(torch.device("cpu"), n=5000, nx=32)
    cfg = cfg.replace(footloose=True, fl_style=style, fl_youngs=1.e8,
                      fused_fallback_cap=8192)
    k = torch.arange(st.capacity)
    st = st.replace(fl_k=torch.where(k % 3 == 0, 5e5, 0.),
                    mass_of_fl_bits=torch.where(k % 7 == 1, 1.3e12, 0.))
    st = ibp.state.grow_capacity(st, 8192)
    calving = torch.zeros(grid.nx + 2, grid.ny + 2)
    calving[3, 3:29] = 3e9
    outs = []
    for d in (dev, torch.device("cpu")):
        m = ibp.IcebergsModel(grid, cfg, device=d)
        s = m.init_state(st, seed=4)
        counts = []
        for _ in range(3):
            s, o = m.run(s, frc.to(d), calving.to(d))
            counts.append(tuple(int(getattr(o, f)) for f in (
                "nbergs", "nbergs_calved", "nbergs_calved_fl",
                "spawn_overflow", "fl_spawn_overflow", "contact_overflow",
                "nbergs_melted")))
        outs.append((ibp.to_numpy(s.bergs), counts))
    (g, gc), (c, cc) = outs
    assert gc == cc
    assert sum(x[1] for x in gc) > 0 and sum(x[2] for x in gc) > 0
    for name in ("alive", "id_cnt", "id_ij", "ine", "jne"):
        np.testing.assert_array_equal(g[name], c[name])
    live = g["alive"]
    for name in ("lon", "lat", "uvel", "vvel", "mass", "fl_k",
                 "mass_of_fl_bits"):
        a, b = g[name][live], c[name][live]
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=2e-5 * np.abs(b).max())


def _tripolar_world(dev):
    """The benchmark's coupled world (``om4_coupled``) at the small size of
    its CPU tests, with a discharge that spawns bergs every step: a
    tripolar grid, contacts near the coast, spawns, melt, spreading."""
    from benchmark import harness
    from benchmark.worlds import tripolar_coupled
    conf = harness.merge(
        harness.load_json(harness.BENCH / "configs" / "om4_coupled.json"),
        {"grid": {"nx": 360, "ny": 240, "seed_north_of": -68.0},
         "bergs": {"n": 12000, "capacity": 16384},
         "calving": {"discharge_kg_per_year": 1e17}})
    return tripolar_coupled.build(ibp, conf, 2**31 + 11, dev)


def _leaves(tree):
    from icebergs_tpu_torch import graphs
    out = []
    spec = graphs.flatten(tree, out)
    return spec, out


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


@pytest.mark.parametrize("footloose", [False, True],
                         ids=["graphed", "footloose"])
def test_graphed_run_is_the_eager_run_bitwise(dev, footloose):
    """Two 8-step episodes of ``IcebergsModel.run`` from the same first
    state on the benchmark's tripolar world, graphed (the first step
    eager, the second captured, the rest replayed) against the eager step:
    every state field and every output bitwise the same after every step,
    and each step's returns unchanged by the next step.  A footloose
    config stays eager (its uniforms hash seed and step on the host) and
    gives the eager bits too."""
    from icebergs_tpu_torch import trace
    w = _tripolar_world(dev)
    cfg = w.cfg
    if footloose:
        cfg = cfg.replace(footloose=True, fl_style="new_bergs",
                          fl_youngs=1.e8)
    graphed = ibp.IcebergsModel(w.grid, cfg, device=dev)
    eager = ibp.IcebergsModel(w.grid, cfg, device=dev)
    eager._graphs = types.SimpleNamespace(run=eager._sequence)

    def start(m):
        s = m.init_state(w.bergs, seed=5)
        return s.replace(calving=s.calving.replace(stored_ice=w.stored))
    prev = trace.configure()
    trace.reset()
    spawned = 0
    try:
        for _ in range(2):
            sg, se, held = start(graphed), start(eager), None
            for _ in range(8):
                sg, og = graphed.run(sg, w.frc, w.calving)
                se, oe = eager.run(se, w.frc, w.calving)
                spec_g, lg = _leaves((sg, og))
                spec_e, le = _leaves((se, oe))
                assert len(lg) == len(le)
                assert sg.step == se.step and sg.seed == se.seed
                for a, b in zip(lg, le):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert torch.equal(_bits(a), _bits(b))
                if held is not None:
                    assert all(torch.equal(_bits(a), b) for a, b in held)
                held = [(t, _bits(t).clone()) for t in lg]
                spawned += int(og.nbergs_calved)
        tot = trace.totals()
    finally:
        trace.configure(**prev)
    assert spawned > 0
    if footloose:
        assert "kid.capture" not in tot and "kid.replay" not in tot
    else:
        assert tot["kid.capture"]["calls"] == 1
        assert tot["kid.replay"]["calls"] == 14
        # each of the 32 steps, and the capture
        assert tot["kid.evolve"]["calls"] == 2 * 16 + 1


def test_tracer_device_clock_without_sync(dev, monkeypatch):
    """``trace.configure(device=True)``: every span of three
    ``IcebergsModel.run`` steps gets its device ms from CUDA events, read
    as they complete or at ``report``, and no ``torch.cuda.synchronize``
    runs during the steps (replays of the step's graphs, captured before
    the device's clock is on: a capture queries no event)."""
    from icebergs_tpu_torch import trace
    cfg, grid, frc, st, _ = _world(dev, n=5000, nx=32)
    m = ibp.IcebergsModel(grid, cfg, device=dev)
    s, _ = m.run(m.init_state(st, seed=4), frc)   # loads the kernels
    s, _ = m.run(s, frc)                          # captures the graphs
    torch.cuda.synchronize()
    syncs, real = [], torch.cuda.synchronize

    def counted(*a, **k):
        syncs.append(1)
        return real(*a, **k)
    prev = trace.configure(device=True)
    try:
        trace.reset()
        monkeypatch.setattr(torch.cuda, "synchronize", counted)
        for _ in range(3):
            s, _ = m.run(s, frc)
        assert not syncs
        monkeypatch.undo()
        trace.report("card")
        recs = trace.records()
    finally:
        trace.configure(**prev)
    runs = [r for r in recs if r.name == "kid.run"]
    assert len(runs) == 3 and all(r.device_ms > 0 for r in runs)
    assert all(r.device_ms is not None for r in recs)
    assert {r.name for r in recs} >= {"kid.calving", "kid.contacts",
                                      "kid.evolve", "kid.spread"}
    tot = trace.totals()["kid.evolve"]
    assert tot["device_calls"] == tot["calls"] == 3


# --------------------------------------------------------------------------
# the MTS scan substep path (ROADMAP item 16)
# --------------------------------------------------------------------------

_PAIR_REGIME = dict(use_broken_bonds_for_substep_contact=False,
                    break_bonds_on_sub_steps=False, fracture_criterion="none")


def _mts_on_card_and_cpu(dev, cfg, st, grid, frc, **kw):
    outs = []
    for d in (dev, torch.device("cpu")):
        multi = ibp.make_multi_step(grid.to(d), cfg, 1, with_stats=True,
                                    **kw)
        s, ov, fb, _ = multi(st.to(d), frc.to(d))
        sd = multi.step_diags[0]
        outs.append((ibp.to_numpy(s), int(ov), sd.conv_iters,
                     int(sd.broken_bonds), int(sd.skin_dropped),
                     None if sd.contact_overflow is None
                     else int(sd.contact_overflow)))
    return outs


@pytest.mark.parametrize("regime", ["k4_flags", "pair_list", "dense"])
def test_mts_scan_step_on_card_matches_cpu(dev, regime):
    """One MTS outer step through the scan substeps (Part 1 through K1/K2,
    the DEM forces in PyTorch, K1/K3 spreading) on the card against the
    CPU: on K4's flag set, and in the reference's substep-contact regime
    through the frozen pair list and through the dense candidates.
    Integers and the MTS counters exact, floats within 2e-3 of scale
    (``test_dem_step_on_card_matches_cpu``'s bound)."""
    cfg = _dem_cfg() if regime == "k4_flags" else _dem_cfg(**_PAIR_REGIME)
    grid, frc, st, _ = _dem_world(cfg, 8.0)
    kw = dict(mts_substep_kernel="scan")
    if regime == "pair_list":
        kw["mts_pair_cap"] = 65536
    (g, *gc), (c, *cc) = _mts_on_card_and_cpu(dev, cfg, st, grid, frc, **kw)
    assert gc == cc and gc[0] == 0
    if regime == "pair_list":
        assert gc[4] == 0 and gc[3] > 0
    for name in ("alive", "id_cnt", "ine", "jne", "bond_broken", "n_bonds"):
        np.testing.assert_array_equal(g[name], c[name])
    live = g["alive"]
    for name in ("lon", "lat", "uvel", "vvel", "ang_vel", "axn_fast",
                 "bond_nstress"):
        a, b = g[name][live], c[name][live]
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=2e-3 * np.abs(b).max())


@pytest.mark.parametrize("jitter", [40.0, 2.0])
def test_mts_scan_matches_k4_on_card(dev, jitter):
    """The scan against K4 on the card after one outer step from one
    state: within 5e-6 of scale on ``tests/test_dem_vmem.py:92-109``'s
    fields, broken-bond counts equal."""
    cfg = _dem_cfg()
    grid, frc, st, deltas = _dem_world(cfg, jitter)
    grid, frc, st = grid.to(dev), frc.to(dev), st.to(dev)
    outs = []
    for kw in (dict(mts_substep_kernel="scan"),
               dict(mts_substep_kernel="vmem", mts_vmem_deltas=deltas,
                    mts_vmem_block_n=128)):
        s, d = ibp.make_step(grid, cfg, with_thermo=False,
                             with_spread=False, **kw)(st, frc)
        outs.append((s, int(d.broken_bonds)))
    (a, na), (b, nb) = outs
    assert na == nb
    for f in ("lon", "lat", "uvel", "vvel", "ang_vel", "ang_accel", "rot",
              "axn_fast", "ayn_fast", "uvel_old", "vvel_old",
              "bond_length", "bond_tangd1", "bond_tangd2",
              "bond_rel_rotation", "bond_nstress", "bond_sstress",
              "bond_broken", "n_bonds"):
        x, y = getattr(a, f).double(), getattr(b, f).double()
        assert float((x - y).abs().max()) <= 5e-6 * max(
            float(x.abs().max()), 1e-30), f


def test_pair_list_on_card_matches_cpu(dev):
    """The frozen pair list (every integer) on the card against the CPU,
    and the pair-list contact sums: twice on the card bit for bit, the
    ordered reduction equal to the CPU's sequential one on the same
    terms."""
    from icebergs_tpu_torch import mts
    from icebergs_tpu_torch.ops import dem
    cfg = _dem_cfg(**_PAIR_REGIME)
    grid, frc, st, _ = _dem_world(cfg, 8.0)
    lists = []
    for d in (dev, torch.device("cpu")):
        s, g = st.to(d), grid.to(d)
        nbr = forces.build_neighbor_tables(s, g, cfg, max_per_cell=16,
                                           ncells_radius=2)
        lists.append([x.cpu() for x in mts.compact_conglom_pairs(
            s, nbr, 65536, cfg=cfg, dt=cfg.dt)])
    for a, b in zip(*lists):
        assert torch.equal(a, b)
    assert int(lists[0][2].sum()) > 0 and int(lists[0][3]) == 0
    gen = torch.Generator().manual_seed(1)
    # every bond broken and the elements moved up to 600 m: the listed
    # partners come into contact
    sm = st.replace(lon_old=st.lon_old + (torch.rand(
        st.capacity, generator=gen) - .5) * 1200.,
        bond_broken=(st.bond_idx >= 0).to(st.bond_broken.dtype))
    sums = []
    for d in (dev, dev, torch.device("cpu")):
        s = sm.to(d)
        me, ot, pv = (x.to(d) for x in lists[0][:3])
        m = mts._pair_contact_masks(s, me, ot, pv, cfg)
        sums.append([x.cpu() for x in dem.dem_contact_forces_pairs(
            s, cfg, me, ot, m, valid=pv)])
    assert all(torch.equal(a, b) for a, b in zip(sums[0], sums[1]))
    assert int((sums[0][0] != 0).sum()) > 0
    rng = np.random.RandomState(2)
    key = torch.as_tensor(np.sort(rng.randint(0, 300, 5000)),
                          dtype=torch.int32)
    vals = torch.as_tensor((rng.standard_normal((5000, 4))
                            * 10. ** rng.uniform(-6, 6, (5000, 1))
                            ).astype(np.float32))
    on = dem.segment_sum_sorted(vals.to(dev), key.to(dev), 300).cpu()
    assert torch.equal(on, dem.segment_sum_sorted(vals, key, 300))


@pytest.mark.parametrize("regime", ["pairs", "dense", "broken_bonds"])
def test_substep_forces_on_card_match_cpu(dev, regime):
    """One substep's accelerations and bond stresses on the card against
    the CPU, every bond broken and the elements moved up to 600 m (the
    candidates in contact): within 1e-5 relative plus 2e-6 of scale (the
    CPU's float32 sqrt 1 ulp low near halfway, the card's library
    sin)."""
    from icebergs_tpu_torch import mts
    cfg = _dem_cfg(**({} if regime == "broken_bonds" else _PAIR_REGIME))
    grid, frc, st, _ = _dem_world(cfg, 8.0)
    gen = torch.Generator().manual_seed(1)
    st = st.replace(lon_old=st.lon_old + (torch.rand(
        st.capacity, generator=gen) - .5) * 1200.,
        bond_broken=(st.bond_idx >= 0).to(st.bond_broken.dtype))
    outs = []
    for d in (dev, torch.device("cpu")):
        s, g = st.to(d), grid.to(d)
        nbr = forces.build_neighbor_tables(s, g, cfg, max_per_cell=16,
                                           ncells_radius=2)
        pairs = None
        if regime == "pairs":
            pairs = mts.compact_conglom_pairs(s, nbr, 65536, cfg=cfg,
                                              dt=cfg.dt)[:3]
        a = mts._substep_forces(s, nbr, cfg, cfg.dt / cfg.n_sub_steps,
                                pairs=pairs)
        live = s.alive
        outs.append([x[live].cpu().double() for x in (
            *a[:3], a[3].nstress, a[3].sstress)])
    assert float(outs[1][0].abs().max()) > 0
    for x, y in zip(*outs):
        scale = max(float(y.abs().max()), 1e-30)
        assert bool(((x - y).abs() <= 1e-5 * y.abs() + 2e-6 * scale).all())


def test_mts_coupled_run_on_card_matches_cpu(dev):
    """``IcebergsModel.run`` with MTS (Part 1 on the candidate tables
    through K7 at M = 400, the scan substeps) for 2 steps on the card
    against the CPU: integers and counters exact, floats within 2e-3 of
    scale."""
    cfg = _dem_cfg()
    grid, frc, st, _ = _dem_world(cfg, 8.0)
    outs = []
    for d in (dev, torch.device("cpu")):
        model = ibp.IcebergsModel(grid, cfg, device=d)
        s = model.init_state(st)
        counts = []
        for _ in range(2):
            s, o = model.run(s, frc.to(d))
            counts.append((o.mts.conv_iters, int(o.mts.broken_bonds),
                           int(o.contact_overflow), int(o.nbergs)))
        outs.append((ibp.to_numpy(s.bergs), counts))
    (g, gc), (c, cc) = outs
    assert gc == cc
    for name in ("alive", "id_cnt", "ine", "jne", "bond_broken", "n_bonds"):
        np.testing.assert_array_equal(g[name], c[name])
    live = g["alive"]
    for name in ("lon", "lat", "uvel", "vvel", "mass", "ang_vel"):
        np.testing.assert_allclose(g[name][live], c[name][live], rtol=1e-4,
                                   atol=2e-3 * np.abs(c[name][live]).max())


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["explicit", "implicit"])
def test_mts_without_dem_on_card_matches_cpu(dev, explicit):
    """The input_MTS_KID.nml flag set (square elements, 12 substeps) on
    tests/test_mts_collision.py's world for 2 outer steps on the card
    against the CPU: bonds and contacts through K7 at M = max_bonds and
    400; counters and integers exact, floats within 1e-4 of scale."""
    cfg = ibp.IcebergsConfig(
        grid_is_latlon=False, Lx=20000., use_f_plane=True, lat_ref=0.,
        dt=600.0, Runge_not_Verlet=False, mts=True, mts_sub_steps=12,
        explicit_inner_mts=explicit, force_convergence=True,
        convergence_tolerance=1e-8, contact_distance=1.75e3,
        contact_spring_coef=1.e-7, interactive_icebergs_on=True,
        iceberg_bonds_on=True, spring_coef=1.e-5,
        allow_bergs_to_roll=False, set_melt_rates_to_zero=True)
    cpu = torch.device("cpu")
    grid = ibp.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False, device=cpu)
    frc = ibp.uniform_forcing(20, 20, vo=0.1, sst=-2.0, device=cpu)
    lon = [4800., 4800., 5200., 5200., 4800., 4800., 5200., 5200.]
    lat = [9100., 9500., 9100., 9500., 10500., 10900., 10500., 10900.]
    st = ibp.create_bergs(32, lon=lon, lat=lat, mass=1.36e10,
                          thickness=100., width=400., length=400.,
                          vvel=[.1] * 4 + [-.1] * 4, mass_scaling=1.,
                          id_cnt=np.arange(8) + 1, device=cpu)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.0)
    st = forces.initialize_bonds_host(
        st.replace(ine=i, jne=j, xi=xi, yj=yj),
        cfg.replace(length_for_manually_initialize_bonds=480.))
    outs = []
    for d in (dev, cpu):
        multi = ibp.make_multi_step(grid.to(d), cfg, 2, with_stats=True,
                                    with_thermo=False)
        s, ov, _, _ = multi(st.to(d), frc.to(d))
        outs.append((ibp.to_numpy(s), int(ov), [
            (x.conv_iters, x.inner_conv_iters) for x in multi.step_diags]))
    (g, *gc), (c, *cc) = outs
    assert gc == cc
    assert (gc[1][0][1] > 0) == (not explicit)
    for name in ("alive", "id_cnt", "ine", "jne", "bond_idx"):
        np.testing.assert_array_equal(g[name], c[name])
    live = g["alive"]
    for name in ("lon", "lat", "uvel", "vvel", "axn_fast", "ayn_fast"):
        np.testing.assert_allclose(g[name][live], c[name][live], rtol=1e-4,
                                   atol=1e-4 * np.abs(c[name][live]).max())


# ---------------------------------------------------------------------------
# the lat-lon branches of K2, K5 and K4 (ROADMAP item 11)
# ---------------------------------------------------------------------------

# the grids' southern edge: from 89.9 S, mid-latitude, and from 89.5 N
# (those grids end at 89.52 to 89.9 N, by their number of rows)
_LL_LATS = {"south_pole": -89.9, "mid": -61.0, "north_pole": 89.5}


def _ll_world(dev, n, lat0, nx=40, seed=0):
    """``n`` bergs of 100-300 m on a lat-lon grid of 0.02 x 0.01 degree
    cells from ``lat0``, 40 cells wide and ``n // 500`` (2 to 40) rows
    high, so that a block of 128 or 256 sorted bergs spans few enough
    cells to be searched, with knots, fl_k == -1 and dead rows and shared
    conglomerate ids; sorted.  Returns (cfg, grid, st, cs)."""
    ny = min(max(n // 500, 2), 40)
    cfg = ibp.IcebergsConfig(
        grid_is_latlon=True, Lx=360., use_f_plane=False, dt=600.0,
        Runge_not_Verlet=False, interactive_icebergs_on=True,
        contact_spring_coef=1e-8)
    grid = ibp.make_uniform_grid(nx, ny, 30., lat0, 0.02, 0.01,
                                 grid_is_latlon=True, device=dev)
    rng = np.random.RandomState(seed)
    m = max(n, 1)
    lon = 30. + rng.uniform(0.01, nx * 0.02 - 0.01, m)
    lat = lat0 + rng.uniform(0.005, ny * 0.01 - 0.005, m)
    k = m // 5
    lon[:k] = lon[0] + rng.uniform(-0.004, 0.004, k)
    lat[:k] = lat[0] + rng.uniform(-0.002, 0.002, k)
    st = ibp.create_bergs(max(n, 1) + 64, lon=lon[:n], lat=lat[:n],
                          mass=rng.uniform(1e8, 1e9, n), thickness=40.,
                          width=rng.uniform(100., 300., n),
                          length=rng.uniform(100., 300., n),
                          fl_k=np.where(rng.uniform(size=n) < 0.02, -1., 0.),
                          uvel=rng.uniform(-.3, .3, n),
                          vvel=rng.uniform(-.3, .3, n), device=dev)
    alive = st.alive & torch.as_tensor(rng.uniform(size=st.capacity) > 0.03,
                                       device=dev)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, 360.)
    cong = torch.as_tensor(rng.randint(0, 3, st.capacity)
                           + np.arange(st.capacity) // 20, device=dev)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj, alive=alive,
                    conglom_id=cong.to(st.conglom_id.dtype))
    st, cs = srt.sort_state_by_cell(st, grid)
    return cfg, grid, st, cs


def _ll_edge_world(dev, lat0, npairs=400, nx=60, ny=4):
    """Pairs of bergs ~22 m apart across the boundary between grid rows 1
    and 2 of a lat-lon grid of 0.01-degree rows from ``lat0`` (cells
    ~1 km wide at every latitude: 0.02 degrees at 60 degrees, wider
    towards the poles), straight north-south or on a diagonal, 0.095 of a
    cell apart in longitude from cell 10 (so that a block of up to 256
    sorted bergs spans fewer than nx - 5 cells), each berg in a
    conglomerate of its own.
    Sorted.  Returns (cfg, grid, st, cs); :func:`_edge_radii` then sets
    the radii that put each pair at its threshold."""
    cfg = ibp.IcebergsConfig(
        grid_is_latlon=True, Lx=360., use_f_plane=False, dt=600.0,
        Runge_not_Verlet=False, interactive_icebergs_on=True)
    lat_b = lat0 + 2 * 0.01
    coslat = np.cos(np.radians(lat_b))
    dlon_cell = 0.02 * np.cos(np.radians(60.)) / coslat
    grid = ibp.make_uniform_grid(nx, ny, 30., lat0, dlon_cell, 0.01,
                                 grid_is_latlon=True, device=dev)
    kpr = extract.metric_scalars(float(cfg.Rearth))[0]
    p = np.arange(npairs)
    sep = 22. / kpr                                        # degrees
    diag = p % 2 == 1
    dlat = np.where(diag, sep / np.sqrt(2.), sep)
    dlon = np.where(diag, sep / np.sqrt(2.) / coslat, 0.)
    lon0 = 30. + dlon_cell * (10.3 + 0.095 * p)
    lon = np.stack([lon0, lon0 + dlon], 1).reshape(-1)
    lat = np.stack([lat_b - dlat / 2, lat_b + dlat / 2], 1).reshape(-1)
    st = ibp.create_bergs(2 * npairs + 64, lon=lon, lat=lat, mass=1e7,
                          thickness=40., width=20., length=20., device=dev)
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, 360.)
    cong = torch.arange(st.capacity, device=dev).to(st.conglom_id.dtype)
    st, cs = srt.sort_state_by_cell(
        st.replace(ine=i, jne=j, xi=xi, yj=yj, conglom_id=cong), grid)
    return cfg, grid, st, cs


def _edge_radii(PT, cfg):
    """``PT`` with each live berg's radius set so that its pair's crit
    (the sum of the two radii, exact: both are crit / 2) puts crit^2 *
    slack at the pair's float32 r2 (the plain metric on the card), nudged
    by -2 .. 2 ulps of crit: the pairs sit just inside and just outside
    the threshold.  Each berg's partner is its nearest live berg."""
    lon, lat = PT[extract.PT_LON], PT[extract.PT_LAT]
    live = torch.nonzero(PT[extract.PT_ALIVE] > 0.5).flatten()
    rx, ry = pair_separation(lon[live, None], lat[live, None],
                             lon[None, live], lat[None, live], True,
                             float(cfg.Rearth))
    r2 = rx * rx + ry * ry
    r2.fill_diagonal_(float("inf"))
    r2p, partner = r2.min(1)
    assert torch.equal(partner[partner], torch.arange(live.numel(),
                                                      device=PT.device))
    crit = torch.sqrt(r2p / torch.tensor(extract._SLACK,
                                         dtype=torch.float32))
    # both sides of a pair take the nudge of its lower row
    k = torch.minimum(torch.arange(live.numel(), device=PT.device),
                      partner) % 5 - 2
    for step in range(2):
        up, down = k > step, k < -step
        crit = torch.where(up, torch.nextafter(crit, crit.new_tensor(
            float("inf"))), crit)
        crit = torch.where(down, torch.nextafter(crit, crit.new_zeros(())),
                           crit)
    PT = PT.clone()
    PT[extract.PT_RAD, live] = crit * 0.5
    return PT


@pytest.mark.parametrize("lat", sorted(_LL_LATS))
@pytest.mark.parametrize("n", [0, 1, 1000, 16000, "edge"])
@pytest.mark.parametrize("case", ["fused3", "part1", "epilogue",
                                  "generic"])
def test_extract_latlon_kernel_matches_plain(dev, case, n, lat):
    """K2's lat-lon instantiations (``fused3_ll``, ``part1_ll``,
    ``fused3_epi_ll``, and ``generic_ll`` at BN 64) bitwise against the
    plain version (the epilogue's spring sums bitwise on rows with at
    most two exact pairs, as its Cartesian test), at N 0, 1, 1000 and
    16,000, mid-latitude and at both poles' edge; ``"edge"``: pairs just
    inside and just outside crit across a cell-row boundary, where the
    candidate skip and the full test meet."""
    if n == "edge":
        cfg, grid, st, cs = _ll_edge_world(dev, _LL_LATS[lat])
    else:
        cfg, grid, st, cs = _ll_world(dev, n, _LL_LATS[lat])
    bn, radius, group, epi = {"fused3": (128, 1, False, False),
                              "part1": (256, 2, True, False),
                              "epilogue": (128, 1, False, True),
                              "generic": (64, 1, False, False)}[case]
    PT, key_s = contact_features(st, grid, cfg, exclude_same_group=group)
    if n == "edge":
        PT = _edge_radii(PT, cfg)
    before = (extract.extract_sorted.launches,
              extract.extract_sorted.epilogue_launches)
    out, _ = extract.extract_sorted(PT, key_s, cs, grid, cfg, block_n=bn,
                                    window=1024, radius=radius,
                                    exclude_same_group=group, epilogue=epi)
    after = (extract.extract_sorted.launches,
             extract.extract_sorted.epilogue_launches)
    assert after == ((before[0], before[1] + 1) if epi
                     else (before[0] + 1, before[1]))
    c_lo, c_hi, bad = extract.block_tables(key_s, cs, grid.nx, grid.ny, bn,
                                           1024, radius)
    plain, nexact = extract.extract_sorted_plain(
        PT, cs, c_lo, c_hi, bad, bn, float(cfg.contact_distance),
        exclude_same_group=group, epilogue=epi,
        spring=float(cfg.contact_spring_coef_eff) if epi else 0.,
        exact_counts=True, rearth=float(cfg.Rearth))
    sums = [extract.EX_IAX, extract.EX_IAY] if epi else []
    rest = [r for r in range(extract.EX_NOUT) if r not in sums]
    assert torch.equal(out[rest], plain[rest])
    if epi:
        few = nexact <= 2
        assert torch.equal(out[sums][:, few], plain[sums][:, few])
    if n == "edge":
        # the pairs straddle the threshold: some engage, some do not, and
        # the rows cross the cell-row boundary
        engaged = int((plain[extract.EX_CNT] > 0).sum())
        assert 0.2 < engaged / int(st.alive.sum()) < 0.8
        assert int(bad.sum()) <= 1            # the tail's dead padding
        assert int(st.jne[st.alive].min()) == 1
        assert int(st.jne[st.alive].max()) == 2
    elif n >= 1000:
        assert int((plain[extract.EX_CNT] > 0).sum()) > 50
    name = {"fused3": "fused3_ll", "part1": "part1_ll",
            "epilogue": "fused3_epi_ll", "generic": "generic_ll"}[case]
    assert extract.kernel_config(bn, radius, group, epilogue=epi,
                                 latlon=True)[0] == name


@pytest.mark.parametrize("lat", sorted(_LL_LATS))
@pytest.mark.parametrize("n", [0, 1, 1000, 16000])
@pytest.mark.parametrize("group", [False, True], ids=["fused", "grouped"])
def test_prepass_latlon_kernel_matches_plain(dev, group, n, lat):
    """K5's lat-lon instantiations (``fused_ll``; ``generic_group_ll`` at
    radius 2) bitwise against the plain version: counts, partner slots
    and bad flags."""
    cfg, grid, st, cs = _ll_world(dev, n, _LL_LATS[lat])
    bn, radius = (128, 2) if group else (128, 1)
    P, key_s = prepass.prepass_features(st, grid, cfg, group)
    before = prepass.contact_prepass_sorted.launches
    got = prepass.contact_prepass_sorted(P, key_s, cs, grid, cfg,
                                         block_n=bn, window=512,
                                         radius=radius,
                                         exclude_same_group=group)
    assert prepass.contact_prepass_sorted.launches == before + 1
    c_lo, c_hi, bad = prepass.block_tables(key_s, cs, grid.nx, grid.ny, bn,
                                           512, radius)
    ref = prepass.prepass_sorted_plain(P, cs, c_lo, c_hi, bn, 512,
                                       float(cfg.contact_distance),
                                       exclude_same_group=group,
                                       rearth=float(cfg.Rearth))
    for a, b in zip(got[:3], ref):
        assert torch.equal(a, b)
    assert torch.equal(got[3], bad[:, None].expand(-1, bn).reshape(-1)[
        :P.shape[0]])
    if n >= 1000:
        assert int((ref[0] > 0).sum()) > 50
    assert prepass.kernel_config(bn, radius, group, latlon=True)[0] == (
        "generic_group_ll" if group else "fused_ll")


@pytest.mark.parametrize("lat", [-89.9, -45., 0., 61., 89.86])
@pytest.mark.parametrize("group", [False, True], ids=["fused", "grouped"])
def test_prepass_latlon_kernel_at_threshold(dev, group, lat):
    """K5's lat-lon instantiations (``fused_ll``; ``generic_group_ll`` at
    radius 2) bitwise against the plain version on pairs just inside and
    just outside crit across a cell-row boundary (``_ll_edge_world`` from
    ``lat``, radii by ``_edge_radii``: crit^2 * slack within 2 ulps of
    each pair's r2), from 89.9 S to 89.9 N, with and without the group
    filter: where the cosine-free candidate skip and the full test
    meet."""
    cfg, grid, st, cs = _ll_edge_world(dev, lat)
    bn, radius = (128, 2) if group else (128, 1)
    PT, _ = contact_features(st, grid, cfg, exclude_same_group=group)
    P, key_s = prepass.prepass_features(st, grid, cfg, group)
    P = P.clone()
    P[:, prepass.F_RAD] = _edge_radii(PT, cfg)[extract.PT_RAD]
    before = prepass.contact_prepass_sorted.launches
    got = prepass.contact_prepass_sorted(P, key_s, cs, grid, cfg,
                                         block_n=bn, window=512,
                                         radius=radius,
                                         exclude_same_group=group)
    assert prepass.contact_prepass_sorted.launches == before + 1
    c_lo, c_hi, bad = prepass.block_tables(key_s, cs, grid.nx, grid.ny, bn,
                                           512, radius)
    ref = prepass.prepass_sorted_plain(P, cs, c_lo, c_hi, bn, 512,
                                       float(cfg.contact_distance),
                                       exclude_same_group=group,
                                       rearth=float(cfg.Rearth))
    for a, b in zip(got[:3], ref):
        assert torch.equal(a, b)
    assert torch.equal(got[3], bad[:, None].expand(-1, bn).reshape(-1)[
        :P.shape[0]])
    engaged = int((ref[0] > 0).sum())
    assert 0.2 < engaged / int(st.alive.sum()) < 0.8
    assert int(st.jne[st.alive].min()) == 1
    assert int(st.jne[st.alive].max()) == 2


def _to_degrees_at(st, lat0):
    """A Cartesian DEM state's metres as degrees from (40 E, ``lat0``):
    latitude by PI_180 Rearth, longitude through the metric at each
    element's latitude (float64 on the host)."""
    k = np.pi / 180. * 6360000.
    out = {}
    for lo, la in (("lon", "lat"), ("lon_old", "lat_old")):
        x = getattr(st, lo).double().cpu().numpy()
        y = getattr(st, la).double().cpu().numpy()
        lat = lat0 + (y - 14e3) / k
        out[la] = torch.as_tensor(lat, dtype=torch.float32)
        out[lo] = torch.as_tensor(40. + x / (k * np.cos(np.radians(lat))),
                                  dtype=torch.float32)
    return st.replace(**{k_: v.to(st.device) for k_, v in out.items()})


@pytest.mark.parametrize("lat", [-89.78, -60.0, 89.78],
                         ids=["south_pole", "mid", "north_pole"])
@pytest.mark.parametrize("jitter,flags", [
    (40.0, {}),
    (2.0, {"short_step_mts_grounding": True, "use_grounding_torque": True,
           "frac_thres_n": 1.8e5})], ids=["fracturing", "elastic"])
def test_dem_substeps_latlon_kernel_matches_plain(dev, lat, jitter, flags):
    """K4's lat-lon form (``dem_ll`` on the DEM flag set, the generic
    instantiation with F_LATLON on the other: the drift in degrees, the
    bond and contact metric at each pair's mean latitude) bitwise against
    the plain version, the DEM world placed mid-latitude and reaching
    89.9 degrees at either pole."""
    cfg = _dem_cfg(grid_is_latlon=True, Lx=360., use_f_plane=False,
                   **flags)
    _, _, st, deltas = _dem_world(_dem_cfg(**flags), jitter)
    st = _to_degrees_at(st, lat).to(dev)
    assert abs(float(st.lat[st.alive].abs().max())) < 89.95
    assert k4.instantiation(cfg, st.max_bonds) == (
        "generic" if flags else "dem_ll")
    before = k4.part3_substeps_vmem.launches
    out, nb = k4.part3_substeps_vmem(st, cfg, deltas, block_n=128)
    assert k4.part3_substeps_vmem.launches == before + 1
    ref, nbp = k4.part3_substeps_plain(st, cfg, deltas, block_n=128)
    assert int(nb) == int(nbp)
    for name in ("bond_broken", "n_bonds") + k4._CAR_FIELDS \
            + k4._BOND_FIELDS:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert bool((out.lon != st.lon)[st.alive].any())


def _driver_inputs(d, name):
    """``chip_smoke.py``'s phase-13d worlds (tests/test_driver.py's NML
    with contacts on, and DEM_NML) written by the port into ``d``."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from icebergs_tpu_torch.io import namelist, restart
    cpu = torch.device("cpu")
    if name == "nml":
        text = chip_smoke.NML_DRIVER.replace(
            "&icebergs_nml", "&icebergs_nml\n  interactive_icebergs_on="
            ".true.\n  spring_coef=1.e-5")
        grid = ibp.make_uniform_grid(20, 20, 0., 0., 1000., 1000.,
                                     grid_is_latlon=False, device=cpu)
        st = ibp.create_bergs(64, lon=[5000., 9000., 9100.],
                              lat=[9500., 10500., 10450.],
                              mass=850. * 20 * 100 * 100, thickness=20.,
                              width=100., length=100., mass_scaling=1.,
                              device=cpu)
    else:
        text = chip_smoke.NML_DEM
        grid = ibp.make_uniform_grid(24, 24, 0., 0., 7000., 7000.,
                                     grid_is_latlon=False, device=cpu)
        px, py = np.meshgrid(np.arange(4) * 3000., np.arange(4) * 3000.,
                             indexing="ij")
        st = ibp.create_bergs(64, lon=px.ravel() + 30000.,
                              lat=py.ravel() + 40000.,
                              mass=850. * 200. * 3000. ** 2, thickness=200.,
                              width=3000., length=3000., mass_scaling=1.,
                              id_cnt=np.arange(16) + 1, max_bonds=6,
                              device=cpu)
    (d / "input.nml").write_text(text)
    cfg, _ = namelist.config_from_namelist(str(d / "input.nml"))
    i, j, xi, yj = ibp.pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    if name == "dem_nml":
        st = forces.count_bonds(forces.initialize_bonds_host(st, cfg))
        restart.write_restart_bonds(str(d / "bonds_iceberg.res.nc"), st,
                                    cfg)
    restart.write_restart_bergs(str(d / "icebergs.res.nc"), st, cfg)
    return text


def test_driver_exact_restart_on_card(dev, tmp_path):
    """The driver on the card (K1-K3 with contacts): 12 steps, the
    restart, 12 more equal 24 uninterrupted steps field by field, and
    its restart file is the state's, as on the CPU
    (tests/test_torch_driver.py::test_driver_exact_restart)."""
    from icebergs_tpu_torch import diag, driver
    text = _driver_inputs(tmp_path, "nml")
    (tmp_path / "half.nml").write_text(text.replace("ibhrs=4", "ibhrs=2"))
    kw = dict(capacity=64, verbose=False, device="cuda")
    before = extract.extract_sorted.launches
    full = driver.run(str(tmp_path / "input.nml"), str(tmp_path),
                      str(tmp_path / "full"), **kw)
    assert extract.extract_sorted.launches > before
    driver.run(str(tmp_path / "half.nml"), str(tmp_path),
               str(tmp_path / "h1"), **kw)
    h2 = driver.run(str(tmp_path / "half.nml"), str(tmp_path / "h1"),
                    str(tmp_path / "h2"), **kw)
    assert [int(x) for x in diag.berg_chksum(full)] == \
        [int(x) for x in diag.berg_chksum(h2)]
    F, H = ibp.to_numpy(full), ibp.to_numpy(h2)
    for name, v in F.items():
        np.testing.assert_array_equal(H[name], v, err_msg=name)
    assert (tmp_path / "full" / "icebergs.res.nc").read_bytes() == \
        (tmp_path / "h2" / "icebergs.res.nc").read_bytes()


def test_driver_picks_k4_on_card(dev, tmp_path):
    """On DEM_NML the driver on the card picks K4 (block-closed 128-slot
    block, the capacity grown from 64 as the JAX driver grows it) and
    keeps every integer of the CPU's run with K4's plain version."""
    from icebergs_tpu_torch import driver
    _driver_inputs(tmp_path, "dem_nml")
    nml = str(tmp_path / "input.nml")
    before = k4.part3_substeps_vmem.launches
    g = driver.run(nml, str(tmp_path), str(tmp_path / "g"), capacity=64,
                   verbose=False, device="cuda")
    assert k4.part3_substeps_vmem.launches > before
    assert g.capacity == 128 and g.device.type == "cuda"
    c = driver.run(nml, str(tmp_path), str(tmp_path / "c"), capacity=64,
                   verbose=False, device="cpu", substep_kernel="vmem")
    G, C = ibp.to_numpy(g), ibp.to_numpy(c)
    for name in ("alive", "id_cnt", "ine", "jne", "bond_idx",
                 "bond_broken", "conglom_id"):
        np.testing.assert_array_equal(G[name], C[name], err_msg=name)
    assert np.isfinite(G["lon"]).all()

"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests carry the ``cuda`` marker
and skip without a GPU.  On a machine with one:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(the conftest configures jax, which such a machine need not have).
"""

import numpy as np
import pytest
import torch

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import extract, pack
from icebergs_tpu_torch.ops import segment_spread as ss
from icebergs_tpu_torch.ops import sorted as srt
from icebergs_tpu_torch.ops import thermo
from icebergs_tpu_torch.ops.fused_contact import contact_features

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _world(device, n=20000, nx=64, dxy=2000., seed=0):
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


def test_segment_spread_kernel_matches_plain(dev):
    cfg, grid, frc, st, cs = _world(dev)
    st2, melt = thermo.thermodynamics(st, grid, frc, cfg)
    _, rows = ss.build_rows(st2, grid, frc, cfg, melt.deferred_cols[:3],
                            key_alive=st.alive)
    rows = torch.stack(rows)
    tbl = ss.cell_tables(grid)
    S, _ = ss.segment_spread_sums(rows, cs, tbl, cfg, 3)
    assert torch.equal(S, ss.segment_spread_sums_plain(rows, cs, tbl, cfg))


def test_step_on_card_matches_cpu(dev):
    cfg, grid, frc, st, _ = _world(dev, n=5000, nx=32)
    outs = []
    for d in (dev, torch.device("cpu")):
        s, ov, fb, _ = ibp.make_multi_step(grid.to(d), cfg, 2,
                                           with_stats=True)(st.to(d),
                                                            frc.to(d))
        outs.append((ibp.to_numpy(s), int(ov), int(fb)))
    (g, gov, gfb), (c, cov, cfb) = outs
    assert (gov, gfb) == (cov, cfb) and gov == 0
    for name in ("alive", "id_cnt", "ine", "jne"):
        np.testing.assert_array_equal(g[name], c[name])
    live = g["alive"]
    for name in ("lon", "lat", "uvel", "vvel", "mass"):
        a, b = g[name][live], c[name][live]
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=2e-5 * np.abs(b).max())

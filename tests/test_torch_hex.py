"""Hexagonal elements in the port against the JAX package: the hexagon
geometry (``ops/hexagon.py``), the bond orientation
(``find_orientation_using_iceberg_bonds``), the hexagon branch of
``spread_weights`` (weights and ``I_fraction_used``), the coupler fields
under hexagons through every slot-sum route, and the radius-based disk of
the grounding torque.

The JAX functions run op by op (eager), as the JAX package's own tests
run the spreading: under one ``jax.jit`` XLA:CPU fuses multiply-adds.

Tolerances.  The hexagon's corners take ``cos`` / ``sin`` of the
orientation, which torch's and XLA:CPU's float32 (and float64) libraries
round up to 1 ulp apart (ROADMAP.md Queue 3) on ~5% of angles: the
corners then differ by an ulp of their position, and an area by at most
that ulp times the perimeter (7 x the apothem).  So each area is held
within ``AREA_ULPS`` ulps of (7 x the hexagon's extent x its apothem +
its area), in float64 and in float32; fed the same corners, the port's
clipping, shoelace and residual are bitwise the JAX package's, and so is
every result at an orientation whose cosine and sine both packages round
alike (0).  The bond orientation takes ``atan``, which the two libraries
also round up to 1 ulp apart (70 of the raft's 1,536 bond slots): within
``ORIENT_ATOL`` (its range is pi/3).  The weights of hexagons rotated by
those orientations within ``W_ATOL`` (their scale is 1); the coupler
fields within ``FIELD_ATOL_SCALE`` of each field's largest magnitude,
and bit for bit without the rotation (but ``ustar_iceberg``, within
2**-23 of scale: XLA:CPU fuses its epilogue's multiply-adds, as
``tests/test_torch_scatter_spread.py`` states).  Integers (ids, counts)
are exact.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell as jax_pos_to_cell
from icebergs_tpu import mts as jmts
from icebergs_tpu.ops import forces as jforces
from icebergs_tpu.ops import hexagon as jhex
from icebergs_tpu.ops import spread as jspread

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import dem as tdem
from icebergs_tpu_torch.ops import hexagon as thex
from icebergs_tpu_torch.ops import spread as tspread

torch.set_num_threads(1)
CPU = torch.device("cpu")
AREA_ULPS = 2
ORIENT_ATOL = 1e-6
W_ATOL = 2e-6
FIELD_ATOL_SCALE = 2e-6
TOL = 2e-6          # tests/test_hexagon.py's identities (float32)


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) or v is None
                     else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _port_cfg(cfg):
    return ibp.config_from_dict(dataclasses.asdict(cfg))


# ---- the hexagon geometry --------------------------------------------

def hexq(x0, y0, H=1.0, theta=0.0):
    out = thex.hexagon_into_quadrants_using_triangles(
        *(torch.tensor([v], dtype=torch.float32)
          for v in (x0, y0, H, theta)))
    return tuple(float(v[0]) for v in out)


def test_hexagon_identities():
    """``tests/test_hexagon.py``'s identities (the reference's
    ``hexagon_test`` suite) on the port's function: equal quadrants at
    the origin, halves across an axis, the two-corner split, the area
    under rotation and a hexagon inside one quadrant."""
    H = 1.0
    S = 2 * H / math.sqrt(3.)
    A, q1, q2, q3, q4 = hexq(0., 0.)
    assert abs(A - (3. * math.sqrt(3.) / 2.) * S * S) < TOL
    assert all(abs(q - A / 4) < TOL for q in (q1, q2, q3, q4))
    for (x0, y0), (a, b) in (((S, 0.), (0, 3)), ((-S, 0.), (1, 2)),
                             ((0., H), (0, 1)), ((0., -H), (2, 3))):
        A, *q = hexq(x0, y0)
        for k in range(4):
            want = A / 2 if k in (a, b) else 0.
            assert abs(q[k] - want) < TOL, (x0, y0, k)
    A, q1, q2, q3, q4 = hexq(S / 2., 0.)
    for q, f in ((q1, 2.5), (q2, 0.5), (q3, 0.5), (q4, 2.5)):
        assert abs(q - f * A / 6.) < TOL
    A, q1, q2, q3, q4 = hexq(-S / 2., 0.)
    for q, f in ((q1, 0.5), (q2, 2.5), (q3, 2.5), (q4, 0.5)):
        assert abs(q - f * A / 6.) < TOL
    for th in (15., 30., 77., 133.):
        A, q1, q2, q3, q4 = hexq(0.3, -0.2, 0.7, th)
        S7 = 2 * 0.7 / math.sqrt(3.)
        assert abs(A - (3. * math.sqrt(3.) / 2.) * S7 * S7) < 5e-6
        assert abs((q1 + q2 + q3 + q4) - A) < 5e-6
        assert min(q1, q2, q3, q4) >= -1e-7
    A, q1, q2, q3, q4 = hexq(5.0, 5.0, 0.5)
    assert abs(q1 - A) < TOL and max(q2, q3, q4) < TOL
    # 0-d inputs give 0-d outputs
    out = thex.hexagon_into_quadrants_using_triangles(
        *(torch.tensor(v) for v in (0.1, 0.2, 0.5, 10.)))
    assert all(o.dim() == 0 for o in out)


def _hex_inputs(dtype):
    """~4k hexagons: random centres, apothems and orientations, with
    centres on an axis, hexagons inside one quadrant, ties for the
    largest quadrant (the origin at orientation 0 and 60) and the
    bug-compatible radian range of orientations (0 .. pi/3)."""
    rng = np.random.RandomState(7)
    n = 4096
    x0 = rng.uniform(-1.5, 1.5, n)
    y0 = rng.uniform(-1.5, 1.5, n)
    H = rng.uniform(0.01, 1., n)
    th = rng.uniform(-200., 200., n)
    x0[:64] = 0.
    y0[64:128] = 0.
    x0[128:192], y0[128:192] = rng.uniform(2., 3., 64), rng.uniform(2., 3., 64)
    th[192:512] = rng.uniform(0., np.pi / 3., 320)
    x0[512:544] = y0[512:544] = 0.            # ties at the origin
    th[512:528], th[528:544] = 0., 60.
    th[544:1024] = 0.
    return [a.astype(dtype) for a in (x0, y0, H, th)]


def _both(inputs):
    J = jhex.hexagon_into_quadrants_using_triangles(
        *(jnp.asarray(a) for a in inputs))
    T = thex.hexagon_into_quadrants_using_triangles(
        *(torch.as_tensor(a) for a in inputs))
    return [np.asarray(j) for j in J], [t.numpy() for t in T]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hexagon_quadrants_match_jax(dtype):
    """Parity with the JAX function on ~4k hexagons, float64 first (x64
    on in JAX), then float32: within the stated tolerance of each
    hexagon's area; bitwise at orientation 0 (cos and sin exact in both
    libraries) and at the ties, where the residual goes to Q1 in both."""
    inputs = _hex_inputs(np.dtype(dtype))
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
        try:
            J, T = _both(inputs)
        finally:
            jax.config.update("jax_enable_x64", False)
    else:
        J, T = _both(inputs)
    assert J[0].dtype == T[0].dtype == np.dtype(dtype)
    x0, y0, H, _ = (a.astype(np.float64) for a in inputs)
    ext = np.maximum(np.abs(x0), np.abs(y0)) + 2. * H / math.sqrt(3.)
    tol = AREA_ULPS * np.finfo(dtype).eps * (7. * ext * H + J[0])
    for j, t in zip(J, T):
        assert np.all(np.abs(t.astype(np.float64) - j) <= tol)
    still = inputs[3] == 0.
    for j, t in zip(J, T):
        np.testing.assert_array_equal(t[still], j[still])
    ties = slice(512, 528)
    for j, t in zip(J, T):
        np.testing.assert_array_equal(t[ties], j[ties])
    # a tie for the largest quadrant: both argmaxes take the first
    q = np.array([[1., 2., 0.5], [1., 2., 0.5], [0.5, 2., 0.5], [1., 0., .5]],
                 np.dtype(dtype))
    np.testing.assert_array_equal(
        torch.argmax(torch.as_tensor(q), dim=0).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(q), axis=0)))
    assert torch.argmax(torch.as_tensor(q), dim=0).tolist() == [0, 0, 0]


def test_hexagon_clipping_bitwise_on_same_corners(monkeypatch):
    """Fed the JAX package's corners, the port's clipping, shoelace and
    residual correction give the JAX package's areas bit for bit: what
    differs is only the library's cos / sin."""
    inputs = _hex_inputs(np.float32)
    jx, jy = (np.asarray(a) for a in jhex._hexagon_vertices(
        *(jnp.asarray(a) for a in inputs)))
    tx, ty = (a.numpy().T for a in thex._hexagon_vertices(
        *(torch.as_tensor(a) for a in inputs)))
    # the port's own corners: within 2 ulps of the hexagon's extent
    ext = np.abs(np.stack([jx, jy])).max(axis=(0, 2))
    ulp = np.spacing(ext.astype(np.float32))[:, None]
    assert np.all(np.abs(tx - jx) <= 2 * ulp)
    assert np.all(np.abs(ty - jy) <= 2 * ulp)
    corners = (torch.as_tensor(jx.T.copy()), torch.as_tensor(jy.T.copy()))
    monkeypatch.setattr(thex, "_hexagon_vertices", lambda *a: corners)
    J, T = _both(inputs)
    for j, t in zip(J, T):
        np.testing.assert_array_equal(t, j)


# ---- a bonded hexagonal raft -------------------------------------------

NX = 16
SIDE = 300.          # element width and length: A = 9e4 m2, R = 161.2 m


def _hex_lattice(cols, rows, spacing, x0, y0):
    """Hexagonal packing: columns sqrt(3) r apart, rows 2 r apart, odd
    columns offset by r, with r = spacing / 2."""
    r = spacing / 2.
    c, k = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    return ((x0 + c * r * math.sqrt(3.)).ravel(),
            (y0 + k * 2 * r + (c % 2) * r).ravel())


@functools.lru_cache(maxsize=None)
def _raft(latlon=False):
    """A bonded 8 x 7 hexagonal raft (interior elements with 6 bonds)
    and 120 lone bergs of random sizes on a 16 x 16 grid with a coast,
    jittered but for one column (bonds straight north: ``rx == 0``);
    three raft elements die after bonding, two bond pairs are cut
    (``bond_idx = -1``) and one is flagged broken, and three bergs are
    static.  Returns the JAX (cfg, grid, frc, state)."""
    cfg = ibt.IcebergsConfig(
        grid_is_latlon=latlon, Lx=360. if latlon else -1.,
        use_f_plane=not latlon, lat_ref=-60., dt=600.,
        Runge_not_Verlet=False, interactive_icebergs_on=True,
        iceberg_bonds_on=True, max_bonds=6, hexagonal_icebergs=True,
        manually_initialize_bonds=True,
        manually_initialize_bonds_from_radii=True)
    msk = np.ones((NX, NX))
    msk[:4, :3] = 0.                        # land: a coast
    msk[9, 12] = 0.
    dxy = 1000.
    k = 1. / (math.pi / 180. * cfg.Rearth)  # degrees a metre (latitude)
    if latlon:
        grid = ibt.make_uniform_grid(NX, NX, 10., -62., 0.02, 0.01,
                                     grid_is_latlon=True, msk=msk)
    else:
        grid = ibt.make_uniform_grid(NX, NX, 0., 0., dxy, dxy,
                                     grid_is_latlon=False, msk=msk)
    frc = ibt.swirl_forcing(NX, NX, dxy, uo=0.2, ua=4.0, sst=1.0, sss=33.)
    rng = np.random.RandomState(3)
    rx, ry = _hex_lattice(8, 7, SIDE, 5200., 5300.)
    nr = rx.size
    jit = rng.uniform(-25., 25., (2, nr))
    jit[:, :7] = 0.                         # the first column: rx == 0
    rx, ry = rx + jit[0], ry + jit[1]
    nl = 120
    lx = rng.uniform(1200., 14800., nl)
    ly = rng.uniform(1200., 14800., nl)
    lon = np.concatenate([rx, lx])
    lat = np.concatenate([ry, ly])
    L = np.concatenate([np.full(nr, SIDE), rng.uniform(100., 900., nl)])
    W = np.concatenate([np.full(nr, SIDE), rng.uniform(100., 900., nl)])
    if latlon:
        lat = -62. + lat * k
        lon = 10. + lon * k / np.cos(np.radians(lat))
    n = lon.size
    st = ibt.create_bergs(256, lon=lon, lat=lat,
                          uvel=rng.uniform(-.3, .3, n),
                          vvel=rng.uniform(-.3, .3, n),
                          mass=850. * 100. * L * W, thickness=100.,
                          width=W, length=L,
                          mass_scaling=rng.uniform(1., 2., n),
                          id_cnt=np.arange(n) + 1, max_bonds=6)
    i, j, xi, yj = jax_pos_to_cell(grid, st.lon, st.lat,
                                   360. if latlon else -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    st = jforces.initialize_bonds_host(st, cfg)
    bi = np.asarray(st.bond_idx).copy()
    for a in (20, 33):                      # cut a bond pair both ways
        b = bi[a, 0]
        bi[a, 0] = -1
        bi[b, bi[b] == a] = -1
    bb = np.asarray(st.bond_broken).copy()
    bb[40, 0] = 1                            # broken but still in place
    alive = np.asarray(st.alive).copy()
    alive[[9, 27, 50]] = False
    static = np.asarray(st.static_berg).copy()
    static[[3, nr + 5, nr + 17]] = 1.
    st = jforces.count_bonds(st.replace(
        bond_idx=jnp.asarray(bi), bond_broken=jnp.asarray(bb),
        alive=jnp.asarray(alive), static_berg=jnp.asarray(static)))
    return cfg, grid, frc, st


def _port(cfg, grid, frc, st):
    return (_port_cfg(cfg), ibp.grid_from_numpy(_leaves(grid), device=CPU),
            ibp.forcing_from_numpy(_leaves(frc), device=CPU),
            ibp.state_from_numpy(_leaves(st), device=CPU))


def test_raft_is_hexagonally_bonded():
    """The raft's interior elements hold 6 bonds; each cut pair is gone
    from both ends."""
    st = _raft()[3]
    nb = (np.asarray(st.bond_idx) >= 0).sum(1)
    assert nb.max() == 6 and (nb == 6).sum() >= 20
    assert int((np.asarray(st.bond_idx)[20] >= 0).sum()) < 6


@pytest.mark.parametrize("latlon,orient", [(False, 0.), (False, 15.),
                                           (True, 0.)],
                         ids=["cartesian", "initial15", "latlon"])
def test_orientation_from_bonds_matches_jax(latlon, orient):
    """``find_orientation_using_iceberg_bonds`` on the raft with dead
    slots and cut bonds (the mean in slot order, ``torch.remainder`` as
    ``jnp.mod``), within ``ORIENT_ATOL``: ``atan`` (and on the lat-lon
    grid the metric's ``cos``) rounds an ulp apart in the two libraries;
    bit for bit on the bonds whose ``atan`` both round alike."""
    cfg, grid, frc, st = _raft(latlon)
    cfg = cfg.replace(initial_orientation=orient)
    tcfg, _, _, tst = _port(cfg, grid, frc, st)
    o = jnp.full_like(st.xi, orient)
    j = np.asarray(jspread.find_orientation_using_iceberg_bonds(st, cfg, o))
    t = tspread.find_orientation_using_iceberg_bonds(
        tst, tcfg, torch.full_like(tst.xi, orient)).numpy()
    assert np.all((t >= 0.) & (t < math.pi / 3.))
    assert len(np.unique(j)) > 20
    np.testing.assert_allclose(t, j, rtol=0, atol=ORIENT_ATOL)
    assert (t == j).mean() > 0.9
    # no valid bond: 0 (not the initial orientation) in both
    lone = np.asarray((st.bond_idx < 0).all(axis=1))
    assert lone.sum() > 100 and not t[lone].any() and not j[lone].any()


@pytest.mark.parametrize("rotate", [False, True], ids=["fixed", "bonds"])
def test_hexagon_weights_match_jax(rotate):
    """``spread_weights``' hexagon branch: the 9 weights and
    ``I_fraction_used`` with the coast and static bergs, bit for bit at
    a fixed orientation of 0; with the orientation from the bonds within
    ``W_ATOL`` (weights) and the same relative to ``I_fraction_used``."""
    cfg, grid, frc, st = _raft()
    cfg = cfg.replace(rotate_icebergs_for_mass_spreading=rotate)
    tcfg, tgrid, _, tst = _port(cfg, grid, frc, st)
    jw, ji = (np.asarray(a) for a in jspread.spread_weights(st, grid, cfg))
    tw, ti = (a.numpy() for a in tspread.spread_weights(tst, tgrid, tcfg))
    assert tw.shape == jw.shape == (9, st.capacity)
    alive = np.asarray(st.alive)
    # I_fraction_used: above 1 by the coast, below where the centre cell
    # is land (its share counts 1 there: ``yCxC ** msk``)
    assert (ji[alive] > 1.).sum() > 0 and (ji[alive] < 1.).sum() > 0
    assert np.all(ji[np.asarray(st.static_berg) == 1.] == 1.)
    if rotate:
        np.testing.assert_allclose(tw, jw, rtol=0, atol=W_ATOL)
        np.testing.assert_allclose(ti[alive], ji[alive], rtol=W_ATOL)
    else:
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(ti, ji)


def test_rectangle_weights_keep_their_bits():
    """With rectangles ``I_fraction_used`` is ones, and the weights the
    spreading sums are the weights masked by aliveness, as before."""
    cfg, grid, frc, st = _raft()
    cfg = cfg.replace(hexagonal_icebergs=False)
    tcfg, tgrid, tfrc, tst = _port(cfg, grid, frc, st)
    w, ifr = tspread.spread_weights(tst, tgrid, tcfg)
    assert torch.equal(ifr, torch.ones_like(ifr))
    w9, _ = tspread.spread_products(tst, tgrid, tfrc, tcfg)
    assert torch.equal(w9, w * torch.where(tst.alive, 1., 0.)[None])
    jw, _ = jspread.spread_weights(st, grid, cfg)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def _extra_cols(st):
    rng = np.random.RandomState(2)
    return [rng.uniform(0., 1., st.capacity).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("method,rotate", [
    ("pallas", False), ("pallas", True), ("scatter", False),
    ("gather", True), ("noreprod", False), ("noreprod", True)])
def test_gridded_fields_hexagons_match_jax(method, rotate):
    """``create_gridded_icebergs_fields`` under hexagons, field by field:
    with ``parallel_reprod`` through ``slot_sum_method="pallas"`` (which
    hexagons route from K3 to the slot scatter, in both packages),
    ``"scatter"`` and ``"gather"`` (with three extra owning-cell columns
    in the same pass), and without ``parallel_reprod``; the orientation
    fixed or from the bonds."""
    reprod = method != "noreprod"
    cfg, grid, frc, st = _raft()
    cfg = cfg.replace(parallel_reprod=reprod,
                      slot_sum_method=method if reprod else "pallas",
                      reprod_max_per_cell=5,
                      rotate_icebergs_for_mass_spreading=rotate)
    tcfg, tgrid, tfrc, tst = _port(cfg, grid, frc, st)
    assert tspread.uses_spread_kernel(tcfg) is False
    cols = _extra_cols(st)
    extra = ([jnp.asarray(c) for c in cols], [torch.as_tensor(c)
                                              for c in cols])
    if reprod:
        (jsp, jx) = jspread.create_gridded_icebergs_fields(
            st, grid, frc, cfg, extra_cell_cols=extra[0])
        (tsp, tx) = tspread.create_gridded_icebergs_fields(
            tst, tgrid, tfrc, tcfg, extra_cell_cols=extra[1])
    else:
        jsp = jspread.create_gridded_icebergs_fields(st, grid, frc, cfg)
        tsp = tspread.create_gridded_icebergs_fields(tst, tgrid, tfrc,
                                                     tcfg)
        jx, tx = [], []
    pairs = [(f, getattr(tsp, f), getattr(jsp, f)) for f in tsp._fields]
    pairs += [(f"extra {k}", t, j) for k, (t, j) in enumerate(zip(tx, jx))]
    assert len(pairs) == 13 + 3 * reprod
    for name, t, j in pairs:
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1e-30)
        if rotate:
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=FIELD_ATOL_SCALE * scale,
                                       err_msg=name)
        elif name == "ustar_iceberg":
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=2 ** -23 * scale, err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert float(np.abs(np.asarray(jsp.mass_on_ocean)).max()) > 0


def test_hexagon_spreading_conserves_mass():
    """On an all-wet grid each hexagon's quadrants cover its whole area
    (``I_fraction_used`` 1): the spread mass is the bergs' mass.  (By a
    coast the weights are not masked and ``I_fraction_used`` scales them
    up, as in the reference and the JAX package.)"""
    cfg, grid, frc, st = _raft()
    tcfg, tgrid, tfrc, tst = _port(cfg, grid, frc, st)
    tgrid = tgrid.replace(msk=torch.ones_like(tgrid.msk))
    tst = tst.replace(static_berg=torch.zeros_like(tst.static_berg))
    _, ifr = tspread.spread_weights(tst, tgrid, tcfg)
    assert float((ifr[tst.alive] - 1.).abs().max()) < 1e-6
    sp = tspread.create_gridded_icebergs_fields(tst, tgrid, tfrc, tcfg)
    want = float(tspread.berg_spread_mass(tst, tgrid, tfrc, tcfg)[
        tst.alive].double().sum())
    got = float(sp.mass_on_ocean.double().sum())
    assert abs(got - want) <= 1e-5 * want


@pytest.mark.parametrize("const_lw", [True, False])
def test_hexagon_grounding_disk_matches_jax(const_lw):
    """The grounding torque's disk under hexagons: the scan's form
    divides by 2 sqrt(3), bit for bit against ``mts._grounding_drag_coeff``
    (``icebergs_tpu/mts.py:567``); K4's form multiplies by the
    reciprocal, as ``dem_vmem.py:310-311`` does."""
    from test_torch_dem_forces import jax_cfg, moved_state
    cfg = jax_cfg(hexagonal_icebergs=True, constant_interaction_LW=const_lw)
    st = moved_state()
    with jax.disable_jit():
        j = np.asarray(jmts._grounding_drag_coeff(st, cfg, "disk"))
    ts = ibp.state_from_numpy(_leaves(st), device=CPU)
    args = (_port_cfg(cfg), ts.thickness, ts.od, ts.mass, ts.length,
            ts.width, "disk")
    t = tdem.grounding_drag_coeff(*args, scan=True).numpy()
    assert (j != 0).sum() > 0
    np.testing.assert_array_equal(t, j)
    k4 = tdem.grounding_drag_coeff(*args).numpy()
    np.testing.assert_allclose(k4, j, rtol=2 ** -22)

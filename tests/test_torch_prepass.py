"""K5, the contact prepass search, against the JAX package.

The port's plain version of ``contact_prepass_sorted`` and the TPU
kernel in interpret mode get the same packed features of a cell-sorted
slab; counts, smallest / largest partner slots and bad-block flags must
match exactly, in good and bad blocks alike, and so must ``n_fallback``
(the bergs in bad blocks or with 3+ partners).  The cases mirror
``tests/test_fused_contact.py``: sparse, a dense knot with 3+ partners,
a window small enough that blocks go bad, dead rows, and radius 2 with
the conglomerate filter.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icebergs_tpu as ibt
from icebergs_tpu.grid import pos_to_cell
from icebergs_tpu.ops import pallas_prepass as jprep
from icebergs_tpu.ops.sorted import sort_state_by_cell as jax_sort

import icebergs_tpu_torch as ibp
from icebergs_tpu_torch.ops import prepass as tprep

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _leaves(obj):
    return {f.name: (v if isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]
            if v is not None}


def _world(n, seed, cluster=False, kill_half=False, groups=False):
    """``_world`` of test_fused_contact.py, cell-sorted."""
    cfg = ibt.IcebergsConfig(grid_is_latlon=False, Lx=-1.0,
                             use_f_plane=True, lat_ref=30., dt=60.,
                             interactive_icebergs_on=True)
    grid = ibt.make_uniform_grid(16, 16, 0., 0., 1000., 1000.,
                                 grid_is_latlon=False)
    rng = np.random.RandomState(seed)
    lon = rng.uniform(4e3, 12e3, n)
    lat = rng.uniform(4e3, 12e3, n)
    if cluster:
        k = n // 4
        lon[:k] = 7.5e3 + rng.uniform(-120., 120., k)
        lat[:k] = 7.5e3 + rng.uniform(-120., 120., k)
    st = ibt.create_bergs(512, lon=lon, lat=lat,
                          mass=850. * 40. * 150. * 150., thickness=40.,
                          width=150., length=150., mass_scaling=1.,
                          id_cnt=np.arange(n) + 1)
    i, j, xi, yj = pos_to_cell(grid, st.lon, st.lat, -1.)
    st = st.replace(ine=i, jne=j, xi=xi, yj=yj)
    if kill_half:
        kill = np.zeros(512, bool)
        kill[::2] = True
        st = st.replace(alive=st.alive & ~jnp.asarray(kill))
    if groups:
        st = st.replace(conglom_id=jnp.asarray(
            rng.randint(1, 5, 512).astype(np.int32)))
    st, cs = jax_sort(st, grid)
    return cfg, grid, st, cs


CASES = {
    "sparse": (dict(n=400, seed=9), dict(block_n=64, window=512)),
    "clustered": (dict(n=400, seed=3, cluster=True),
                  dict(block_n=64, window=512)),
    "small_window": (dict(n=300, seed=5), dict(block_n=64, window=24)),
    "dead_rows": (dict(n=400, seed=9, kill_half=True),
                  dict(block_n=64, window=512)),
    "radius2_groups": (dict(n=400, seed=3, cluster=True, groups=True),
                       dict(block_n=32, window=256, radius=2,
                            exclude_same_group=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepass_plain_matches_jax(case):
    wkw, kw = CASES[case]
    cfg, grid, st, cs = _world(**wkw)
    tst = ibp.state_from_numpy(_leaves(st), device=CPU)
    tgrid = ibp.grid_from_numpy(_leaves(grid), device=CPU)
    tcfg = ibp.config_from_dict(dataclasses.asdict(cfg))
    exclude = kw.get("exclude_same_group", False)
    P, key = tprep.prepass_features(tst, tgrid, tcfg, exclude)
    if not exclude:
        np.testing.assert_array_equal(
            P.numpy(), np.asarray(jprep._pack(st, grid, cfg)))
    cnt, pmin, pmax, bad = tprep.contact_prepass_sorted(
        P, key, torch.as_tensor(np.array(cs)), tgrid, tcfg, **kw)
    jcnt, jpmin, jpmax, jbad = jprep.contact_prepass_sorted(
        None, cs, grid, cfg, interpret=True, P=jnp.asarray(P.numpy()),
        key=jnp.asarray(key.numpy()), **kw)
    for name, t, j in (("cnt", cnt, jcnt), ("pmin", pmin, jpmin),
                       ("pmax", pmax, jpmax), ("bad_block", bad, jbad)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    alive = np.asarray(st.alive)
    n_fallback = int(((bad.numpy() | (cnt.numpy() > 2)) & alive).sum())
    assert n_fallback == int(((np.asarray(jbad) | (np.asarray(jcnt) > 2))
                              & alive).sum())
    assert int((cnt > 0).sum()) > 0
    if case == "clustered":
        assert int((cnt >= 3).sum()) > 0, "the knot must give 3+ partners"
    if case == "small_window":
        assert bool(bad.any()) and not bool(bad.all())

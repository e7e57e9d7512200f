"""What an episode produced, as host arrays keyed by what the comparison
matches on (``reference/compare.py``)."""

import numpy as np


def host(x):
    return x.detach().cpu().numpy()


def bergs(st):
    """The live rows of a berg state: ``key`` (int64 of id_ij and
    id_cnt), the cell, the position in cells (``fx``, ``fy``: the cell
    index plus the place in the cell) and every 1-D float field."""
    alive = host(st.alive)
    idx = np.nonzero(alive)[0]
    key = ((host(st.id_ij).astype(np.int64) << 32)
           | (host(st.id_cnt).astype(np.int64) & 0xffffffff))
    ine, jne = host(st.ine)[idx], host(st.jne)[idx]
    floats = {name: host(v)[idx] for name, v in vars(st).items()
              if v.is_floating_point() and v.dim() == 1}
    return dict(key=key[idx], ine=ine, jne=jne,
                fx=ine + floats["xi"].astype(np.float64),
                fy=jne + floats["yj"].astype(np.float64), floats=floats)


def scalar(x):
    if x is None:
        return 0
    return x if isinstance(x, (int, float)) else float(x)


def fields(obj, names):
    """The named fields of a step's outputs as host arrays."""
    return {n: host(getattr(obj, n)) for n in names
            if getattr(obj, n, None) is not None}


# the float fields of a berg row a state carries from step to step
ROW_FIELDS = ("lon", "lat", "xi", "yj", "uvel", "vvel", "axn", "ayn", "bxn",
              "byn", "mass", "thickness", "width", "length", "start_lon",
              "start_lat", "start_mass")


def state(st, calv):
    """A state as host arrays, for the reference to start a step from:
    the live berg rows (``ROW_FIELDS``, ``key``, the cell, the scaling
    and heat) and the calving buckets with their id counters."""
    alive = st.alive
    key = ((st.id_ij[alive].long() << 32)
           | (st.id_cnt[alive].long() & 0xffffffff))
    rows = {k: host(getattr(st, k)[alive]) for k in ROW_FIELDS}
    rows.update(key=host(key), i=host(st.ine[alive]),
                j=host(st.jne[alive]),
                mass_scaling=host(st.mass_scaling[alive]),
                heat_density=host(st.heat_density[alive]))
    return dict(bergs=rows, stored=host(calv.stored_ice),
                counter=host(calv.id_counter))

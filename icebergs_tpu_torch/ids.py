"""The 64-bit iceberg id scheme.

Counterpart of ``icebergs_tpu/ids.py`` (port of ``generate_id`` /
``id_from_2_ints`` / ``split_id`` / ``convert_old_id``,
``src/icebergs_framework.F90:4165-4243, 7276-7298``): an id is the pair
(per-cell calving counter, ij hash) with ij = i + iNg*(j-1) (1-based),
kept as the two int32 fields ``id_cnt`` / ``id_ij``; the packed int64 view
serves diagnostics.  Everything here runs on the host (numpy).
"""

from __future__ import annotations

import numpy as np


def ij_component_of_id(i, j, iNg: int):
    """ij hash of 0-based cell indices (the reference's 1-based
    ij = i1 + iNg*(j1-1) with i1 = i+1, j1 = j+1)."""
    return (i + 1) + iNg * j


def id_from_2_ints(cnt, ij):
    """Pack (cnt, ij) into an int64, cnt in the high 32 bits."""
    return (np.int64(cnt) << 32) | (np.int64(ij) & 0xFFFFFFFF)


def split_id(packed):
    """Inverse of :func:`id_from_2_ints`."""
    packed = np.int64(packed)
    return np.int32(packed >> 32), np.int32(packed & 0xFFFFFFFF)


def convert_old_id(old_id, iNg: int, jNg: int):
    """A 32-bit legacy id -> (cnt, ij) (cij_from_old_id + ij_component,
    icebergs_framework.F90:4197-4221)."""
    ncells = iNg * jNg
    cnt = old_id // ncells
    ij_old = old_id % ncells
    j1 = ij_old // iNg
    i1 = ij_old % iNg
    return np.int32(cnt), np.int32(i1 + iNg * (j1 - 1))


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def ids_of_state(st):
    """Packed int64 ids of every slot (host side)."""
    return id_from_2_ints(_host(st.id_cnt).astype(np.int64),
                          _host(st.id_ij).astype(np.int64))


def check_for_duplicate_ids(st):
    """The packed ids that more than one live, owned berg carries
    (test_check_for_duplicate_ids_in_list,
    icebergs_framework.F90:7455-7487).  Host side."""
    alive = _host(st.alive) & (_host(st.halo_berg) < 0.5)
    ids = ids_of_state(st)[alive]
    uniq, counts = np.unique(ids, return_counts=True)
    return uniq[counts > 1]

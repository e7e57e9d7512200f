"""Carry state, grid, forcing and config across from the JAX package.

The JAX side hands over plain data — ``{name: np.asarray(leaf)}`` for a
state, grid or forcing, and ``dataclasses.asdict(cfg)`` for a config — so
neither package imports the other.  Field names are shared with
``icebergs_tpu``; arrays keep their dtype (float32, int32, bool).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import IcebergsConfig
from .forcing import Forcing
from .grid import Grid
from .state import BergState


def _tensors(cls, d, device):
    return cls(**{f.name: (v if v is None or isinstance(v, int)
                           else torch.as_tensor(np.array(v)).to(device))
                  for f in dataclasses.fields(cls)
                  for v in [d[f.name]]})


def state_from_numpy(d, *, device) -> BergState:
    """A BergState from ``{field: array}`` (extra keys are ignored)."""
    return _tensors(BergState, d, device)


_GRID_INTS = ("nx", "ny", "i_off", "j_off", "nxg", "nyg", "own_halo_x",
              "own_halo_y")


def grid_from_numpy(d, *, device) -> Grid:
    """A Grid from ``{field: array}`` plus the ints ``nx``/``ny`` and the
    tile metadata (``i_off``, ``j_off`` as 0-dim arrays or None for 0,
    ``nxg``, ``nyg``, ``own_halo_x/y``, the port's ``lon0g``/``lat0g``;
    absent keys keep the defaults)."""
    ints = {k: int(0 if d[k] is None else np.asarray(d[k]))
            for k in _GRID_INTS if k in d}
    return _tensors(Grid, {**dict.fromkeys(_GRID_INTS[2:], 0),
                           "lon0g": None, "lat0g": None, **d, **ints},
                    device)


def forcing_from_numpy(d, *, device) -> Forcing:
    return _tensors(Forcing, d, device)


def config_from_dict(d) -> IcebergsConfig:
    """An IcebergsConfig from ``dataclasses.asdict`` of the JAX config."""
    names = {f.name for f in dataclasses.fields(IcebergsConfig)}
    return IcebergsConfig(**{k: v for k, v in d.items() if k in names})


def to_numpy(obj):
    """``{field: np.ndarray}`` of a BergState, Grid or Forcing (ints stay
    ints) — the inverse of the ``*_from_numpy`` functions."""
    return {f.name: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}

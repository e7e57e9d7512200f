"""Fortran namelist reader: load reference ``input.nml`` files 1:1.

Counterpart of ``icebergs_tpu/io/namelist.py``, with the same parser
and coercions into this package's :class:`IcebergsConfig`.  Parses the
subset of namelist syntax the reference test configs use (scalars,
logicals, strings, comma lists, ! comments) and builds an
:class:`IcebergsConfig` plus the driver parameter dict
(``icebergs_driver_nml``, driver/icebergs_driver.F90:83-87).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

from ..config import IcebergsConfig


def _parse_value(tok: str):
    t = tok.strip()
    if not t:
        return None
    tl = t.lower()
    if tl in (".true.", "t", "true"):
        return True
    if tl in (".false.", "f", "false"):
        return False
    if t.startswith(("'", '"')) and t.endswith(("'", '"')):
        return t[1:-1]
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t.replace("d", "e").replace("D", "E"))
    except ValueError:
        return t


def parse_namelist_file(path: str) -> Dict[str, Dict[str, object]]:
    """Parse all &group ... / stanzas into {group: {param: value}}."""
    with open(path) as f:
        text = f.read()
    groups: Dict[str, Dict[str, object]] = {}
    cur = None
    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            cur = line[1:].strip().lower()
            groups.setdefault(cur, {})
            continue
        if line == "/" or line.startswith("/"):
            cur = None
            continue
        if cur is None:
            continue
        m = re.match(r"([A-Za-z_0-9%]+)\s*=\s*(.*)", line)
        if not m:
            continue
        key = m.group(1).lower()
        rhs = m.group(2).rstrip(",").strip()
        if "," in rhs and not rhs.startswith(("'", '"')):
            vals = [_parse_value(v) for v in rhs.split(",") if v.strip()]
            groups[cur][key] = tuple(vals)
        else:
            groups[cur][key] = _parse_value(rhs)
    return groups


# namelist name -> config field (case-insensitive match on field names)
_FIELD_BY_LOWER = {f.name.lower(): f.name
                   for f in dataclasses.fields(IcebergsConfig)}


def config_from_namelist(path: str, dt: float = None,
                         **overrides) -> Tuple[IcebergsConfig, dict]:
    """Build an IcebergsConfig from an input.nml.

    Returns (config, driver_params). Unknown parameters are collected in
    driver_params["_unknown"] rather than dropped silently.
    """
    groups = parse_namelist_file(path)
    nml = groups.get("icebergs_nml", {})
    drv = groups.get("icebergs_driver_nml", {})

    kw = {}
    unknown = {}
    for key, val in nml.items():
        field = _FIELD_BY_LOWER.get(key)
        if field is None:
            unknown[key] = val
            continue
        kw[field] = val
    if dt is None and "ibdt" in drv:
        dt = float(drv["ibdt"])
    if dt is not None:
        kw["dt"] = float(dt)
    kw.update(overrides)
    cfg = IcebergsConfig(**kw).normalized()
    drv = dict(drv)
    drv["_unknown"] = unknown
    return cfg, drv

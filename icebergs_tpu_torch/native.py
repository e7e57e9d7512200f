"""ctypes loader for the native host kernels (``csrc/kidhost.cpp``).

Counterpart of ``icebergs_tpu/native.py``: cell-hashed bond formation,
O(n) where the numpy route is O(n^2), and union-find conglomerate labels.
The library is compiled with ``g++ -O2 -shared -fPIC`` at first use into
``_build/`` under a name keyed by a hash of the source, and loaded once
per process.  A failed build raises ``RuntimeError`` with the compiler's
message; the callers in :mod:`.ops.forces` take the numpy route instead
only where it can hold the size, and warn when they do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "kidhost.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O2", "-shared", "-fPIC")
# the callers take this library above this many elements (slots for the
# labels), as icebergs_tpu/ops/forces.py:809-816 and :887-889 do
MIN_ELEMENTS = 512


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libkidhost_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises RuntimeError
    naming the compiler's error when it does not build."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
        except OSError as e:
            raise RuntimeError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE.name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.kid_bond_init.restype = ctypes.c_int64
    lib.kid_bond_init.argtypes = [
        ctypes.c_int64, f64, f64, f64, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, i32, f64, f64]
    lib.kid_conglom_label.restype = None
    lib.kid_conglom_label.argtypes = [ctypes.c_int64, i32, ctypes.c_int,
                                      i32]
    return lib


def bond_init(lon, lat, R, crit_const, latlon, Rearth, max_bonds):
    """Cell-hashed bond table of n elements (float64 host arrays);
    returns ``(bond_idx (n, B) int32, bond_len (n, B) float64, n_bonds
    (n,) float64)``: partners in ascending index order, the first
    ``max_bonds`` kept, as the numpy route in
    :func:`.ops.forces.initialize_bonds_host` forms them.  ``crit_const``
    > 0 bonds below that distance, else below 1.25 (R_i + R_j)."""
    lib = library()
    n = len(lon)
    bond_idx = np.full((n, max_bonds), -1, np.int32)
    bond_len = np.zeros((n, max_bonds), np.float64)
    n_bonds = np.zeros((n,), np.float64)
    lib.kid_bond_init(n, np.ascontiguousarray(lon, np.float64),
                      np.ascontiguousarray(lat, np.float64),
                      np.ascontiguousarray(R, np.float64),
                      float(crit_const), int(bool(latlon)), float(Rearth),
                      int(max_bonds), bond_idx, bond_len, n_bonds)
    return bond_idx, bond_len, n_bonds


def conglom_label(bond_idx):
    """Connected components of a (n, B) bond table by union-find: 1-based
    ids in order of first appearance, 0 for unbonded elements."""
    lib = library()
    bond_idx = np.ascontiguousarray(bond_idx, np.int32)
    n, B = bond_idx.shape
    labels = np.zeros((n,), np.int32)
    lib.kid_conglom_label(n, bond_idx, B, labels)
    return labels

"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one compiler process per source, all started together, and the objects
are linked into one shared library with a plain C interface, at first
use, from the sources in this checkout only.  The library goes to ``_build/`` under a
name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.  ``-fmad=false`` keeps every
multiply and add separately rounded, as the reference's arithmetic is.

Nothing here runs at import time; :func:`library` builds and loads on
its first call and is cached for the life of the process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

from . import trace

_PKG = pathlib.Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                 "-fmad=false", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry points: name -> argtypes (each returns cudaGetLastError())
_SIGNATURES = {
    "ib_permute_cols": (_P, _P, _I, _P, _P, _L, _L, _P),
    "ib_pack_rows": (_P, _P, _I, _P, _L, _P),
    "ib_gather_rows": (_P, _L, _I, _P, _P, _L, _L, _P),
    "ib_k1_config": (_I, _I, _P, _P, _P),
    "ib_extract_sorted": (_P, _I, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
                          _I, _I, _I, _F, _F, _F, _F, _F, _P),
    "ib_extract_config": (_I, _I, _I, _I, _I, _I, _P, _P, _P),
    "ib_segment_spread_sums": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    "ib_segment_sums": (_P, _P, _L, _P, _P, _I, _I, _I, _I, _P),
    "ib_spread_config": (_I, _I, _I, _P, _P, _P),
    "ib_max_spread_extra": (),
    "ib_max_spread_slots": (),
    "ib_dem_substeps": (_P, _I, _I, _I, _P),
    "ib_dem_config": (_I, _I, _I, _P, _P),
    "ib_dem_args_size": (),
    "ib_prepass_sorted": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _F, _F, _F, _P, _P, _P, _P, _P),
    "ib_prepass_config": (_I, _I, _I, _I, _I, _P, _P, _P),
    "ib_pair_eval": (_P,) * 12 + (_I, _I, _I, _P, _P),
    "ib_pair_eval_config": (_I, _I, _P, _P, _P),
    "ib_interp_sorted": (_P, _I, _P, _P, _P, _I, _I, _P, _P),
}


def _sources():
    return sorted(p for p in SRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (on PATH or under /usr/local/cuda)")


def library_path() -> pathlib.Path:
    """Path of the built library for the current sources (may not exist)."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + ("-shared",)).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libicebergs_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the current sources are already built:
    one ``nvcc -c`` per source, run in parallel, then one link.  The
    compiler's resource report goes to ``<library>.log``.  A build that
    compiles is the span ``kid.kernels_build``."""
    out = library_path()
    if out.exists():
        return out
    with trace.span("kid.kernels_build"):
        return _compile(out)


def _compile(out: pathlib.Path) -> pathlib.Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cus]
    procs = [subprocess.Popen([_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(o),
                               str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for p, o in zip(cus, objs)]
    logs, failed = [], []
    for p, proc in zip(cus, procs):
        so, se = proc.communicate()
        logs.append(f"== {p.name}\n{so}{se}")
        if proc.returncode != 0:
            failed.append(f"{p.name} ({proc.returncode}):\n{se[-4000:]}")
    tmp = out.with_name(f"{tag}.tmp.so")
    if not failed:
        proc = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n"
                          f"{proc.stderr[-4000:]}")
    for o in objs:
        o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; the load and
    the signatures are the span ``kid.kernels_load``."""
    path = build()
    with trace.span("kid.kernels_load"):
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def resource_report() -> dict:
    """Each compiled function's registers, stack frame, spill stores and
    spill loads (bytes), keyed by its mangled name, parsed from the
    ``-Xptxas -v`` lines of the current library's build log (empty when
    there is no log)."""
    log = library_path().with_suffix(".log")
    if not log.exists():
        return {}
    out, name = {}, None
    for ln in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$.]+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

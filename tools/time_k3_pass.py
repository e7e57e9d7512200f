"""Time K3's pass-through (per-cell sums of given columns) at other shapes.

Builds ``icebergs_tpu_torch/csrc/segment_sums.cu`` once per shape (warps a
CTA x column slots a CTA x ranks loaded ahead of their adds), with the line
that fixes them replaced, each into its own library under
``icebergs_tpu_torch/_build/k3_pass/``, all compilers started together.
Then it times each library's call on ``chip_smoke.py``'s headline slab (1M
bergs on 512x512 cells, sorted) at the slot scatter spreading's 43 columns
(the 36 weighted products and 7 cell columns), in the slot tree and
sequentially, held bitwise to the plain version, beside
``torch.segment_reduce`` over the same columns and cells, in one process
on one card, and prints one JSON line per shape with its registers and
spills and ``--windows`` times (``device_ms``).  Needs one CUDA GPU:

    python3 tools/time_k3_pass.py [--shapes 4x64x8,8x64x4,8x64x8]
"""

from __future__ import annotations

import argparse
import array
import ctypes
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPE_LINE = "constexpr int CB = 32, NW = 4, FC = 64, U = 8;"


def build(shapes, out_dir):
    """One library per (warps, column slots, ranks ahead); returns each
    one's path and its kernels' ptxas lines."""
    from icebergs_tpu_torch import cuda_build
    src = (REPO / "icebergs_tpu_torch/csrc/segment_sums.cu").read_text()
    if SHAPE_LINE not in src:
        raise SystemExit(f"segment_sums.cu has no line {SHAPE_LINE!r}")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for nw, fc, u in shapes:
        cu = out_dir / f"k3p_{nw}x{fc}x{u}.cu"
        cu.write_text(src.replace(SHAPE_LINE, f"constexpr int CB = 32, "
                                  f"NW = {nw}, FC = {fc}, U = {u};"))
        so = cu.with_suffix(".so")
        procs.append((so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.COMPILE_FLAGS, "-shared", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    built = []
    for so, p in procs:
        out, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {so.name}:\n{err[-3000:]}")
        built.append((so, [ln.replace("ptxas info    :", "").strip()
                           for ln in (out + err).splitlines()
                           if re.search(r"Used \d+ registers|spill", ln)]))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="4x64x8,8x64x4,4x64x4,8x64x8,"
                    "4x64x16,2x64x8,4x32x8")
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args()
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.shapes.split(",")]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import icebergs_tpu_torch as ibp
    from icebergs_tpu_torch import cuda_build
    from icebergs_tpu_torch.ops import segment_spread as ss
    from icebergs_tpu_torch.ops import sorted as srt, spread as sp
    spec = importlib.util.spec_from_file_location("smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    built = build(shapes, cuda_build.BUILD_DIR / "k3_pass")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg, grid, frc, st0 = smoke.headline_world(ibp, torch, smoke.N_HEAD,
                                               smoke.NX_HEAD, device)
    st, cs = srt.sort_state_by_cell(st0, grid)
    w9, vals = sp.spread_products(st, grid, frc, cfg)
    cols = [wk * v for wk in w9 for v in vals] + sp.cell_columns(st, grid,
                                                                 cfg)
    M = torch.stack(cols)
    K = cfg.reprod_max_per_cell
    ncells, F = cs.numel() - 1, len(cols)
    ref = {t: ss._sums_plain(M, cs, K, t) for t in (True, False)}
    occ = (cs[1:] - cs[:-1]).to(torch.int64)
    data = M[:, int(cs[0]):int(cs[-1])].T.contiguous()
    ptrs = array.array("Q", [c.data_ptr() for c in cols])
    S = torch.empty(ncells, F, dtype=torch.float32, device=device)
    print(smi)
    print(json.dumps(dict(columns=F, cells=ncells, rows=int(cs[-1]), K=K,
                          bound_ms=smoke.bound(4 * int(cs[-1]) * F
                                               + smoke.nbytes(cs, S),
                                               0.)[0])))
    for (nw, fc, u), (so, ptxas) in zip(shapes, built):
        fn = ctypes.CDLL(str(so)).ib_segment_sums
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p] + [
                           ctypes.c_int] * 4 + [ctypes.c_void_p]
        res = dict(warps=nw, column_slots=fc, ranks_ahead=u, ptxas=ptxas)
        for tree in (True, False):
            def call():
                cuda_build.check(fn(
                    ptrs.buffer_info()[0], None, 0, cs.data_ptr(),
                    S.data_ptr(), ncells, F, K, int(tree),
                    cuda_build.stream_ptr(device)), "segment_sums")
            call()
            torch.cuda.synchronize()
            if not torch.equal(S, ref[tree]):
                raise SystemExit(f"shape {nw}x{fc}x{u}, tree {tree}: "
                                 "differs from the plain version")
            res["ms_tree" if tree else "ms_seq"] = [
                smoke.device_ms(torch, call) for _ in range(args.windows)]
        res["segment_reduce_ms"] = smoke.cuda_ms(
            torch, lambda: torch.segment_reduce(data, "sum", lengths=occ,
                                                axis=0))
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

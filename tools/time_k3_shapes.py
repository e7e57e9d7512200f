"""Time K3, the spreading segment sums, at other launch shapes.

Builds ``icebergs_tpu_torch/csrc/segment_spread.cu`` once per shape (cells
per CTA x threads x the CTAs per SM its launch bounds ask for), with the
line that fixes them replaced, each into its own library under
``icebergs_tpu_torch/_build/k3_shapes/``, all compilers started together.
Then it times each library's K3 call (window flags and sums) on
``chip_smoke.py``'s headline slab (1M bergs on 512x512 cells, sorted,
with the thermodynamics' melt columns) at 3 and 14 payload columns, held
bitwise to the plain version, in one process on one card, and prints one
JSON line per shape with its registers and spills and ``--windows``
times (``device_ms``).  Needs one CUDA GPU:

    python3 tools/time_k3_shapes.py [--shapes 32x256x5,32x256x4,16x128x10]
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
SHAPE_LINE = "constexpr int CB = 32, NT = 256, MIN_CTAS = 5;"


def build(shapes, out_dir):
    """One library per (cells, threads, CTAs per SM); returns each one's
    path and its kernels' ptxas lines."""
    from icebergs_tpu_torch import cuda_build
    src = (REPO / "icebergs_tpu_torch/csrc/segment_spread.cu").read_text()
    if SHAPE_LINE not in src:
        raise SystemExit(f"segment_spread.cu has no line {SHAPE_LINE!r}")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for cb, nt, mb in shapes:
        cu = out_dir / f"k3_{cb}x{nt}x{mb}.cu"
        cu.write_text(src.replace(SHAPE_LINE, f"constexpr int CB = {cb}, "
                                  f"NT = {nt}, MIN_CTAS = {mb};"))
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
    ap.add_argument("--shapes", default="32x256x5,32x256x4,32x256x6,"
                    "32x256x8,32x128x8,16x128x10,16x128x16,16x256x4")
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
    from icebergs_tpu_torch.ops import sorted as srt, thermo
    spec = importlib.util.spec_from_file_location("smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    built = build(shapes, cuda_build.BUILD_DIR / "k3_shapes")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg, grid, frc, st0 = smoke.headline_world(ibp, torch, smoke.N_HEAD,
                                               smoke.NX_HEAD, device)
    st, cs = srt.sort_state_by_cell(st0, grid)
    st_t, melt = thermo.thermodynamics(st, grid, frc, cfg)
    tbl = ss.cell_tables(grid)
    ncells = tbl.shape[1]
    bad = torch.empty(-(-ncells // 128), dtype=torch.bool, device=device)
    nbad = torch.empty((), dtype=torch.int32, device=device)
    print(smi)
    for (cb, nt, mb), (so, ptxas) in zip(shapes, built):
        fn = ctypes.CDLL(str(so)).ib_segment_spread_sums
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        res = dict(cells=cb, threads=nt, min_ctas=mb, ptxas=ptxas)
        for ne in (3, 14):
            _, rows = ss.build_rows(st_t, grid, frc, cfg,
                                    melt.deferred_cols[:ne],
                                    key_alive=st.alive)
            M = torch.stack(rows)
            ref = ss.segment_spread_sums_plain(M, cs, tbl, cfg)
            S = torch.empty_like(ref)
            ptrs = array.array("Q", [r.data_ptr() for r in list(M)[1:]])
            wl = ss.window_lanes(M.shape[1], ncells)

            def call():
                cuda_build.check(fn(
                    ptrs.buffer_info()[0], cs.data_ptr(), tbl.data_ptr(),
                    S.data_ptr(), bad.data_ptr(), nbad.data_ptr(), ncells,
                    ne, 128, wl, cfg.reprod_max_per_cell,
                    int(cfg.use_old_spreading), 0,
                    cuda_build.stream_ptr(device)), "segment_spread_sums")
            call()
            torch.cuda.synchronize()
            if not torch.equal(S, ref):
                raise SystemExit(f"shape {cb}x{nt}x{mb}, n_extra {ne}: "
                                 "differs from the plain version")
            res[f"ms_extra{ne}"] = [smoke.device_ms(torch, call)
                                    for _ in range(args.windows)]
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

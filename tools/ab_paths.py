"""Time the main paths of the contact searches (K2, K5) and K3's
pass-through, in another version of this package.

Runs ``chip_smoke.py``'s own phase functions, at its full sizes, for the
paths that launch K2 (5 the fast lane, 9a with K2's pair epilogue, 9b
with the slot scatter, also K3's pass-through, 10a the coupled entry),
K3's pass-through (9b, 10a, 11c the coupled entry with MTS, 12b), K2's
lat-lon forms (12a the lat-lon fast lane, 12b the coupled entry on the
tripolar grid, 12c the DEM world on a lat-lon grid) or K5's (12af the
lat-lon persistent ``fused`` lane with K6), K4's forms (6 the DEM world,
12c, 14b the DEM world packed hexagonally) or the stand-alone driver (13a
on the headline world, 13b on the DEM world, each launching K2 once a
step), with the package found under
``--root``: this checkout by default, or an unpacked copy of another
commit inside it.  Each path gives its wall time (median and windows),
the profiled window's device time and kernel count (the driver paths:
seconds a step over the driver's own loop, no profile), its checksum and
the launches of K2, K5 and K3's pass-through, one JSON line a path.  Run it
for a parent and a change in turns (parent, change, change, parent) in
one call, so that both are timed on one card.  A path may be named twice,
the second run timed warm.  Needs one CUDA GPU:

    python3 tools/ab_paths.py [--root DIR] [--paths 5,6,9a,9b,10a,12a,...]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PATHS = ("5", "6", "9a", "9b", "10a", "11c", "12a", "12af", "12b", "12c",
         "13a", "13b", "14b")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout inside this one whose package runs")
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    if root != REPO and REPO not in root.parents:
        ap.error(f"--root {root} is not inside {REPO}")
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"--paths: choose from {','.join(PATHS)}")

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import icebergs_tpu_torch as ibp
    from icebergs_tpu_torch import cuda_build
    from icebergs_tpu_torch.ops import pairs
    # the kernels' build first, so that no path's times hold it
    cuda_build.library()
    spec = importlib.util.spec_from_file_location("smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    kernels = smoke.kernel_counters()
    kernels["eval_pair_ia_kernel/m400"] = smoke._ByM(
        pairs.eval_pair_ia_kernel, 25 * smoke.MTS_MAX_PER_CELL)
    rel = str(root.relative_to(REPO)) or "."

    def report(tag, res, launches):
        wall = res.get("ms_per_step", res.get("s_per_outer_step",
                                              res.get("s_per_step")))
        print(json.dumps(dict(
            path=tag, root=rel, wall=wall,
            windows=res.get("windows_ms", res.get("windows_s")),
            device_ms=res.get("device_kernel_ms_per_step",
                              res.get("device_kernel_ms_per_outer_step")),
            kernels=res.get("kernels_per_step",
                            res.get("kernels_per_outer_step")),
            berg_chksum=res.get("berg_chksum"),
            steps=res.get("steps", res.get("outer_steps")),
            launches={k: launches[k] for k in (
                "extract_sorted", "extract_sorted/epilogue",
                "contact_prepass_sorted", "segment_spread_sums/assoc",
                "dem_substeps")})),
            flush=True)

    for tag in paths:
        if tag == "5":
            res, launches, _ = smoke.phase_path(
                ibp, torch, device, kernels, "fast_lane", profile=True)
        elif tag in ("9a", "9b"):
            _, label, ckw, mkw, _ = next(p for p in smoke.ITEM15_PATHS
                                         if p[0] == tag)
            res, launches, _ = smoke.phase_path(
                ibp, torch, device, kernels, label, cfg_kw=ckw,
                multi_kw=mkw, profile=True)
        elif tag == "10a":
            res, launches = smoke.phase_coupled(ibp, torch, device, kernels,
                                                profile=True)
        elif tag == "11c":
            dcfg = smoke.dem_config(ibp)
            dem = smoke.dem_world(ibp, torch, dcfg, smoke.DEM_UNITS,
                                  smoke.NX_DEM, device)
            res, launches = smoke.phase_mts_coupled(ibp, torch, device,
                                                    kernels, dcfg, dem)
            del dem
        elif tag in ("12a", "12af"):
            world = smoke.ll_world(ibp, torch, smoke.N_HEAD, smoke.LL_NX,
                                   smoke.LL_NY, device)
            fused = tag == "12af"
            res, launches, _ = smoke.phase_path(
                ibp, torch, device, kernels,
                "ll_persistent_fused_kernel" if fused else "ll_fast_lane",
                cfg_kw=dict(interp_mode="kernel") if fused else None,
                multi_kw=dict(neighbor_mode="fused") if fused else None,
                world=world, profile=True)
            del world
        elif tag == "12b":
            tw = smoke.tripolar_world(ibp, torch, smoke.TRI_NX, smoke.TRI_NY,
                                      smoke.N_HEAD, smoke.COUPLED_CAP,
                                      device)
            res, launches = smoke.phase_coupled(
                ibp, torch, device, kernels, world=tw,
                label="12b tripolar coupled", profile=True,
                check=smoke.in_cells(torch, tw[1]))
            del tw
        elif tag == "13a":
            res, launches = smoke.phase13a(ibp, torch, device, kernels)
        elif tag == "13b":
            res, launches = smoke.phase13b(ibp, torch, device, kernels,
                                           smoke.dem_config(ibp))
        else:                           # the DEM worlds: 6, 12c, 14b
            kw, wkw, k3 = {"6": ({}, {}, "segment_spread_sums"),
                           "12c": (smoke.LL_CFG, {"latlon": True},
                                   "segment_spread_sums"),
                           "14b": (smoke.HEX_DEM_KW, {"hexagonal": True},
                                   "segment_spread_sums/assoc")}[tag]
            dcfg = smoke.dem_config(ibp, **kw)
            dem = smoke.dem_world(ibp, torch, dcfg, smoke.DEM_UNITS,
                                  smoke.NX_DEM, device, **wkw)
            res, launches = smoke.phase_dem_slice(
                ibp, torch, device, kernels,
                ("permute_cols_u32", "extract_sorted", k3, "dem_substeps"),
                dcfg, dem, label=f"{tag} dem", profile=True)
            del dem
        report(tag, res, launches)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host profile of one headline path, in another version of this package.

Builds ``chip_smoke.py``'s headline world (1M bergs, 512x512 cells of
2 km) and runs it through ``make_multi_step`` (``--mode``: a per-step
neighbour mode, or ``persistent`` for the fast lane) with the package
found under ``--root``: this checkout by default, or an unpacked copy of
another commit inside it, so that two versions are compared in one run
on one card.  After a warm-up window (the fallback cap grown as
``chip_smoke.py`` grows it) it times ``--windows`` windows of 8 steps,
then runs one more under cProfile.  Prints one JSON line: the windows'
ms/step, the profiled window's, and the ``--top`` functions by their own
host time in it (calls, own and cumulative ms, per step).  Needs one
CUDA GPU:

    python3 tools/host_profile.py [--root DIR] [--mode fused3] [--top 25]
"""

from __future__ import annotations

import argparse
import cProfile
import importlib.util
import json
import pathlib
import pstats
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout inside this one whose package runs")
    ap.add_argument("--mode", default="fused3",
                    help="fused3, fused, buckets or persistent")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    if root != REPO and REPO not in root.parents:
        ap.error(f"--root {root} is not inside {REPO}")

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import icebergs_tpu_torch as ibp
    spec = importlib.util.spec_from_file_location("smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg, grid, frc, st = smoke.headline_world(ibp, torch, smoke.N_HEAD,
                                              smoke.NX_HEAD, device)
    kw = {}
    if args.mode != "persistent":
        kw = dict(persistent=False, neighbor_mode=args.mode)
    if args.mode == "buckets":
        kw["max_per_cell"] = smoke.MAX_PER_CELL
    inner = smoke.INNER
    for _ in range(4):
        multi = ibp.make_multi_step(grid, cfg, inner, with_stats=True, **kw)
        dropped = int(multi(st, frc)[1])
        if dropped == 0:
            break
        cfg = cfg.replace(fused_fallback_cap=min(
            max(4 * cfg.fused_fallback_cap,
                1 << (cfg.fused_fallback_cap + dropped).bit_length()),
            smoke.N_HEAD))
    times = []
    for _ in range(args.windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(st, frc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    multi(st, frc)
    torch.cuda.synchronize()
    prof.disable()
    t_prof = (time.perf_counter() - t0) * 1e3 / inner
    stats = pstats.Stats(prof).stats
    own = sum(v[2] for v in stats.values())
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:args.top]
    print(json.dumps(dict(
        root=str(root.relative_to(REPO)) or ".", mode=args.mode,
        ms_per_step=times, profiled_ms_per_step=t_prof,
        own_ms_per_step=own * 1e3 / inner, top=[dict(
            fn=f"{pathlib.Path(f).name}:{line}:{name}", calls=nc / inner,
            own_ms=tt * 1e3 / inner, cum_ms=ct * 1e3 / inner)
            for (f, line, name), (_, nc, tt, ct, _) in top],
        device=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

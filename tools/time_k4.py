"""Time K4, the DEM substep kernel, in another version of this package.

Runs ``chip_smoke.py`` phase 3's K4 case (the 999,944-element DEM world of
``tools/bench_dem_1m.py``, each element moved by up to 8 m, 60 substeps,
held bitwise to the plain version) with the package found under
``--root``: this checkout by default, or an unpacked copy of another
commit inside it (e.g. ``git archive`` into a directory ``.gitignore``
lists), so that two versions are timed in one run on one card.
``--world`` picks the worlds: ``dem`` (phase 6's), ``latlon`` (the same
on phase 12c's lat-lon grid) and ``hex`` (phase 14b's hexagonally packed
one, six bonds an element).  For each world, each of ``--lw``
(constant_interaction_LW on, off) and each of ``--variants`` in the
order given (``auto``: the instantiation the configuration takes;
``generic`` or another name of the package's, where it has it; name one
twice to time in turns, e.g. ``generic,auto,auto,generic``) prints one
JSON line with the mean time of each of ``--windows`` windows of 5
launches.  Needs one CUDA GPU:

    python3 tools/time_k4.py [--root DIR] [--world dem,latlon,hex]
        [--lw 1,0] [--variants auto,generic]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout inside this one whose package is timed")
    ap.add_argument("--world", default="dem",
                    help="worlds, comma-separated: dem, latlon, hex")
    ap.add_argument("--lw", default="1", help="constant_interaction_LW "
                    "values, comma-separated")
    ap.add_argument("--variants", default="auto")
    ap.add_argument("--windows", type=int, default=3)
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
    from icebergs_tpu_torch.ops import dem_substeps as k4
    spec = importlib.util.spec_from_file_location("smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    worlds = {"dem": ({}, {}), "latlon": (smoke.LL_CFG, {"latlon": True}),
              "hex": (smoke.HEX_DEM_KW, {"hexagonal": True})}
    for w in args.world.split(","):
        kw, wkw = worlds[w]
        cfg = smoke.dem_config(ibp, **kw)
        _, _, st, deltas, n = smoke.dem_world(
            ibp, torch, cfg, smoke.DEM_UNITS, smoke.NX_DEM, device, **wkw)
        s4 = smoke.k4_state(torch, st, device, latlon=w == "latlon")
        del st
        for lw in (int(x) for x in args.lw.split(",")):
            c = smoke.dem_config(ibp, constant_interaction_LW=bool(lw), **kw)
            for v in args.variants.split(","):
                r = [smoke.k4_run(torch, k4, s4, c, deltas,
                                  None if v == "auto" else v)
                     for _ in range(args.windows)]
                print(json.dumps(dict(
                    root=str(root.relative_to(REPO)) or ".", world=w, lw=lw,
                    variant=v, launched=k4.instantiation(c, s4.max_bonds)
                    if v == "auto" else v, ms=[x[4] for x in r],
                    bitwise=True, nbroken=int(r[0][1]), elements=n,
                    substeps=c.n_sub_steps, device=smi)), flush=True)
        del s4
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

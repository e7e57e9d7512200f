"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--no-control] [--out FILE]

For each seed: one episode of the port's timed path after a warm-up
episode (the lower reading: what a sound run gives), then the reference's
episode, then the control's, the reference with its berg state stored in
bfloat16 (the upper reading: what the next precision down gives), each
compared with the reference as ``correct`` compares.  One JSON line a
seed.  The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import pathlib
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from benchmark import harness, reference  # noqa: E402


def program_answer(cell, conf, seed, device):
    """The port's answer for one episode after a warm-up episode, as the
    timed path's window produces it."""
    import importlib

    import torch
    program = importlib.import_module(harness.PROGRAM)
    steps = cell.traffic["episode_steps"]
    world = cell.world.build(program, conf, seed, device)
    sim = cell.entry.Sim(program, world, cell.traffic, seed)
    for _ in range(2):
        s, outs = sim.start(), []
        for _ in range(steps):
            before = s
            s, o = sim.step(s)
            outs.append(o)
    ans = sim.answer(before, s, outs)
    del sim, world, s, outs, o, before
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ans


def readings(cell, seed, device, overrides=None, control=True):
    """``{"program": numbers, "control": numbers, ...}`` for one seed."""
    conf = harness.merge(cell.config, overrides)
    steps = cell.traffic["episode_steps"]
    t0 = time.perf_counter()
    prog = program_answer(cell, conf, seed, device)
    t1 = time.perf_counter()
    entry = cell.traffic["entry"]
    ref = reference.run(entry, cell.world, conf, seed, device, steps,
                        judged=prog)
    t2 = time.perf_counter()
    nums, worst = reference.numbers(entry, prog, ref)
    out = dict(seed=seed, program=nums, program_worst=worst,
               program_s=t1 - t0, reference_s=t2 - t1)
    if control:
        low = reference.run(entry, cell.world, conf, seed, device, steps,
                            lower=True)["own"]
        ref = reference.run(entry, cell.world, conf, seed, device, steps,
                            judged=low)
        nums, worst = reference.numbers(entry, low, ref)
        out.update(control=nums, control_worst=worst)
    return out


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--out")
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(a.workload)
    for seed in map(int, a.seeds.split(",")):
        r = readings(cell, seed, torch.device("cuda", 0),
                     control=not a.no_control)
        r["workload"] = cell.name
        line = json.dumps(r, default=float)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

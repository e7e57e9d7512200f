"""Where a benchmark cell's coupling step goes, phase by phase, and what
the port's tracer costs.

Builds the cell's world and entry from the benchmark's own files
(``benchmark/worlds``, ``benchmark/entries``) and warms one episode,
then:

- ``--capture N``: one CPU+CUDA ``torch.profiler`` capture of N steps
  from the episode's start, summarised by ``trace.by_phase``: for each
  span, calls, host ms, kernels, device busy and idle ms and its
  heaviest kernels, a step; and the share of the steps' kernels launched
  inside a leaf span (a phase, not ``kid.run`` itself);
- ``--pairs P``: the tracer's cost.  P rounds, the settings in a rotated
  order each round, of a window of ``--seconds`` of episodes with the
  tracer off, at its default and with the device's clock (``step_ms``:
  the window over its steps, as the benchmark reads it); then P rounds of
  one episode under the profiler's device-only trace (the benchmark's
  traced stretch) with the tracer off and at its default, last, since a
  process that has run the profiler steps slower afterwards; then the
  host's cost of one empty span in each setting, timed over many.

Prints one JSON line per part.  Needs one CUDA GPU:

    python3 tools/phase_table.py [--workload om4_coupled.1m] [--seed N]
        [--capture 8] [--pairs 5] [--seconds 10]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
WINDOWED = {"off": dict(enabled=False), "default": {},
            "device": dict(device=True)}
TRACED = {"off_traced": dict(enabled=False), "default_traced": {}}


def quartiles(v):
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return dict(median=statistics.median(v), q1=q[0], q3=q[2],
                runs=[round(x, 4) for x in v])


def capture(sim, steps, torch, trace):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        s = sim.start()
        for _ in range(steps):
            s, _ = sim.step(s)
        torch.cuda.synchronize()
    table = trace.by_phase(prof.events())
    rows = {n: dict(calls=r["calls"] / steps, host_ms=r["host_ms"] / steps,
                    kernels=r["kernels"] / steps,
                    busy_ms=r["busy_ms"] / steps,
                    idle_ms=r["idle_ms"] / steps,
                    top=[(k, ms / steps) for k, ms in r["top"]])
            for n, r in table.items()}
    inside = sum(r["kernels"] for n, r in table.items()
                 if n != trace.OUTSIDE)
    leaf = inside - table.get("kid.run", {}).get("kernels", 0)
    return dict(part="by_phase", steps=steps, phases=rows,
                leaf_share=leaf / inside if inside else None,
                outside_kernels=table.get(trace.OUTSIDE,
                                          {}).get("kernels", 0))


def overhead(sim, steps, pairs, seconds, torch, trace, harness, device):
    from torch.profiler import ProfilerActivity
    clock = harness.Clock(torch, device)
    got = {n: [] for n in list(WINDOWED) + list(TRACED)}
    for settings, traced in ((WINDOWED, False), (TRACED, True)):
        names = list(settings)
        for k in range(pairs):
            for name in names[k % len(names):] + names[:k % len(names)]:
                prev = trace.configure(**settings[name])
                ctx = (torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA]) if traced
                    else contextlib.nullcontext())
                with ctx:
                    rec, *_ = harness.window(sim, steps,
                                             0. if traced else seconds,
                                             clock)
                trace.configure(**prev)
                got[name].append(rec["wall_s"] * 1e3 / rec["steps"])
    span_us = {}
    n = 100_000
    for name, kw in WINDOWED.items():
        prev = trace.configure(**kw)
        t = time.perf_counter()
        for _ in range(n):
            with trace.span("kid.cost"):
                pass
        span_us[name] = (time.perf_counter() - t) / n * 1e6
        trace.configure(**prev)
    return dict(part="overhead", pairs=pairs, seconds=seconds,
                step_ms={k: quartiles(v) for k, v in got.items()},
                span_us=span_us, totals=trace.totals())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="om4_coupled.1m")
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--capture", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=10.)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import icebergs_tpu_torch as kid
    from benchmark import harness
    from icebergs_tpu_torch import trace

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(part="device", smi=smi, torch=torch.__version__,
                          cuda=torch.version.cuda)), flush=True)
    cell = harness.Cell(args.workload)
    world = cell.world.build(kid, cell.config, args.seed, device)
    sim = cell.entry.Sim(kid, world, cell.traffic, args.seed)
    steps = cell.traffic["episode_steps"]
    s = sim.start()
    for _ in range(steps):
        s, _ = sim.step(s)
    torch.cuda.synchronize()
    if args.capture:
        print(json.dumps(capture(sim, args.capture, torch, trace)),
              flush=True)
    if args.pairs:
        print(json.dumps(overhead(sim, steps, args.pairs, args.seconds,
                                  torch, trace, harness, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

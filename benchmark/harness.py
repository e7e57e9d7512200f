"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference and the result line.

The window replays episodes: the cell's first ``episode_steps`` steps
from the seeded initial state, started again from that state at each
episode's start, for at least ``--seconds`` of the host's clock.  Replay
keeps the work steady: every episode does the same work from the same
state, whatever the run's length, and the bergs stay where the cell put
them.  A
CUDA event is recorded at the end of every step, at the entry's own
step boundary, and read after the window; a step's time is the interval
between consecutive step ends.
"""

import argparse
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time
import types

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "icebergs_tpu_torch"
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "icebergs_tpu")
BIG = 1e308                # a compared number that is not finite


def load_json(path):
    with open(path) as f:
        return json.load(f)


def merge(base, over):
    """``base`` with the nested dict ``over`` written over it."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


class Cell:
    """A cell of ``BENCHMARK.json`` with everything it names, found by
    name under the benchmark's folder."""

    def __init__(self, name, root=ROOT):
        bench = load_json(root / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"unknown workload {name!r}")
        w = found[0]
        self.name, self.chips = name, w["chips"]
        self.config = load_json(BENCH / "configs" / f"{w['config']}.json")
        self.traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(BENCH / "workloads" / f"{name}.json"
                                )["limits"]
        self.entry = importlib.import_module(
            f"benchmark.entries.{self.traffic['entry']}")
        self.world = importlib.import_module(
            f"benchmark.worlds.{self.config['world']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in e2e]


def reader(name):
    """The metric reader ``metrics/<name>.py``, or the one of the name's
    stem (the part before the first dot): its ``read(ctx)``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
    """Step ends on the device's own timeline: CUDA events on the card,
    the host's clock after the step on the CPU (where a call returns
    when its work is done)."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def intervals_ms(self, marks):
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


def stack_counters(torch, rows):
    """The window's per-step counters as ``{name: [float, ...]}``, read
    once the window has closed."""
    out = {}
    for name in rows[0] if rows else ():
        vals = [r[name] for r in rows]
        if all(v is None for v in vals):
            continue
        ts = [v for v in vals if torch.is_tensor(v)]
        if len(ts) == len(vals):
            out[name] = torch.stack(ts).double().cpu().tolist()
        else:
            out[name] = [float(v) for v in vals if v is not None]
    return out


def window(sim, steps, seconds, clock):
    """Episodes of ``steps`` steps from ``sim.start()`` until ``seconds``
    of the host's clock have passed; returns the window's record and the
    last episode's final state, its outputs, and the state its last step
    started from (each step's input, held until the next step takes
    its own)."""
    marks, host_ms, counters = [clock.mark()], [], []
    t0 = time.perf_counter()
    episodes = 0
    while True:
        s, outs = sim.start(), []
        for _ in range(steps):
            h = time.perf_counter()
            before = s
            s, o = sim.step(s)
            host_ms.append((time.perf_counter() - h) * 1e3)
            marks.append(clock.mark())
            counters.append(sim.counters(o))
            outs.append(o)
        episodes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, episodes=episodes, steps=len(host_ms),
                host_ms=host_ms, step_ms=clock.intervals_ms(marks),
                counters=counters), s, outs, before


def run_cell(cell, seed, seconds, trace, device, t0, overrides=None,
             fault=None):
    """One run of ``cell`` on ``device``; returns the result line (the
    compared numbers and their limits last) and the worst fields of the
    comparison.  ``overrides``
    rewrites the configuration (the CPU tests' small sizes); ``fault``
    wraps the entry's simulation (the tests' broken timed paths)."""
    import torch

    from . import profiled, reference

    program = importlib.import_module(PROGRAM)
    conf = merge(cell.config, overrides)
    steps = cell.traffic["episode_steps"]
    clock = Clock(torch, device)
    world = cell.world.build(program, conf, seed, device)
    sim = cell.entry.Sim(program, world, cell.traffic, seed)
    if fault is not None:
        sim = fault(sim)
    s = sim.start()
    for _ in range(steps):                      # warm-up: one episode
        s, _ = sim.step(s)
    clock.sync()
    setup_s = time.perf_counter() - t0

    rec, s, outs, before = window(sim, steps, seconds, clock)
    prog = sim.answer(before, s, outs)
    counters = stack_counters(torch, rec.pop("counters"))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced = None
    if trace:
        n_tr = cell.traffic["trace_steps"]

        def stretch(n):
            def run():
                st = sim.start()
                for _ in range(n):
                    st, _ = sim.step(st)
            return run
        traced = profiled.profile(stretch(n_tr), stretch(min(n_tr, 2)))
        traced["steps"] = n_tr
    del sim, world, s, outs, before
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    entry = cell.traffic["entry"]
    ref = reference.run(entry, cell.world, conf, seed, device, steps,
                        judged=prog)
    nums, worst = reference.numbers(entry, prog, ref)
    missing = set(cell.limits) ^ set(nums)
    if missing:
        raise SystemExit(f"{cell.name}: numbers and limits differ: "
                         f"{sorted(missing)}")
    correct = all(nums[k] <= cell.limits[k] for k in nums)

    # what the metric readers read: the window's steps, their times and
    # the program's counters; the traced stretch; the configuration and
    # what the entry's reference hands them (``readers``, which it may
    # leave out)
    ctx = types.SimpleNamespace(trace=traced, counters=counters, conf=conf,
                                **ref.get("readers", {}), **rec)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = setup_s if m["name"] == "setup_s" else reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=rec["steps"],
                failed=0 if correct else steps, metrics=metrics, device=dev)
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        line["breakdown"] = dict(device_ops=traced["device_ops"],
                                 idle_gaps=traced["idle_gaps"])
    line["checks"] = {k: dict(value=finite(v), limit=cell.limits[k])
                      for k, v in nums.items()}
    return line, worst


def finite(v):
    v = float(v)
    return v if math.isfinite(v) else BIG


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv, t0):
    args = parse(argv)
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line, worst = run_cell(cell, args.seed, args.seconds, args.trace,
                           torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: it may not load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    print(f"worst fields: {worst}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0

"""A configuration goes into the benchmark as new files.

A copy of the benchmark gains a third configuration that shares nothing
with the others: its own world (with its own small size for the CPU),
entry, reference (with its own comparison), traffic, limits and metric
reader, each a new file, and its cell in ``BENCHMARK.json``, the one
file it had that changes.  The layout checks and a small run of the new
cell then pass in the copy, run from it in fresh processes, and no
other file of the copy has changed."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "stub_decay.small"

# the new configuration's files, under the copy's ``benchmark/``
FILES = {
    "configs/stub_decay.json": json.dumps({
        "source": "https://doi.org/10.1029/2019MS001726",
        "world": "stub_decay", "precision": "float32",
        "n": 4096, "dt": 600.0, "rate": 1e-5, "forcing": 2e-3,
        "assumed": ["a field relaxing to its forcing: a stand-in "
                    "configuration for the layout's own test"]}),
    "traffic/stub_run_4.json": json.dumps({
        "entry": "stub_relax", "episode_steps": 4, "trace_steps": 4}),
    "workloads/stub_decay.small.json": json.dumps({
        "limits": {"field_gap": 1e-5}}),
    "worlds/stub_decay.py": '''
        """A field of ``n`` values drawn from the seed, and its forcing."""

        import types

        import torch

        TINY = {"n": 64}
        VARIANTS = {"plain": {}, "fast": {"rate": 1e-3}}


        def inputs(conf, seed, device):
            gen = torch.Generator(device=device).manual_seed(seed % 2**63)
            x = torch.rand(conf["n"], generator=gen, device=device)
            return types.SimpleNamespace(x=x, dt=conf["dt"],
                                         rate=conf["rate"],
                                         forcing=conf["forcing"])


        def build(kid, conf, seed, device):
            return inputs(conf, seed, device)
        ''',
    "entries/stub_relax.py": '''
        """One relaxation step a call, in float32."""

        from . import answers


        class Sim:
            def __init__(self, kid, world, traffic, seed):
                self.w = world

            def start(self):
                return self.w.x

            def step(self, x):
                w = self.w
                x = x + w.dt * (w.forcing - w.rate * x)
                return x, dict(total=x.sum())

            @staticmethod
            def counters(out):
                return dict(stub_total=out["total"])

            @staticmethod
            def answer(before, x, outs):
                return dict(field=answers.host(x))
        ''',
    "reference/stub_relax.py": '''
        """The relaxation in float64, and its comparison."""

        import numpy as np
        import torch


        def run(x, conf, world, steps, device, lower=False, judged=None):
            f = x.x.to(torch.float64)
            for _ in range(steps):
                f = f + x.dt * (x.forcing - x.rate * f)
                if lower:
                    f = f.to(torch.bfloat16).to(torch.float64)
            out = dict(field=f.cpu().numpy())
            return dict(out, own=out) if lower else out


        def numbers(judged, ref):
            r = ref["field"]
            gap = np.abs(judged["field"] - r).max() / np.abs(r).max()
            return dict(field_gap=float(gap)), dict(field="field")
        ''',
    "metrics/stub_total.py": '''
        """The program's counter of the field's sum, over the window."""

        from benchmark import readings


        def read(ctx):
            return readings.counter(ctx, "stub_total")
        ''',
}

RUN = """
import sys, time, torch
from benchmark import control, harness
cell = harness.Cell({cell!r})
for v in cell.world.VARIANTS.values():
    small = harness.merge(cell.world.TINY, v)
    line, _ = harness.run_cell(cell, 2**31 + 5, 0.1, 0, torch.device("cpu"),
                               time.perf_counter(), overrides=small)
    assert line["correct"] is True, line
    assert set(line["metrics"]) == {{"setup_s", "step_ms"}}, line
    r = control.readings(cell, 7, torch.device("cpu"), overrides=small)
    assert r["program"]["field_gap"] <= cell.limits["field_gap"], r
    assert r["control"]["field_gap"] > cell.limits["field_gap"], r
print("ran", harness.reader("stub_total.stub").__module__)
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_configuration_goes_in_as_new_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    for rel, text in FILES.items():
        path = tmp_path / "benchmark" / rel
        assert not path.exists(), rel
        path.write_text(textwrap.dedent(text).lstrip())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name="stub_decay", source="https://doi.org/10.1029/2019MS001726",
        file="benchmark/configs/stub_decay.json", reduced=[],
        why="a stand-in configuration with its own world, entry and "
            "reference"))
    spec["workloads"].append(dict(
        name=CELL, config="stub_decay", traffic="stub_run_4", chips=1,
        why="a stand-in cell: 4-step episodes of a relaxation"))
    for m in spec["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append(CELL)
    spec["per_layer"].append(dict(
        name="stub_total.stub", unit="m", better="lower",
        source="program_counter", layer="stub", moves="step_ms",
        workloads=[CELL]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))

    # the copy's ``benchmark`` first, the port from the checkout
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_layout.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for case in (f"test_cell_resolves[{CELL}]",
                 "test_no_jax_imports[reference/stub_relax.py]"):
        assert f"{case} PASSED" in out.stdout, case
    out = subprocess.run([sys.executable, "-c", RUN.format(cell=CELL)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ran benchmark_metric_" \
        "stub_total_stub"

    after = _digests(tmp_path)
    changed = sorted(str(p) for p, d in before.items() if after.get(p) != d)
    assert changed == ["BENCHMARK.json"]

"""Each cell run on the CPU at the small size its world gives
(``TINY``, and each of its ``VARIANTS``) through the harness (its look
for a card skipped): a contract line with ``correct`` true; the same run
with the timed path broken underneath, and the lower-precision control,
with ``correct`` false; for each entry, no JAX and, in the reference,
nothing of the port loaded.  On a card, one short run of ``run.py``."""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from benchmark import control, faults, harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CPU = torch.device("cpu")
FOUND = {name: harness.Cell(name, root=ROOT) for name in CELLS}
# each cell with each variant of its world's small size
VARIANTS = [(name, v) for name, cell in FOUND.items()
            for v in cell.world.VARIANTS]
# the first cell of each entry
ENTRIES = {}
for name, cell in FOUND.items():
    ENTRIES.setdefault(cell.traffic["entry"], name)


def small(name, steps=2, variant=None):
    """The cell with short episodes, and its world's small size (with
    ``variant`` written over it)."""
    cell = harness.Cell(name, root=ROOT)
    cell.traffic = dict(cell.traffic, episode_steps=steps, trace_steps=1)
    tiny = cell.world.TINY
    if variant is not None:
        tiny = harness.merge(tiny, cell.world.VARIANTS[variant])
    return cell, tiny


@pytest.mark.parametrize("name,calving", VARIANTS,
                         ids=["-".join(v) for v in VARIANTS])
def test_cpu_run_prints_a_correct_line(name, calving):
    """A small run through the harness is correct under each variant of
    the world's small size (such as a discharge that spawns bergs every
    step, the spawns' ids, places and sizes then compared too)."""
    cell, tiny = small(name, steps=3, variant=calving)
    line, _ = harness.run_cell(cell, 2**31 + 11, 0.1, 0, CPU,
                               time.perf_counter(), overrides=tiny)
    text = json.dumps(line, allow_nan=False)
    back = json.loads(text)
    assert back["correct"] is True and back["failed"] == 0
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(back)
    assert list(back)[-1] == "checks"
    assert {m["name"] for m in cell.end_to_end} == set(back["metrics"])
    for c in back["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, kind):
    cell, tiny = small(name)
    line, _ = harness.run_cell(cell, 5, 0.1, 0, CPU, time.perf_counter(),
                               overrides=tiny, fault=faults.wrap(kind))
    assert line["correct"] is False
    assert line["failed"] == cell.traffic["episode_steps"]


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_control_is_not_correct(name):
    cell, tiny = small(name)
    r = control.readings(cell, 6, CPU, overrides=tiny)
    assert all(v <= cell.limits[k] for k, v in r["program"].items())
    assert any(v > cell.limits[k] for k, v in r["control"].items())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_jax_and_a_reference_free_of_the_port(entry):
    """A whole small run of a cell of the entry in a fresh process: no
    JAX module once the window has closed; the entry's reference's
    episode alone loads nothing of the port."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
from benchmark import harness, reference
cell = harness.Cell({ENTRIES[entry]!r})
cell.traffic = dict(cell.traffic, episode_steps=1)
small = cell.world.TINY
conf = harness.merge(cell.config, small)
reference.run(cell.traffic["entry"], cell.world, conf, 3,
              torch.device("cpu"), 1)
tops = {{m.split(".")[0] for m in sys.modules}}
assert "icebergs_tpu_torch" not in tops, "the reference loaded the port"
harness.run_cell(cell, 3, 0.1, 0, torch.device("cpu"), time.perf_counter(),
                 overrides=small)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card(tmp_path):
    """With no card the command prints no result and fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
def test_card_run(cuda, trace):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                          "--workload", CELLS[0], "--seed",
                          str(2**31 + 3), "--seconds", "2", "--trace",
                          str(trace)], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"

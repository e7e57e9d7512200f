"""BENCHMARK.json against the files it names and the contract's rules of
form; the benchmark's modules against the JAX package and the reference
against the port, by the top-level names of what they import."""

import ast
import json
import pathlib
import re

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "icebergs_tpu"}


def test_keys_and_forms():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        names += [w["config"], w["traffic"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    """Each cell finds its configuration, traffic, limits, entry, world
    (with its small sizes for the CPU), reference (with its comparison)
    and a reader for every metric it reports; each per-layer metric moves
    an end-to-end metric its cells report."""
    from benchmark import harness, reference
    cell = harness.Cell(w["name"], root=ROOT)
    entry = cell.traffic["entry"]
    assert (BENCH / "entries" / f"{entry}.py").exists()
    assert (BENCH / "worlds" / f"{cell.config['world']}.py").exists()
    assert isinstance(cell.world.TINY, dict)
    assert isinstance(cell.world.VARIANTS, dict) and cell.world.VARIANTS
    ref = reference.module(entry)
    assert callable(ref.run) and callable(ref.numbers)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] != "setup_s":
            assert callable(harness.reader(m["name"]))
    for m in SPEC["per_layer"]:
        if w["name"] in m.get("workloads", ()):
            assert m["moves"] in e2e, m["name"]


def _leaves(d, at=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, at + (k,))
        else:
            yield at + (k,), v


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_small_size_keeps_the_configuration(w):
    """The CPU tests' small sizes change only what they set: every other
    setting of the configuration (such as contacts off) stays."""
    from benchmark import harness
    cell = harness.Cell(w["name"], root=ROOT)
    for v in cell.world.VARIANTS.values():
        small = harness.merge(cell.world.TINY, v)
        sets = dict(_leaves(small))
        got = dict(_leaves(harness.merge(cell.config, small)))
        for k, val in _leaves(cell.config):
            assert got[k] == sets.get(k, val), k


def test_config_files():
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["assumed"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "icebergs_tpu_torch" not in tops, path
        assert not tops & FORBIDDEN, path


def test_trace_summary():
    """The device's busy union, the idle gaps named by the innermost host
    operation over them, and the stretch's length."""
    from benchmark import profiled
    dev = [(0., 10., "k1"), (5., 12., "k2"), (20., 30., "k1")]
    host = [(11., 25., "step"), (13., 19., "aten::add")]
    s = profiled.summarise(dev, host, (0., 40.))
    assert s["busy_s"] == 22e-6 and s["window_s"] == 40e-6
    assert s["device_ops"][0] == ["k1", 20e-6]
    assert s["idle_gaps"] == [["host outside any traced operation", 10e-6],
                              ["aten::add", 8e-6]]
    assert [k[0] for k in s["kernels"]] == ["k1", "k2", "k1"]

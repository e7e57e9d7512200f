"""The port's tracer (``icebergs_tpu_torch.trace``): the spans of the
coupled step and its tiled form, the profiler's view of them, the
attribution of a capture's kernels and idle time to the phases
(``by_phase``), and the benchmark's readers of the spans.  Small worlds of
``tests/torch_parallel_worlds.py`` on the CPU; no JAX."""

import types

import pytest
import torch

import torch_parallel_worlds as W
from benchmark import harness, spans
from icebergs_tpu_torch import trace

torch.set_num_threads(1)
CPU = torch.device("cpu")
PHASES = ["kid.calving", "kid.interp", "kid.contacts", "kid.evolve",
          "kid.thermo", "kid.spread", "kid.returns"]
SETUP = ["kid.create_bergs", "kid.model_init", "kid.init_state"]
# interactive bergs that calve footloose children: both yields of the step
FOOTLOOSE_CONTACTS = dict(W.INTERACTIVE, footloose=True, fl_style="new_bergs",
                          fl_youngs=1.e8, fl_strength=250.,
                          displace_fl_bergs=True)


@pytest.fixture
def tracer():
    """The process's tracer, emptied, with its settings restored after."""
    prev = trace.configure()
    trace.reset()
    yield trace
    trace.configure(**prev)


def _fused3():
    cfg, grid, frc = W.world(W.INTERACTIVE, dict(uo=0.4, sst=2.0))
    return cfg, grid, frc, W.bergs(grid, *W.pair_positions())


def _model(cfg, grid, st):
    import icebergs_tpu_torch as ibp
    m = ibp.IcebergsModel(grid, cfg, device=CPU, **W.FUSED3_RUN)
    return m, m.init_state(st, seed=7)


def _by_step(recs):
    out = {}
    for r in recs:
        out.setdefault(r.step, []).append(r)
    return out


def _nested(run, inner):
    """The spans inside one step lie in it, in order, none overlapping."""
    assert all(run.t0_ns <= r.t0_ns <= r.t1_ns <= run.t1_ns for r in inner)
    for a, b in zip(inner, inner[1:]):
        assert a.t1_ns <= b.t0_ns


def test_run_spans_nest_and_share_a_step_id(tracer):
    cfg, grid, frc, st = _fused3()
    m, s = _model(cfg, grid, st)
    for _ in range(3):
        s, _ = m.run(s, frc)
    recs = tracer.records()
    assert [r.name for r in recs[:3]] == SETUP
    assert all(r.step is None and r.parent is None for r in recs[:3])
    steps = _by_step(r for r in recs if r.step is not None)
    assert len(steps) == 3 and sorted(steps) == list(
        range(min(steps), min(steps) + 3))
    for rs in steps.values():
        run = rs[-1]
        assert run.name == "kid.run" and run.parent is None
        assert [r.name for r in rs[:-1]] == PHASES
        assert all(r.parent == "kid.run" for r in rs[:-1])
        _nested(run, rs[:-1])
        assert not any(r.profiled for r in rs)
        # the leaf phases hold nearly all of the step
        assert sum(r.host_ms for r in rs[:-1]) > 0.9 * run.host_ms
    tot = tracer.totals()
    assert tot["kid.run"]["calls"] == 3 and tot["kid.evolve"]["calls"] == 3
    assert tot["kid.run"]["last_ms"] == steps[max(steps)][-1].host_ms


@pytest.mark.parametrize("layout", [(2,)])
def test_tiled_run_spans_close_before_each_yield(tracer, layout):
    """Two tiles' generators in lockstep: each tile's phases are whole
    spans directly inside the step's ``kid.run``, one after another; the
    footloose phase is split at the yield."""
    cfg, grid, frc = W.world(FOOTLOOSE_CONTACTS, dict(uo=0.4, sst=2.0))
    st = W.bergs(grid, *W.pair_positions())
    W.tiled_run(cfg, frc, st, layout, 2, cap=32, seed=7, **W.FUSED3_RUN)
    steps = _by_step(r for r in tracer.records() if r.step is not None)
    assert len(steps) == 2
    ntiles = layout[0]
    for rs in steps.values():
        run, inner = rs[-1], rs[:-1]
        assert run.name == "kid.run"
        assert all(r.parent == "kid.run" for r in inner)
        _nested(run, inner)
        names = [r.name for r in inner]
        for p in PHASES:
            assert names.count(p) == ntiles, p
        assert names.count("kid.footloose") == 2 * ntiles
        # after the spawn, after the footloose children, then the migration
        assert names.count("kid.exchange") == 3
        assert names[:ntiles] == ["kid.calving"] * ntiles
        assert names[ntiles] == "kid.exchange"


def test_disabled_records_nothing(tracer):
    tracer.configure(enabled=False)
    cfg, grid, frc, st = _fused3()
    m, s = _model(cfg, grid, st)
    m.run(s, frc)
    assert tracer.records() == [] and tracer.totals() == {}
    assert tracer.span("a") is tracer.span("b")


def test_device_clock_needs_a_card(tracer):
    prev = tracer.configure(device=True)
    assert prev == dict(enabled=True, device=False)
    assert tracer.TRACER.device is torch.cuda.is_available()


def test_ring_wraps_and_totals_survive():
    tr = trace.Tracer(capacity=4)
    for k in range(10):
        with tr.span("outer", step=True):
            with tr.span("inner"):
                pass
    assert len(tr.records()) == 4
    t = tr.totals()
    assert t["outer"]["calls"] == t["inner"]["calls"] == 10
    assert [r.step for r in tr.records()] == [9, 9, 10, 10]
    assert tr.records()[-2].parent == "outer"


def test_profiler_sees_host_ranges_not_annotations(tracer):
    """In a CPU ``torch.profiler`` capture the spans are host operations
    that are not user annotations (a user annotation would be mirrored
    onto the device's timeline); their records know the profiler ran."""
    cfg, grid, frc, st = _fused3()
    m, s = _model(cfg, grid, st)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.run(s, frc)
    kid = [e for e in prof.events() if e.name.startswith("kid.")]
    assert {e.name for e in kid} == set(PHASES) | {"kid.run"}
    assert all(not e.is_user_annotation for e in kid)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in kid)
    assert all(r.profiled for r in tracer.records() if r.step is not None)
    table = trace.by_phase(prof.events())
    assert table["kid.evolve"]["calls"] == 1
    assert table["kid.evolve"]["kernels"] == 0


def _ev(name, a, b, cuda=False, id=0, linked=0, annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU),
        id=id, linked_correlation_id=linked, is_user_annotation=annotation)


def test_by_phase_on_synthetic_events():
    """Kernels go to the innermost span around their launching runtime
    call (by correlation id), idle gaps to the span around their
    midpoint, the rest to ``OUTSIDE``."""
    ev = [
        _ev("kid.run", 0., 100.),
        _ev("kid.interp", 1., 40.), _ev("kid.evolve", 41., 99.),
        _ev("aten::add", 2., 10., id=7),
        _ev("cudaLaunchKernel", 3., 4., id=501, linked=7),
        _ev("cudaLaunchKernel", 5., 6., id=502, linked=7),
        _ev("cudaLaunchKernel", 50., 51., id=503),
        _ev("cudaMemsetAsync", 60., 61., id=504),
        _ev("cudaLaunchKernel", 120., 121., id=505),
        _ev("add_kernel", 10., 30., cuda=True, id=501),
        _ev("add_kernel", 30., 35., cuda=True, id=502),
        _ev("gather_kernel", 45., 55., cuda=True, id=503),
        _ev("Memset (Device)", 55., 56., cuda=True, id=504),
        _ev("late_kernel", 130., 131., cuda=True, id=505),
        _ev("kid.step_note", 0., 1., cuda=True, annotation=True),
    ]
    t = trace.by_phase(ev)
    assert t["kid.run"]["calls"] == 1 and t["kid.run"]["host_ms"] == 0.1
    assert t["kid.run"]["kernels"] == 0
    i, e, o = t["kid.interp"], t["kid.evolve"], t[trace.OUTSIDE]
    assert i["kernels"] == 2 and i["busy_ms"] == 0.025
    assert i["top"] == [("add_kernel", 0.025)]
    assert e["kernels"] == 1 and e["busy_ms"] == 0.011
    assert o["kernels"] == 1 and o["busy_ms"] == 0.001
    # gaps: 35-45 (midpoint 40: interp's end), 56-130 (midpoint 93: evolve)
    assert i["idle_ms"] == 0.01 and e["idle_ms"] == 0.074
    assert t["kid.run"]["idle_ms"] == 0.


def _ctx(m, s, frc, steps=2):
    """The harness's window over one episode of ``steps`` steps, after
    one warm-up step and before a profiled step, as the readers see it."""
    class Sim:
        start = staticmethod(lambda: s)
        step = staticmethod(lambda x: m.run(x, frc))
        counters = staticmethod(lambda o: {})
    Sim.step(s)
    rec, *_ = harness.window(Sim, steps, 0., harness.Clock(torch, CPU))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        Sim.step(s)
    rec.pop("counters")
    return types.SimpleNamespace(trace=None, counters={}, **rec)


def test_readers_take_the_window_steps(tracer):
    cfg, grid, frc, st = _fused3()
    m, s = _model(cfg, grid, st)
    ctx = _ctx(m, s, frc)
    steps = spans.window_steps(ctx)
    assert len(steps) == ctx.steps == 2
    runs = [r for r in tracer.records() if r.name == "kid.run"]
    assert len(runs) == 4 and runs[-1].profiled
    # the span lies inside the host clock's step
    assert all(0. <= h - r.host_ms < spans.TOL_MS
               for r, h in zip(runs[1:3], ctx.host_ms))
    window = {r.step for r in runs[1:3]}
    names = {"calving_host_ms": "kid.calving", "interp_host_ms": "kid.interp",
             "contacts_host_ms": "kid.contacts",
             "evolve_host_ms": "kid.evolve", "thermo_host_ms": "kid.thermo",
             "spread_host_ms": "kid.spread", "returns_host_ms": "kid.returns"}
    total = 0.
    for metric, name in names.items():
        v = harness.reader(f"{metric}.om4")(ctx)
        want = sum(r.host_ms for r in tracer.records()
                   if r.name == name and r.step in window) / 2
        assert v == pytest.approx(want, rel=1e-12)
        total += v
    assert 0.9 * sum(ctx.host_ms) / 2 < total <= sum(ctx.host_ms) / 2
    tot = tracer.totals()
    assert harness.reader("init_s.om4")(ctx) == pytest.approx(
        sum(tot[n]["last_ms"] for n in SETUP) / 1e3)
    # a step the host clock timed otherwise, or a window longer than the
    # spans: nothing to read
    bad = types.SimpleNamespace(**vars(ctx))
    bad.host_ms = [ctx.host_ms[0] + 2., ctx.host_ms[1]]
    assert spans.window_steps(bad) is None
    assert harness.reader("evolve_host_ms.om4")(bad) is None
    bad.host_ms, bad.steps = ctx.host_ms * 2, 4
    assert spans.phase_ms(bad, "kid.evolve") is None


def test_readers_find_nothing_without_the_tracer(monkeypatch):
    """A checkout whose program has no tracer: every reader gives None."""
    monkeypatch.setattr(spans, "tracer", lambda: None)
    ctx = types.SimpleNamespace(steps=2, host_ms=[1., 1.])
    for metric in ("calving_host_ms", "evolve_host_ms", "init_s"):
        assert harness.reader(f"{metric}.om4")(ctx) is None

"""The coupled step's CUDA graphs (``icebergs_tpu_torch.graphs``) where
they run without a card: the static buffers a replay copies the step's
arguments into and its outputs out of, the signature that keys the
graphs, the rule that keeps a step eager, the span hook that cuts a
capture into phases, the CPU step, and the benchmark's reader of the
replays.  The capture and the replay themselves run on the card
(``tests/test_torch_cuda.py``).  Small worlds of
``tests/torch_parallel_worlds.py``; no JAX."""

import dataclasses
import types

import pytest
import torch

import icebergs_tpu_torch as ibp
import torch_parallel_worlds as W
from benchmark import harness, spans
from icebergs_tpu_torch import api, graphs, trace
from icebergs_tpu_torch.state import grow_capacity

torch.set_num_threads(1)
CPU = torch.device("cpu")
PHASES = ["kid.calving", "kid.interp", "kid.contacts", "kid.evolve",
          "kid.thermo", "kid.spread", "kid.returns"]


def _world(dtype=torch.float32, **cfg_kw):
    cfg, grid, frc = W.world(dict(W.INTERACTIVE, **cfg_kw),
                             dict(uo=0.4, sst=2.0))
    st = W.bergs(grid, *W.pair_positions(), dtype=dtype)
    m = ibp.IcebergsModel(grid, cfg, device=CPU, **W.FUSED3_RUN)
    calving = torch.zeros(grid.nx + 2, grid.ny + 2, dtype=dtype)
    calving[3, 3:12] = 2e6
    return m, m.init_state(st, seed=7), frc, calving


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _shapes(spec):
    """A tree's spec with its tensors' strides left out (a copy of a
    column of a matrix is a column of its own)."""
    if isinstance(spec, graphs.Leaf):
        return spec._replace(stride=None)
    if isinstance(spec, tuple):
        cls, kids = spec
        return (cls, tuple(
            (k[0], _shapes(k[1])) if dataclasses.is_dataclass(cls)
            else _shapes(k) for k in kids))
    return spec


def _same(a, b):
    """Two trees of the same structure and the same bits."""
    la, lb = [], []
    assert _shapes(graphs.flatten(a, la)) == _shapes(graphs.flatten(b, lb))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))
    return la, lb


def _storages(tree):
    leaves = []
    graphs.flatten(tree, leaves)
    return {t.untyped_storage().data_ptr() for t in leaves if t.numel()}


@pytest.mark.parametrize("which", ["state", "outputs"])
def test_buffers_round_trip_bitwise(which):
    """A ``ModelState`` and a ``RunOutputs`` through the static buffers,
    in and out: the same structure and bits, on tensors of their own."""
    m, s, frc, calving = _world()
    s1, out = m.run(s, frc, calving)
    tree = s1 if which == "state" else out
    leaves = []
    spec = graphs.flatten(tree, leaves)
    buf = graphs.Buffers(spec, leaves)
    buf.copy_in(leaves)
    back = buf.inputs()
    assert type(back) is type(tree)
    _same(back, tree)
    assert not _storages(back) & _storages(tree)
    buf.keep((back,))
    _same(buf.copy_out(), (tree,))


def test_consecutive_returns_share_no_storage():
    """Each return is fresh: two returns share no storage with each other
    or with the graph's outputs, and within a return the tensors the step
    shares stay shared (the state's ``spread_mass_old`` is the outputs'
    ``spread_mass``)."""
    m, s, frc, calving = _world()
    s1, out = m.run(s, frc, calving)
    assert s1.spread_mass_old is out.spread_mass
    buf = graphs.Buffers(graphs.flatten((s1, out), []), [])
    buf.keep((s1, out))
    a, b = buf.copy_out(), buf.copy_out()
    _same(a, (s1, out))
    _same(b, (s1, out))
    held = _storages(tuple(buf.out))
    assert not _storages(a) & _storages(b)
    assert not (_storages(a) | _storages(b)) & held
    for sa, oa in (a, b):
        assert sa.spread_mass_old is oa.spread_mass
        # the state and the outputs in buffers of their own, but for the
        # tensor they share
        assert _storages(sa.bergs) & _storages(oa) == {
            oa.spread_mass.untyped_storage().data_ptr()}
    leaves = []
    graphs.flatten((s1, out), leaves)
    assert len(buf.out) < len(leaves)        # a shared tensor copied once


def test_signature_keys_on_layout_options_and_config_alone():
    """The key changes with a tensor's shape or dtype, with which optional
    arguments are given and with the config's values, and with nothing
    else: not the tensors' values, the seed, the step or the model."""
    m, s, frc, calving = _world()
    key = graphs.signature(m, s, frc, calving)[0]
    b = s.bergs
    same = [
        graphs.signature(m, s.replace(seed=99, step=12), frc, calving),
        graphs.signature(m, s.replace(bergs=b.replace(lon=b.lon + 1.)),
                         frc.replace(uo=frc.uo * 2.), calving + 1.),
        graphs.signature(ibp.IcebergsModel(m.grid, m.cfg, device=CPU,
                                           **W.FUSED3_RUN),
                         s, frc, calving)]
    assert all(k == key for k, _ in same)
    assert hash(key) == hash(same[0][0])
    cap = s.replace(bergs=grow_capacity(b, 2 * b.capacity))
    m64, s64, frc64, calving64 = _world(torch.float64)
    other_cfg = ibp.IcebergsModel(m.grid, m.cfg.replace(dt=30.), device=CPU,
                                  **W.FUSED3_RUN)
    differ = [
        graphs.signature(m, cap, frc, calving),
        graphs.signature(m, s, frc, calving[:-1]),
        graphs.signature(m64, s64, frc64, calving64),
        graphs.signature(m, s, frc, calving.double()),
        graphs.signature(m, s, frc),
        graphs.signature(m, s, frc, calving, torch.zeros_like(calving)),
        graphs.signature(m, s, frc, calving,
                         tidal_uniforms=torch.zeros(2, b.capacity)),
        graphs.signature(other_cfg, s, frc, calving)]
    keys = [k for k, _ in differ]
    assert all(k != key for k in keys)
    assert len(set(keys)) == len(keys)
    # the key's tensors: the state's, the forcing's and the fields', each
    # once, in the key's order
    _, leaves = graphs.signature(m, s, frc, calving)
    n_state = len([f for f in dataclasses.fields(b)]) + len(
        dataclasses.fields(s.calving)) + 3
    assert len(leaves) == n_state + len(dataclasses.fields(frc)) + 1
    assert leaves[-1] is calving


@pytest.mark.parametrize("cfg_kw,uniforms,eager", [
    (dict(), False, False),
    (dict(footloose=True, fl_style="new_bergs", fl_youngs=1.e8), False,
     True),
    (dict(footloose=True, fl_style="new_bergs", fl_youngs=1.e8), True,
     True),
    (dict(tidal_drift=0.01), False, True),
    (dict(tidal_drift=0.01), True, False),
], ids=["plain", "footloose", "footloose_given", "tidal", "tidal_given"])
def test_host_values_keep_a_step_eager(cfg_kw, uniforms, eager):
    """Footloose (its uniforms hash seed and step on the host, or come
    from a callable) and the tidal drift's default generator (seeded from
    seed and step) keep a step eager; given tidal uniforms, a tensor,
    are copied in like any argument.  MTS stays eager as well."""
    cfg = ibp.IcebergsConfig(**dict(W.INTERACTIVE, **cfg_kw))
    tidal = torch.zeros(2, 64) if uniforms else None
    reason = graphs.eager_reason(cfg, tidal)
    assert (reason is not None) is eager
    assert graphs.eager_reason(cfg.replace(mts=True), tidal) is not None


def test_capture_cuts_where_each_phase_opens(tracer):
    """The hook a capture cuts its graphs at: every span opening reports
    its name and the span around it; the step's phases open directly
    inside ``kid.run``, in the order the graphs replay them."""
    m, s, frc, calving = _world()
    seen = []
    trace.TRACER.on_open = lambda name, parent: seen.append((name, parent))
    try:
        m.run(s, frc, calving)
    finally:
        trace.TRACER.on_open = None
    assert seen[0] == ("kid.run", None)
    assert [n for n, p in seen if p == "kid.run"] == PHASES
    assert len(seen) == len([r for r in tracer.records()
                             if r.step is not None])


@pytest.fixture
def tracer():
    prev = trace.configure()
    trace.reset()
    yield trace
    trace.configure(**prev)


def test_cpu_run_is_the_sequence_bitwise(tracer):
    """On the CPU ``IcebergsModel.run`` is the eager sequence: the same
    bits as :func:`api.run_coupling_sequence` over three steps, and no
    capture or replay."""
    m, s, frc, calving = _world()
    a = b = s
    hflx = torch.zeros_like(calving)
    for _ in range(3):
        a, oa = m.run(a, frc, calving)
        b, ob = api.run_coupling_sequence(
            m.cfg, m.grid, b, frc, calving, hflx, nbr_radius=m._nbr_radius,
            max_per_cell=m.max_per_cell, neighbor_mode=m.neighbor_mode,
            fused_kw=m.fused_kw, tables=m._tables,
            cell_table=m._cell_table)
        _same((a, oa), (b, ob))
    assert a.step == 3
    names = {r.name for r in tracer.records()}
    assert not names & {graphs.CAPTURE, graphs.REPLAY}


def _stub_ctx(monkeypatch, replayed):
    """Two window steps whose ``kid.run`` spans hold ``kid.replay`` where
    ``replayed`` says, as the tracer would record them."""
    recs = []
    for k, rep in enumerate(replayed):
        t0 = 10_000_000 * k
        inner = ([graphs.REPLAY] if rep else []) + PHASES
        for j, name in enumerate(inner):
            recs.append(trace.Record(name, "kid.run", k + 1, t0 + j * 1000,
                                     t0 + j * 1000 + 500, False))
        recs.append(trace.Record("kid.run", None, k + 1, t0, t0 + 1_000_000,
                                 False))
    stub = types.SimpleNamespace(records=lambda: recs)
    monkeypatch.setattr(spans, "tracer", lambda: stub)
    return types.SimpleNamespace(steps=len(replayed),
                                 host_ms=[1.] * len(replayed))


@pytest.mark.parametrize("replayed,share", [
    ((False, False), 0.), ((True, True), 1.), ((False, True), 0.5)])
def test_graph_replay_share_reads_the_replay_spans(monkeypatch, replayed,
                                                   share):
    ctx = _stub_ctx(monkeypatch, replayed)
    assert harness.reader("graph_replay_share.om4")(ctx) == share


def test_graph_replay_share_reads_nothing_without_spans(monkeypatch):
    monkeypatch.setattr(spans, "tracer", lambda: None)
    ctx = types.SimpleNamespace(steps=2, host_ms=[1., 1.])
    assert harness.reader("graph_replay_share.om4")(ctx) is None

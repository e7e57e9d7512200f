"""CUDA graphs for the coupled step: :meth:`.api.IcebergsModel.run` on a
CUDA device replays its step from graphs captured once, phase by phase,
instead of enqueuing its ~5,800 small kernels from Python every step.

A step's signature (:func:`signature`) is what its graphs assume: the
shapes, strides, dtypes and devices of the state's, the forcing's and
the fields' tensors (the slab's capacity among them), which optional
arguments are given, the state's other host values but ``seed`` and
``step``, the config's values, the grid's shape and the model's contact
settings.  :class:`StepGraphs` runs the first step of a signature
eagerly: that loads the kernel library, sets the kernels' attributes and
fills the allocator and every table built at first use.  It captures the
second step and replays every later one; a new signature starts over
and drops the old graphs.

The capture (span ``kid.capture``) copies the caller's tensors into
static buffers and runs the eager step (:func:`.api.coupling_sequence`)
on them under stream capture.  The capture is cut into one graph per
phase where the phase's span opens (:attr:`.trace.Tracer.on_open`): the
kernels before the first phase (``kid.run``'s zeros of an absent calving
field) join the first phase's graph, those between two phases the
earlier one's.  The graphs share one memory pool and are captured in the
order they run.  A replay copies the caller's tensors in (span
``kid.replay``), launches each phase's graph inside the phase's own span,
and copies the outputs out into fresh buffers, so that no later replay
overwrites what a caller keeps; each copy is one ``torch._foreach_copy_``
a dtype.  The kernels are the eager step's, in its order, on the same
values (a memset or a device copy runs as one of the graph's kernel
nodes): the results are the eager step's bits.

A replay keeps at most :data:`DEPTH` steps in flight: before its copy-in
it waits on the CUDA event that ended the step ``DEPTH`` back, spinning
as CUDA does for one context on a multi-core host.  Without the wait the
host runs ahead until CUDA's launch queue is full and then waits inside
the launch, where the host's time jitters by milliseconds; with it the
host's thread stays on its core, as the eager step's enqueue keeps it,
and the device still holds a whole step of work.

Steps that read a host value changing from step to step stay eager
(:func:`eager_reason`): a graph would freeze the value read at capture.
``ModelState.seed`` and ``step`` reach the device through footloose's
default uniforms (:func:`.footloose.id_hash_uniforms` hashes them on the
host) and the tidal drift's default uniforms
(:func:`.api.tidal_generator_uniforms`, a generator seeded from them).
This module takes the eager route for both, not a device scalar in a
static buffer; a given ``fl_uniforms`` is a callable the graph cannot
see into, so footloose stays eager with it too.  MTS reads the device on
the host (Part 1's convergence) and stays eager.  So does the CPU.

The kernel wrappers' launch counters (``extract_sorted.launches``,
``permute_cols_u32.launches``, ``segment_spread_sums.launches``, ...)
count the wrappers' calls on the host: under graphs they tick at the
eager step and at the capture, and not on a replay.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Optional

import torch

from . import trace

CAPTURE, REPLAY = "kid.capture", "kid.replay"
ALIGN = 128         # bytes: where each returned tensor starts in its buffer
DEPTH = 2           # the steps a replay keeps in flight


class Leaf(NamedTuple):
    """A tensor's place in a flattened tree: what a graph assumes of it."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype
    device: torch.device


def flatten(tree, leaves: list):
    """``tree``'s structure as a hashable spec, each tensor a
    :class:`Leaf` and appended to ``leaves`` in order.  A tree is made of
    dataclasses, tuples (named or not), tensors, None and Python
    scalars."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return Leaf(tuple(tree.shape), tree.stride(), tree.dtype,
                    tree.device)
    if dataclasses.is_dataclass(tree):
        return (type(tree), tuple((f.name, flatten(getattr(tree, f.name),
                                                   leaves))
                                  for f in dataclasses.fields(tree)))
    if isinstance(tree, tuple):
        return (type(tree), tuple(flatten(v, leaves) for v in tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"no graph holds a {type(tree).__name__}")


def unflatten(spec, tensors):
    """The tree of ``spec`` (:func:`flatten`) on the tensors the iterator
    ``tensors`` gives, in order."""
    if isinstance(spec, Leaf):
        return next(tensors)
    if isinstance(spec, tuple):
        cls, kids = spec
        if dataclasses.is_dataclass(cls):
            return cls(**{n: unflatten(s, tensors) for n, s in kids})
        vals = [unflatten(s, tensors) for s in kids]
        return cls(*vals) if hasattr(cls, "_fields") else cls(vals)
    return spec


def copy_all(dst, src):
    """``dst[k].copy_(src[k])`` for every k: one ``torch._foreach_copy_``
    for each dtype among the pairs of one layout, ``copy_`` for the
    rest."""
    groups = {}
    for d, s in zip(dst, src):
        if d.stride() == s.stride():
            g = groups.setdefault(s.dtype, ([], []))
            g[0].append(d)
            g[1].append(s)
        else:
            d.copy_(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def signature(model, state, frc, calving=None, calving_hflx=None,
              tidal_uniforms=None):
    """``(key, leaves)``: the key of a step's graphs and the step's
    tensors in the key's order: what a graph reads of the arguments (the
    state without its host counters ``seed`` and ``step``, the forcing,
    the calving fields, the tidal uniforms) and of the model; no tensor's
    values."""
    leaves = []
    spec = flatten((state.replace(seed=None, step=None), frc, calving,
                    calving_hflx, tidal_uniforms), leaves)
    key = (spec, model.cfg, (model.grid.nx, model.grid.ny),
           model.neighbor_mode, model.max_per_cell, repr(model.fused_kw))
    return key, leaves


def eager_reason(cfg, tidal_uniforms=None) -> Optional[str]:
    """Why a step of ``cfg`` stays eager (a host value changes from step
    to step, or the step reads the device on the host), or None."""
    if cfg.mts:
        return "MTS reads Part 1's convergence on the host"
    if cfg.footloose:
        return "footloose's uniforms: seed and step on the host"
    if cfg.tidal_drift > 0. and tidal_uniforms is None:
        return "the tidal drift's generator: seeded from seed and step"
    return None


class Buffers:
    """A captured step's static inputs and its outputs: the caller's
    tensors are copied in before each replay and the outputs out after
    it.  Plain tensor copies, so it runs on any device."""

    def __init__(self, spec, leaves):
        self.spec = spec
        self.static = [torch.empty_like(t) for t in leaves]

    def copy_in(self, leaves):
        copy_all(self.static, leaves)

    def inputs(self):
        """The step's arguments on the static buffers."""
        return unflatten(self.spec, iter(self.static))

    def keep(self, out):
        """Take ``out``, a tuple of the graph's output trees: each distinct
        tensor is copied out once a return, shared where ``out`` shares
        it, into one buffer for each tree of ``out`` and dtype (freeing a
        returned tree frees a few buffers, not a tensor at a time)."""
        leaves, part, specs = [], [], []
        for p, tree in enumerate(out):
            specs.append(flatten(tree, leaves))
            part += [p] * (len(leaves) - len(part))
        self.out_spec = (type(out), tuple(specs))
        first, self.out, groups = {}, [], {}
        for t, p in zip(leaves, part):
            if id(t) not in first:
                first[id(t)] = len(self.out)
                groups.setdefault((p, t.dtype), []).append(len(self.out))
                self.out.append(t)
        self.slots = [first[id(t)] for t in leaves]
        self.groups = []
        for (_, dtype), ks in groups.items():
            align = max(1, ALIGN // self.out[ks[0]].element_size())
            offs, end = [], 0
            for k in ks:
                offs.append(end)
                end += -(-self.out[k].numel() // align) * align
            self.groups.append((dtype, end, ks, offs))

    def copy_out(self):
        """The outputs' trees on fresh buffers."""
        fresh = [None] * len(self.out)
        dev = self.out[0].device
        for dtype, size, ks, offs in self.groups:
            flat = torch.empty(size, dtype=dtype, device=dev)
            for k, o in zip(ks, offs):
                t = self.out[k]
                fresh[k] = flat.narrow(0, o, t.numel()).view(t.shape)
        copy_all(fresh, self.out)
        return unflatten(self.out_spec, (fresh[k] for k in self.slots))


class StepGraphs:
    """The captured graphs of one model's coupled step, for its last
    signature: :meth:`run` in place of the eager step."""

    def __init__(self, model):
        self.model = model
        self.key = None         # the last step's signature
        self.graphs = None      # [(phase, CUDAGraph)] once captured
        self.buffers = None
        self.dstep = None       # what a step adds to ``ModelState.step``
        self.stream = None      # the capture's side stream
        self.done = collections.deque()  # the steps in flight: end events

    def run(self, state, frc, calving, calving_hflx, tidal_uniforms,
            fl_uniforms):
        m = self.model
        eager = (state, frc, calving, calving_hflx, tidal_uniforms,
                 fl_uniforms)
        dev = state.bergs.device
        if dev.type != "cuda" or eager_reason(m.cfg, tidal_uniforms):
            return m._sequence(*eager)
        key, leaves = signature(m, state, frc, calving, calving_hflx,
                                tidal_uniforms)
        if any(t.device != dev for t in leaves):
            return m._sequence(*eager)
        if key != self.key:             # a new signature: warm it eagerly
            self.key, self.graphs, self.buffers = key, None, None
            return m._sequence(*eager)
        if self.graphs is None:
            self._capture(key[0], state, leaves)
        else:
            with trace.span(REPLAY):
                if len(self.done) >= DEPTH:
                    self.done.popleft().synchronize()
                self.buffers.copy_in(leaves)
        for name, g in self.graphs:
            with trace.span(name):
                g.replay()
        st, out = self.buffers.copy_out()
        self.done.append(torch.cuda.Event())
        self.done[-1].record()
        return st.replace(seed=state.seed,
                          step=state.step + self.dstep), out

    def _capture(self, spec, state, leaves):
        """Capture the step on static buffers, one graph a phase, with the
        tracer on (its spans cut the graphs) and its device clock off (no
        event may be queried on a capturing stream)."""
        buf = Buffers(spec, leaves)
        if self.stream is None:
            self.stream = torch.cuda.Stream(state.bergs.device)
        stream, pool = self.stream, torch.cuda.graph_pool_handle()
        graphs = [[None, torch.cuda.CUDAGraph()]]

        def cut(name, parent):
            if parent != CAPTURE:
                return
            if graphs[-1][0] is None:   # the first phase: its graph is open
                graphs[-1][0] = name
                return
            graphs[-1][1].capture_end()
            graphs.append([name, torch.cuda.CUDAGraph()])
            graphs[-1][1].capture_begin(pool=pool)

        prev = trace.configure(enabled=True, device=False)
        try:
            with trace.span(CAPTURE):
                buf.copy_in(leaves)
                st, frc, calving, hflx, tidal = buf.inputs()
                st = st.replace(seed=state.seed, step=state.step)
                stream.wait_stream(torch.cuda.current_stream())
                trace.TRACER.on_open = cut
                with torch.cuda.stream(stream):
                    graphs[0][1].capture_begin(pool=pool)
                    out_st, out = self.model._sequence(st, frc, calving,
                                                       hflx, tidal, None)
                    graphs[-1][1].capture_end()
                torch.cuda.current_stream().wait_stream(stream)
        finally:
            trace.TRACER.on_open = None
            trace.configure(**prev)
        buf.keep((out_st.replace(seed=None, step=None), out))
        self.dstep = out_st.step - state.step
        self.graphs = [tuple(g) for g in graphs]
        self.buffers = buf

"""The program's tracer: named spans on the host's clock, with the
device's clock on request, kept in memory.

``with trace.span("kid.interp"): ...`` times a phase on
``time.perf_counter_ns`` with no sync: on the card it measures the
phase's enqueue.  Each closed span is a :class:`Record` in a bounded
ring (:data:`RING` records; the oldest go first), and running totals per
name (calls, total, largest and last host ms, device ms) survive the
ring's wrap.  A span opened with ``step=True`` (``kid.run``, one coupling
step) hands out a step id that every span closed inside it shares.

Each span is also a profiler host range (``_RecordFunctionFast``), so
that in a ``torch.profiler`` capture the phases sit on the timeline of
the kernels and the runtime calls that launched them (:func:`by_phase`).
It is a CPU operation, not a user annotation: a user annotation
(``record_function``) is mirrored onto the device's timeline, where it
would count as a device operation.

``configure(device=True)`` adds the device's clock: each span records a
CUDA event pair from a pool, and a span's device ms is read once its end
event has completed (``Event.query``, polled as spans close) or at
:func:`report`; nothing in a step waits for the card.  ``enabled=False``
makes :func:`span` return one shared no-op context.  The default,
enabled with no events, costs a few µs a span on the host.

No span may stay open across a generator's ``yield``: the tiled run
drives several tiles' step generators in lockstep
(:func:`.parallel.domain.make_sharded_run`), and a span open across a
yield would hold the other tiles' phases.  Spans open and close on the
thread that runs the step: the recorder takes no lock.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

RING = 65536
# the totals' fields, in the order they are kept
_TOTALS = ("calls", "total_ms", "max_ms", "last_ms", "device_calls",
           "device_ms")


class Record:
    """One closed span: its name, the enclosing span's name (None at the
    top), the step id (None outside a step), its start and end on
    ``time.perf_counter_ns``, whether a ``torch.profiler`` session was
    active when it opened, and its device ms (None until read, or
    without device timing)."""

    __slots__ = ("name", "parent", "step", "t0_ns", "t1_ns", "profiled",
                 "device_ms")

    def __init__(self, name, parent, step, t0_ns, t1_ns, profiled):
        self.name, self.parent, self.step = name, parent, step
        self.t0_ns, self.t1_ns, self.profiled = t0_ns, t1_ns, profiled
        self.device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    def __repr__(self):
        return (f"Record({self.name!r}, parent={self.parent!r}, "
                f"step={self.step}, host_ms={self.host_ms:.3f}, "
                f"device_ms={self.device_ms})")


class _Span:
    __slots__ = ("tr", "name", "step", "outer", "parent", "rf", "ev", "t0",
                 "profiled")

    def __init__(self, tr, name, step):
        self.tr, self.name, self.step = tr, name, step

    def __enter__(self):
        tr = self.tr
        if self.step:
            self.outer = tr._step
            tr._steps += 1
            tr._step = tr._steps
        stack = tr._stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if tr.on_open is not None:
            tr.on_open(self.name, self.parent)
        self.profiled = _profiler._is_profiler_enabled
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.ev = tr._event_pair() if tr.device else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tr
        if self.ev is not None:
            self.ev[1].record()
        self.rf.__exit__(None, None, None)
        tr._stack.pop()
        tr._close(Record(self.name, self.parent, tr._step, self.t0, t1,
                         self.profiled), self.ev)
        if self.step:
            tr._step = self.outer
        return False


class Tracer:
    """The recorder behind the module's functions (one per process:
    :data:`TRACER`)."""

    def __init__(self, capacity: int = RING):
        self.enabled, self.device = True, False
        self._ring = collections.deque(maxlen=capacity)
        self._totals = {}
        self._stack = []            # the open spans' names, outermost first
        self._step = None           # the open step's id
        self._steps = 0             # step ids handed out
        self._pending = collections.deque()  # (record, events) to read
        self._pool = []             # free CUDA event pairs
        self._noop = contextlib.nullcontext()
        # called as ``on_open(name, parent)`` when a span opens (the step's
        # graphs cut their capture there: :mod:`.graphs`)
        self.on_open = None

    def configure(self, enabled: bool = True, device: bool = False) -> dict:
        """Turn spans on or off and the device's clock on or off (where
        CUDA is available); returns the previous settings."""
        prev = dict(enabled=self.enabled, device=self.device)
        self.enabled = bool(enabled)
        self.device = bool(enabled and device) and torch.cuda.is_available()
        return prev

    def span(self, name: str, step: bool = False):
        """A context that records one span of ``name``; ``step=True``
        opens a new step id for the spans inside it."""
        if not self.enabled:
            return self._noop
        return _Span(self, name, step)

    def _event_pair(self):
        if self._pool:
            pair = self._pool.pop()
        else:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        pair[0].record()
        return pair

    def _close(self, rec, ev):
        self._ring.append(rec)
        ms = rec.host_ms
        tot = self._totals.get(rec.name)
        if tot is None:
            tot = self._totals[rec.name] = [0, 0., 0., 0., 0, 0.]
        tot[0] += 1
        tot[1] += ms
        tot[2] = max(tot[2], ms)
        tot[3] = ms
        if ev is not None:
            self._pending.append((rec, ev))
            self._poll(block=False)

    def _poll(self, block: bool):
        """Read the device ms of the spans whose end event has completed
        (all of them, waiting for each, with ``block``)."""
        pend = self._pending
        while pend:
            rec, (a, b) = pend[0]
            if block:
                b.synchronize()
            elif not b.query():
                break
            rec.device_ms = a.elapsed_time(b)
            tot = self._totals.get(rec.name)
            if tot is not None:
                tot[4] += 1
                tot[5] += rec.device_ms
            pend.popleft()
            self._pool.append((a, b))

    def records(self) -> list:
        """The ring's records, oldest first (device ms read where ready)."""
        self._poll(block=False)
        return list(self._ring)

    def totals(self) -> dict:
        """``{name: {calls, total_ms, max_ms, last_ms, device_calls,
        device_ms}}`` since the last :meth:`reset`."""
        self._poll(block=False)
        return {n: dict(zip(_TOTALS, t)) for n, t in self._totals.items()}

    def reset(self):
        """Forget the records, the totals and the unread device times."""
        self._ring.clear()
        self._totals.clear()
        self._pending.clear()

    def report(self, tag: str = "clocks"):
        """Print the totals as the reference's ``mpp_clock`` table, the
        largest total first: calls, total s, mean and max host ms a call,
        and mean device ms a call (``-`` without device timing).  Waits
        for the device's unread events first."""
        self._poll(block=True)
        if not self._totals:
            return
        print(f"{tag} | {'phase':<24} | {'calls':>7} | {'total s':>10} | "
              f"{'mean ms':>9} | {'max ms':>9} | {'device ms':>9}")
        for name, (n, tot, mx, _, dn, dms) in sorted(
                self._totals.items(), key=lambda kv: -kv[1][1]):
            dev = f"{dms / dn:>9.3f}" if dn else f"{'-':>9}"
            print(f"{tag} | {name:<24} | {n:>7} | {tot / 1e3:>10.3f} | "
                  f"{tot / n:>9.3f} | {mx:>9.3f} | {dev}")


TRACER = Tracer()
configure = TRACER.configure
span = TRACER.span
records = TRACER.records
totals = TRACER.totals
reset = TRACER.reset
report = TRACER.report


# --------------------------------------------------------------------------
# the spans on a profiler's timeline
# --------------------------------------------------------------------------

OUTSIDE = "(outside)"
TOP = 3


def _union_us(iv):
    busy, end = 0., None
    for a, b in sorted(iv):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


class _Spans:
    """The spans of a capture, well nested: the innermost one at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, open_ = [], []
        for k, (a, b, _) in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][1] < a:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(k)

    def innermost(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.spans[k][1] < t:
            k = self.parent[k]
        return self.spans[k][2] if k >= 0 else OUTSIDE


def by_phase(events, prefix: str = "kid.") -> dict:
    """Where a captured stretch went, span by span: ``events`` are a
    CPU+CUDA ``torch.profiler`` capture's (``prof.events()``), the spans
    the host operations whose name starts with ``prefix``.  Each device
    operation belongs to the innermost span around the runtime call that
    launched it (the call of the same correlation id), each idle gap of
    the device to the innermost span around the gap's midpoint;
    :data:`OUTSIDE` takes what no span holds.  Returns ``{span name:
    {calls, host_ms, kernels, busy_ms, idle_ms, top}}``: the span's calls
    and host ms in all, the kernels it launched (memory copies and sets
    not counted), the union of its device operations' intervals, the idle
    gaps it holds, and its ``TOP`` heaviest kernels as (name, ms)."""
    from torch.autograd import DeviceType
    spans, dev, calls = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append(e)
        elif e.name.startswith(prefix) and not e.is_user_annotation:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        else:
            calls.append(e)
    ids = {e.id for e in dev}
    launch = {e.id: e.time_range.start for e in calls
              if e.id in ids and e.name.startswith("cu")}
    where = _Spans(spans)
    out = {}

    def row(name):
        r = out.get(name)
        if r is None:
            r = out[name] = dict(calls=0, host_ms=0., kernels=0, busy_ms=0.,
                                 idle_ms=0., top={}, iv=[])
        return r
    for a, b, name in spans:
        r = row(name)
        r["calls"] += 1
        r["host_ms"] += (b - a) / 1e3
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        t = launch.get(e.id)
        r = row(OUTSIDE if t is None else where.innermost(t))
        r["iv"].append((a, b))
        if not e.name.startswith(("Memcpy", "Memset")):
            r["kernels"] += 1
            r["top"][e.name] = r["top"].get(e.name, 0.) + (b - a) / 1e3
    ops = sorted((e.time_range.start, e.time_range.end) for e in dev)
    end = ops[0][1] if ops else None
    for a, b in ops[1:]:
        if a > end:
            row(where.innermost(0.5 * (a + end)))["idle_ms"] += (a - end) / 1e3
        end = max(end, b)
    for r in out.values():
        r["busy_ms"] = _union_us(r.pop("iv")) / 1e3
        r["top"] = sorted(r["top"].items(), key=lambda kv: -kv[1])[:TOP]
    return out

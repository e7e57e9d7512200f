"""One traced stretch of a run: ``torch.profiler`` over a few steps,
read in memory (nothing is written to disk).  Gives the device's
operations with their times, the seconds the device was busy (the union
of its operations' intervals), the length of the traced window, the
operations that took most time and the longest idle gaps named by what
the host was doing in them."""

SPAN = "benchmark.traced_steps"
TOP = 10
# the profiler's own host records, which name no work of the run
PROFILER_OWN = ("Activity Buffer Request",)


def _union(iv):
    busy, end = 0., None
    for a, b in sorted(iv):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _events(fn, acts):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    with torch.profiler.profile(activities=acts) as prof:
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize()
    dev, host, span = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name == SPAN:
            # the annotation shows on the device's timeline too
            if e.device_type != DeviceType.CUDA:
                span = (a, b)
        elif e.device_type == DeviceType.CUDA:
            dev.append((a, b, e.name))
        elif e.name not in PROFILER_OWN:
            host.append((a, b, e.name))
    return dev, host, span


def profile(fn, fn_named):
    """Trace ``fn()`` with the device's activity alone (the profiler's
    cost on the host grows with the host operations it records, and
    would stretch the window), then ``fn_named()``, a shorter stretch,
    with the host's operations too, to name the idle gaps; summarise."""
    from torch.profiler import ProfilerActivity

    dev, _, span = _events(fn, [ProfilerActivity.CUDA])
    out = summarise(dev, [], span)
    dev, host, span = _events(fn_named, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    out["idle_gaps"] = summarise(dev, host, span)["idle_gaps"]
    return out


def summarise(dev, host, span):
    """``dev``: the device's operations as (start, end, name) in µs;
    ``host``: the host's operations likewise; ``span``: the traced
    stretch's (start, end)."""
    dev = sorted(dev)
    t0 = span[0] if span else min(a for a, _, _ in dev)
    t1 = max([span[1] if span else 0.] + [b for _, b, _ in dev])
    by = {}
    for a, b, n in dev:
        by[n] = by.get(n, 0.) + (b - a)
    gaps, end = [], t0
    for a, b, _ in dev:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((t1 - end, end, t1))
    named = []
    for g, a, b in sorted(gaps, reverse=True)[:TOP]:
        mid = 0.5 * (a + b)
        inner = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
        named.append([min(inner)[1] if inner else "host outside any traced "
                      "operation", g / 1e6])
    kernels = [(n, a, b - a) for a, b, n in dev
               if not n.startswith(("Memcpy", "Memset"))]
    return dict(
        kernels=kernels, busy_s=_union([(a, b) for a, b, _ in dev]) / 1e6,
        window_s=(t1 - t0) / 1e6,
        device_ops=[[n, v / 1e6] for n, v in sorted(
            by.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=named)

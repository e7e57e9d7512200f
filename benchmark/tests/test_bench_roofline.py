"""The frozen roofline count recomputes the port's kernel table's K2
bound row at its recorded shape (0.0371 ms, bytes, on the headline
world's 1M slots with its 83,634 partner slots); the K2 reader reads
the traced calls against the reference's contacts, and nothing where
the trace holds no K2 call or the reference gives no contacts (contacts
off)."""

import types

from benchmark import harness, roofline


def test_k2_bound_row():
    ms, by = roofline.bound_ms(*roofline.k2_work(
        1_000_000, 512 * 512, -(-1_000_000 // 128), 83_634, 0))
    assert by == "bytes" and round(ms, 4) == 0.0371


def _ctx(kernels, contacts=True):
    conf = {"bergs": {"capacity": 1 << 20},
            "grid": {"nx": 1440, "ny": 1080}}
    trace = dict(kernels=kernels, steps=2)
    ctx = types.SimpleNamespace(trace=trace, conf=conf)
    if contacts:
        ctx.contacts = [dict(engaged=10, partners=8),
                        dict(engaged=12, partners=9)]
    return ctx


def test_k2_reader():
    read = harness.reader("k2_roofline.om4")
    assert read(_ctx([("other", 0., 5.)])) is None
    ms, _ = roofline.bound_ms(*roofline.k2_work(
        1 << 20, 1440 * 1080, (1 << 20) // 128, 8, 10, latlon=True))
    got = read(_ctx([("extract_sorted_kernel<1>", 0., 1e3 * ms * 4),
                     ("extract_sorted_kernel<1>", 9., 1e3 * ms * 4)]))
    assert abs(got - 25.) < 0.1
    assert read(_ctx([("extract_sorted_kernel<1>", 0., 1e3 * ms * 4)],
                     contacts=False)) is None

"""Broken timed paths, for the tests that see ``correct`` come out false:
each wraps an entry's simulation and breaks what its step returns."""

import torch

KINDS = ("unchanged", "half", "altered")


class Faulty:
    """``sim`` with a fault in every step: ``unchanged`` returns the
    state it was given; ``half`` leaves every odd slot's berg as it was
    (half of the batch not stepped); ``altered`` moves the first live
    berg 0.1% of its longitude east where the step produced it."""

    def __init__(self, sim, kind):
        if kind not in KINDS:
            raise ValueError(kind)
        self.sim, self.kind = sim, kind

    def __getattr__(self, name):
        return getattr(self.sim, name)

    def step(self, s):
        s1, out = self.sim.step(s)
        if self.kind == "unchanged":
            return s, out
        b0, b1 = self.sim.bergs(s), self.sim.bergs(s1)
        if self.kind == "half":
            odd = torch.arange(b1.capacity, device=b1.device) % 2 == 1
            kw = {}
            for name, v in vars(b1).items():
                old = getattr(b0, name)
                if old.shape != v.shape:
                    continue
                m = odd.view(-1, *([1] * (v.dim() - 1)))
                kw[name] = torch.where(m, old, v)
            return self.sim.with_bergs(s1, b1.replace(**kw)), out
        first = torch.nonzero(b1.alive)[0]
        lon = b1.lon.clone()
        lon[first] = lon[first] * 1.001
        return self.sim.with_bergs(s1, b1.replace(lon=lon)), out


def wrap(kind):
    return lambda sim: Faulty(sim, kind)

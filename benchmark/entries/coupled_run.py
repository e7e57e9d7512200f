"""The coupled entry, ``IcebergsModel.run``: one coupling step a call
with the configuration's calving flux (buckets, spawning, interpolation,
evolution with contacts, thermodynamics, spreading, budgets), as a
climate model's coupler calls it."""

from . import answers

COUPLER_FIELDS = ("calving", "calving_hflx", "floating_melt", "berg_melt",
                  "spread_mass", "spread_area", "spread_uvel", "spread_vvel",
                  "ustar_iceberg", "mass_on_ocean")
COUNTS = ("nbergs", "nbergs_calved", "nbergs_melted")
OVERFLOWS = ("contact_overflow", "spawn_overflow", "fl_spawn_overflow")


class Sim:
    def __init__(self, kid, world, traffic, seed):
        self.kid, self.world, self.traffic = kid, world, traffic
        self.model = kid.IcebergsModel(world.grid, world.cfg,
                                       device=world.bergs.device)
        s = self.model.init_state(world.bergs, seed=seed % 2**31)
        self.s0 = s.replace(calving=s.calving.replace(
            stored_ice=world.stored))

    def start(self):
        return self.s0

    def step(self, s):
        return self.model.run(s, self.world.frc, self.world.calving)

    @staticmethod
    def bergs(s):
        return s.bergs

    @staticmethod
    def with_bergs(s, b):
        return s.replace(bergs=b)

    @staticmethod
    def counters(out):
        return dict(contact_fallback=out.contact_fallback)

    @staticmethod
    def answer(before, s, outs):
        """The episode's answer: the last state and step outputs, the
        step counters, and the state the last step started from."""
        counts = {n: [answers.scalar(getattr(o, n)) for o in outs]
                  for n in COUNTS}
        overflow = max(answers.scalar(getattr(o, n)) for o in outs
                       for n in OVERFLOWS)
        b = outs[-1].budgets
        return dict(bergs=answers.bergs(s.bergs),
                    coupler=answers.fields(outs[-1], COUPLER_FIELDS),
                    counts=counts,
                    budgets={n: answers.scalar(getattr(b, n))
                             for n in b._fields
                             if getattr(b, n) is not None},
                    overflow=overflow,
                    before=answers.state(before.bergs, before.calving))

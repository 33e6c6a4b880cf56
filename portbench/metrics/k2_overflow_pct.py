"""Share of K2's planned lanes that fell outside their staged window and
were sampled again by the gather fix-up, over the traced piece (the
program's ``k2_overflow_lanes`` over ``k2_lanes``)."""

from harness import spans


def counters():
    return spans.program_counters()


def read(ctx):
    lanes = ctx.counters.get("k2_lanes", 0)
    if not ctx.device or lanes <= 0:
        return None
    return 100.0 * ctx.counters["k2_overflow_lanes"] / lanes

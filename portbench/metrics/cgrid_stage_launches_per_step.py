"""Kernel launches a set step inside the C-grid stage cache (the
``parcels.cgrid.stage`` and ``parcels.cgrid.flush`` ranges): the stage's
eager operations around K5, and K5's own calls, counted as launch calls
on the host."""

from harness import spans


def counters():
    return spans.program_counters()


def read(ctx):
    within = spans.named(ctx, "parcels.cgrid.stage", "parcels.cgrid.flush")
    steps = spans.set_steps(ctx)
    if not ctx.device or not within or steps is None:
        return None
    return spans.launches_in(ctx, within) / steps

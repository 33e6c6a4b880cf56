"""Kernel launches a set step inside K2's plan and overflow fix-up (the
``parcels.k2.plan`` and ``parcels.k2.fixup`` ranges): K2's eager work
apart from its own kernel, counted as launch calls on the host."""

from harness import spans


def counters():
    return spans.program_counters()


def read(ctx):
    within = spans.named(ctx, "parcels.k2.plan", "parcels.k2.fixup")
    steps = spans.set_steps(ctx)
    if not ctx.device or not within or steps is None:
        return None
    return spans.launches_in(ctx, within) / steps

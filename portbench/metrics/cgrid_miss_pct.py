"""Share of the lanes the C-grid stage cache checked that missed their
cached cell, over the traced piece (the cache's own counters)."""

from harness import counters as harness_counters


def counters():
    return harness_counters.cgrid()


def read(ctx):
    checked = ctx.counters.get("cgrid_checked", 0)
    if checked <= 0:
        return None
    return 100.0 * ctx.counters["cgrid_misses"] / checked

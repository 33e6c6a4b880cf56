"""K5's share of its roofline over the traced piece: the least time its
stages' inputs need (every checked lane, and each miss's search and new
row; count.k5_need) over the device time of K5's kernels in the trace."""

import count
from harness import counters as harness_counters

KERNELS = ("check_kernel", "search_kernel")


def counters():
    return harness_counters.cgrid()


def read(ctx):
    spans = ctx.kernels(*KERNELS)
    checked = ctx.counters.get("cgrid_checked", 0)
    if not spans or checked <= 0:
        return None
    busy = sum(b - a for _, a, b in spans) / 1e9
    nbytes, nops = count.k5_need(checked, ctx.counters["cgrid_misses"])
    return 100.0 * count.least_seconds(nbytes, nops) / busy

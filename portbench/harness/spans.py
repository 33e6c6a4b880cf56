"""The program's own spans and counters in the traced piece.

``parcels_tpu_torch.profiling`` puts ``parcels.*`` ranges on the profiler's
host timeline while the piece is traced and keeps counters that are always
on (``host_reads``, ``block_steps``, ``k2_lanes``, ``k2_overflow_lanes``).
A program without them (an earlier tree) leaves the readers here empty, so
its metrics report nothing. Readers take a ``tracing.Session``: ``host``
(name, start, end) events and ``busy`` device intervals, both on the
profiler's clock, ``span`` (the piece), ``counters`` (deltas) and ``run``.
"""

from __future__ import annotations

import bisect

SYNC = "parcels.sync."
#: the runtime and driver calls that launch a kernel (not copies or sets)
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")


def program_counters() -> dict:
    """The program's counters now, or {} where the program keeps none."""
    try:
        from parcels_tpu_torch import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def set_steps(ctx):
    """Set steps of the piece: ``block_steps`` over the blocks each chunk
    runs (the lanes over the engine's block size, rounded up); None where
    the program counts no block-steps."""
    from parcels_tpu_torch._core.engine import DEFAULT_BLOCK_SIZE

    block_steps = ctx.counters.get("block_steps", 0)
    if block_steps <= 0:
        return None
    return block_steps / -(-int(ctx.run.pos["x"].size) // DEFAULT_BLOCK_SIZE)


def named(ctx, *prefixes):
    """(start, end) of the host ranges whose names start with any of
    ``prefixes``, merged where they overlap, in order."""
    found = sorted((a, b) for n, a, b in ctx.host if n.startswith(prefixes))
    merged = []
    for a, b in found:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def inside(intervals, t) -> bool:
    """Does ``t`` lie in one of the merged, ordered ``intervals``?"""
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and intervals[k][0] <= t < intervals[k][1]


def launches_in(ctx, intervals) -> int:
    """Kernel launch calls on the host that start inside ``intervals``."""
    return sum(1 for n, a, _ in ctx.host if n.startswith(LAUNCH) and inside(intervals, a))


def idle_gaps(ctx):
    """(start, end) of the piece's device-idle gaps: its span less the
    union of device intervals."""
    gaps, prev = [], ctx.span[0]
    for a, b in list(ctx.busy) + [(ctx.span[1], ctx.span[1])]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps

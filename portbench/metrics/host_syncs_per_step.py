"""Synchronizing host transfers (reads, and uploads from pageable memory)
of the program a set step over the traced piece: the program's
``host_reads`` counter over its set steps (spans.set_steps)."""

from harness import spans


def counters():
    return spans.program_counters()


def read(ctx):
    steps = spans.set_steps(ctx)
    if not ctx.device or steps is None or "host_reads" not in ctx.counters:
        return None
    return ctx.counters["host_reads"] / steps

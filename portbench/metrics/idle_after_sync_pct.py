"""Share of the traced piece's device-idle time that lies in gaps opening
while the host is inside one of the program's synchronizing transfers (a
``parcels.sync.*`` range); the rest is the launch stream running dry."""

from harness import spans


def read(ctx):
    syncs = spans.named(ctx, spans.SYNC)
    gaps = spans.idle_gaps(ctx)
    idle = sum(b - a for a, b in gaps)
    if not ctx.device or not syncs or idle <= 0:
        return None
    return 100.0 * sum(b - a for a, b in gaps if spans.inside(syncs, a)) / idle

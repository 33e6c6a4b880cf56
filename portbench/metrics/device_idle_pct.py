"""Share of the traced piece's host-clock span in which no kernel, copy or
set ran on the card (the union of device intervals from the trace)."""


def read(ctx):
    if not ctx.device or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

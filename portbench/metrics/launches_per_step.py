"""Device kernels the trace shows in the traced piece over its engine steps
(all blocks of a step together)."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    kernels = [r for r in ctx.device if not r[0].startswith(NOT_KERNELS)]
    if not kernels or ctx.steps <= 0:
        return None
    return len(kernels) / ctx.steps

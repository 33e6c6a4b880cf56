"""Seconds from process start to the window's start: imports, kernels built
or loaded, the fieldset made on the card, the release, the warm-up."""


def read(ctx):
    return ctx.setup_s

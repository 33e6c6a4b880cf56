"""Particle-steps a second over the window: every lane's steps, counted
from its own clock, over the window's host-clock length."""


def read(ctx):
    return ctx.work_steps / ctx.window_s if ctx.window_s > 0 else None

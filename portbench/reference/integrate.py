"""The plain time loop, lane by lane, and the lookup of a mix's scheme.

A mix's scheme is the module ``reference/schemes/<kernel>.py`` named by the
first kernel of its chain (the one that moves the particles; the rest are
recovery kernels), so a chain with a new advection kernel brings a new
file. Each scheme's ``run(traffic, sampler, lanes)`` takes lanes as
a dict of (n,) arrays: ``x``, ``y``, ``z``, ``t0`` (release time, s),
``steps`` (steps to take), ``ids`` (the lanes' positions in their set),
``f32`` (bool: lanes whose state the scheme holds in float32) and the
set's ``seed``; it returns final ``x``, ``y``, the ``steps`` taken and the
mask ``deleted``.

Lanes with ``f32`` set are the reference's float32 twins: the same scheme
with the particle state held in float32, as the configurations state it,
each position, displacement and sampled velocity rounded to float32 where
the program's kernels form them. The velocity itself is still sampled in
float64 (its float32 rounding is 1e-7 of it, the positions' is up to
1e-5 of a cell a step). A lane whose twin and float64 run part says how
far float32 state alone carries that lane.

A lane any of whose samples falls outside the grid (or, on a curvilinear
grid, in no cell) is deleted at the end of that step, where it stands, as
the out-of-bounds recovery kernel deletes it; the program would stop with
an error on a lane in no cell, so such a lane reads as a state difference.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def for_mix(traffic: dict, sampler, lanes: dict) -> dict:
    from harness import registry

    return registry.module("reference/schemes", traffic["kernels"][0]).run(
        traffic, sampler, lanes)


def start(lanes: dict):
    """float64 (x, y, z, t0) tensors, steps (int64) and the f32 mask."""
    x, y, z, t0 = (torch.tensor(np.asarray(lanes[k], np.float64)) for k in ("x", "y", "z", "t0"))
    steps = torch.tensor(np.asarray(lanes["steps"], np.int64))
    f32 = torch.tensor(np.asarray(lanes["f32"], bool))
    return x, y, z, t0, steps, f32


def rounder(f32):
    """Rounds the lanes of mask ``f32`` to float32 and leaves the others."""
    if not bool(f32.any()):
        return lambda a: a
    return lambda a: torch.where(f32, a.to(torch.float32).to(F64), a)

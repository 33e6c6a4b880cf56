"""The one general generator of releases and their schedule, driven by a
traffic mix's parameters.

A mix states the particles, where they start (a longitude-latitude box,
optionally ocean only, at one depth), the kernel chain, dt, the length of
one ``execute`` call, and how releases follow one another: its
``schedule.kind`` names a module ``harness/schedules/<kind>.py`` (``span``,
``forecasts``), so a new kind of schedule is a new file.

The same seed gives the same positions. Every seed gets the same number of
particles, the same box and the same schedule.
"""

from __future__ import annotations

import numpy as np

from harness import registry


def positions(traffic: dict, ocean, seed: int) -> dict:
    """Release positions (float64 numpy arrays x, y, z) from the seed.
    ``ocean(lon, lat)`` tells the points a release may start at."""
    from reference.inputs import seed_sequence

    rel = traffic["release"]
    n = int(traffic["particles"])
    rng = np.random.default_rng(seed_sequence(seed, 2))
    (x0, x1), (y0, y1) = rel["lon"], rel["lat"]
    xs, ys, have = [], [], 0
    while have < n:
        m = max(2 * (n - have), 1024)
        x, y = rng.uniform(x0, x1, m), rng.uniform(y0, y1, m)
        if rel.get("ocean_only", False):
            keep = ocean(x, y)
            if not keep.any():
                raise ValueError(f"no ocean among {m} points of the release box")
            x, y = x[keep], y[keep]
        xs.append(x)
        ys.append(y)
        have += x.size
    x, y = np.concatenate(xs)[:n], np.concatenate(ys)[:n]
    return {"x": x, "y": y, "z": np.full(n, float(rel["z"]))}


def schedule(traffic: dict, field_end_s: float):
    """Endless (start_s, end_s, piece_s) of the releases."""
    return registry.module("harness/schedules", traffic["schedule"]["kind"]).schedule(
        traffic, field_end_s)

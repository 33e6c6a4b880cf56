"""The plain reference of nemo-orca12: the ORCA-like mesh, its depth levels
and the seeded currents worked out again, sampled by ``CGridSampler``."""

from __future__ import annotations

import numpy as np

from reference import inputs
from reference.sampling import CGridSampler


def sampler(cfg: dict, seed: int, dtype):
    return CGridSampler(nx=cfg["columns"], ny=cfg["rows"],
                        depth_w=inputs.stretched_depth(cfg["levels"]),
                        t_step=cfg["frame_hours"] * 3600.0, nt=cfg["frames"],
                        m=inputs.modes(seed), fac=inputs.depth_factor(cfg["levels"]), dtype=dtype)


def ocean(cfg: dict, lon, lat):
    """The layout has no land."""
    return np.ones(np.shape(lon), bool)

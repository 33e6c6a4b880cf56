"""The plain reference of cmems-glo-phy-024: the regular axes, the fixed
coast and the seeded currents worked out again, sampled by
``AGridSampler``."""

from __future__ import annotations

import numpy as np

from reference import inputs
from reference.sampling import AGridSampler


def _land(cfg):
    return inputs.land_mask(cfg["land_seed"], cfg["rows"], cfg["columns"])


def sampler(cfg: dict, seed: int, dtype):
    X, Y = cfg["columns"], cfg["rows"]
    return AGridSampler(lon0=cfg["lon_first"], dlon=360.0 / X, nx=X, lat0=cfg["lat_first"],
                        dlat=(cfg["lat_last"] - cfg["lat_first"]) / (Y - 1), ny=Y,
                        t_step=cfg["frame_hours"] * 3600.0, nt=cfg["frames"], t0_h=0.0,
                        m=inputs.modes(seed), land=_land(cfg), dtype=dtype)


def ocean(cfg: dict, lon, lat):
    """True where the nearest node of (lon, lat) is not land."""
    X, Y = cfg["columns"], cfg["rows"]
    i = np.clip(np.rint((np.asarray(lon) - cfg["lon_first"]) / (360.0 / X)), 0, X - 1).astype(int)
    j = np.clip(np.rint((np.asarray(lat) - cfg["lat_first"])
                        / ((cfg["lat_last"] - cfg["lat_first"]) / (Y - 1))), 0, Y - 1).astype(int)
    return ~_land(cfg)[j, i]

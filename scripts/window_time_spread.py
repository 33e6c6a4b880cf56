#!/usr/bin/env python3
"""Windowed against resident runs in parcels_tpu and parcels_tpu_torch, on the CPU.

A resident field whose time axis is uniform brackets t with the O(1)
formula ``s = (t - origin) * (1 / step)``, ``tau = s - floor(s)``; a time
window drops that fast path and searches its f32 time values, ``tau = (t -
t_i) / (t_i+1 - t_i)``. Both are the JAX package's arithmetic. The two tau
differ in their last bits, and on a random 1-km velocity field the
difference grows over a run. This script measures that spread in both
packages (windowed against resident, same seeds), and the spread between
the packages in each mode, with 20,000 particles on two hourly fields
shaped as ``chip_smoke.py``'s streamed paths, cut in width: (13, 1, 100,
128) at dt 120 s for 12 h (as (j2)) and (24, 1, 100, 128) at dt 300 s for
23 h (as (j1)), AdvectionRK4, windows of 2 levels:

    python3 scripts/window_time_spread.py

It prints, for each pair, the largest position difference and the number
of lanes beyond rtol 1e-6 / atol 1e-3 m.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: (levels, dt seconds, hours) of the two runs
CONFIGS = ((13, 120, 12), (24, 300, 23))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import parcels_tpu as jp
    import parcels_tpu_torch as tp
    from parcels_tpu import xrlite as jxr
    from parcels_tpu.datasets.structured import _coords_2d as j_coords
    from parcels_tpu.datasets.structured import _wrap_sgrid as j_wrap
    from parcels_tpu_torch import xrlite as txr
    from parcels_tpu_torch.datasets.structured import _coords_2d as t_coords
    from parcels_tpu_torch.datasets.structured import _wrap_sgrid as t_wrap

    for T, dt_s, hours in CONFIGS:
        print(f"({T}, 1, 100, 128) hourly, dt {dt_s} s for {hours} h:")
        spread(jp, tp, jxr, txr, (j_coords, j_wrap), (t_coords, t_wrap), T, dt_s, hours)


def spread(jp, tp, jxr, txr, j_build, t_build, T, dt_s, hours):
    Z, Y, X = 1, 100, 128
    rng = np.random.default_rng(5)
    uv = {c: rng.uniform(-0.3, 0.3, (T, Z, Y, X)).astype(np.float32) for c in ("U", "V")}
    lon, lat = np.linspace(0.0, 1.28e5, X), np.linspace(0.0, 1e5, Y)
    taxis = np.datetime64("2000-01-01") + np.arange(T) * np.timedelta64(3600, "s")
    dims = ["time", "depth", "YG", "XG"]

    def dataset(xr_mod, coords, wrap):
        ds = xr_mod.Dataset({c: (dims, uv[c]) for c in uv},
                            coords=coords(lon, lat, time=taxis, depth=np.array([0.0]), mesh="flat"))
        return wrap(ds, X, Y)

    n = 20000
    rng = np.random.default_rng(1)
    seeds = dict(x=rng.uniform(2e4, 1.08e5, n), y=rng.uniform(2e4, 8e4, n), t=np.zeros(n))
    runs = {}
    for name, mod, ds, kw in (("port", tp, dataset(txr, *t_build), dict(device="cpu")),
                              ("jax", jp, dataset(jxr, *j_build), {})):
        for mode in ("resident", "windowed"):
            fs = mod.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw)
            if mode == "windowed":
                fs.set_time_window(2)
            pset = mod.ParticleSet(fs, **seeds)
            pset.execute(mod.AdvectionRK4, dt=np.timedelta64(dt_s, "s"),
                         runtime=np.timedelta64(hours, "h"))
            runs[name, mode] = np.stack([pset.x, pset.y])

    for a, b in ((("port", "windowed"), ("port", "resident")),
                 (("jax", "windowed"), ("jax", "resident")),
                 (("port", "windowed"), ("jax", "windowed")),
                 (("port", "resident"), ("jax", "resident"))):
        d = np.abs(runs[a] - runs[b])
        beyond = (d > 1e-3 + 1e-6 * np.abs(runs[b])).any(axis=0)
        print(f"  {a[0]} {a[1]} against {b[0]} {b[1]}: max |difference| {d.max():.6g} m, "
              f"{int(beyond.sum())} of {n} lanes beyond rtol 1e-6 / atol 1e-3")


if __name__ == "__main__":
    main()

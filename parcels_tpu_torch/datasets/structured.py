"""Idealized structured datasets with analytic truth trajectories.

The subset of the JAX package's fixture library (datasets/structured.py)
that the rectilinear A-grid slice of the port uses: the SGRID wrapping
helpers, the zero-flow ``simple_UV_dataset`` that tests overwrite, and the
Fabbroni (2009) moving eddy with its closed-form trajectory.
"""

from __future__ import annotations

import numpy as np
from parcels_tpu_torch import xrlite as xr

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch._core.timeutils import timedelta_to_float

__all__ = ["moving_eddy_dataset", "simple_UV_dataset"]

def _wrap_sgrid(ds: xr.Dataset, xdim: int, ydim: int, y_padding=sgrid.Padding.LOW, with_z=True) -> xr.Dataset:
    vertical = (
        (sgrid.FaceNodePadding("ZC", "depth", sgrid.Padding.BOTH),) if with_z else None
    )
    meta = sgrid.SGrid2DMetadata(
        node_dimensions=("XG", "YG"),
        node_coordinates=("lon", "lat"),
        face_dimensions=(
            sgrid.FaceNodePadding("XC", "XG", sgrid.Padding.LOW),
            sgrid.FaceNodePadding("YC", "YG", y_padding),
        ),
        vertical_dimensions=vertical,
    )
    return sgrid.attach_sgrid_metadata(ds, meta)


def _coords_2d(lon, lat, time=None, depth=None, mesh="flat"):
    xdim, ydim = len(lon), len(lat)
    units = {"flat": "m", "spherical": "degrees_east"}[mesh]
    units_y = {"flat": "m", "spherical": "degrees_north"}[mesh]
    coords = {
        "YC": (["YC"], np.arange(ydim) + 0.5, {"axis": "Y"}),
        "YG": (["YG"], np.arange(ydim, dtype=np.float64), {"axis": "Y", "c_grid_axis_shift": -0.5}),
        "XC": (["XC"], np.arange(xdim) + 0.5, {"axis": "X"}),
        "XG": (["XG"], np.arange(xdim, dtype=np.float64), {"axis": "X", "c_grid_axis_shift": -0.5}),
        "lat": (["YG"], lat, {"axis": "Y", "units": units_y}),
        "lon": (["XG"], lon, {"axis": "X", "units": units}),
    }
    if time is not None:
        coords["time"] = (["time"], time, {"axis": "T"})
    if depth is not None:
        coords["depth"] = (["depth"], depth, {"axis": "Z"})
    return coords


def simple_UV_dataset(dims=(360, 2, 30, 4), maxdepth=1.0, mesh="spherical"):
    """Zero U/V on a global(ish) grid; tests overwrite the values."""
    tdim, zdim, ydim, xdim = dims
    max_lon = 180.0 if mesh == "spherical" else 1e6
    max_lat = 90.0 if mesh == "spherical" else 1e6
    lon = np.linspace(-max_lon, max_lon, xdim)
    lat = np.linspace(-max_lat, max_lat, ydim)
    time = np.array(
        [np.datetime64("2000-01-01") + np.timedelta64(int(i * 365 * 86400 / (tdim - 1)), "s") for i in range(tdim)]
    )
    depth = np.linspace(0, maxdepth, zdim)
    ds = xr.Dataset(
        {
            "U": (["time", "depth", "YG", "XG"], np.zeros(dims)),
            "V": (["time", "depth", "YG", "XG"], np.zeros(dims)),
        },
        coords=_coords_2d(lon, lat, time=time, depth=depth, mesh=mesh),
    )
    return _wrap_sgrid(ds, xdim, ydim)


def moving_eddy_dataset(xdim=2, ydim=2):
    """Spatially-uniform, time-oscillating inertial eddy (Fabbroni 2009 no-decay case)."""
    f, u_0, u_g = 1.0e-4, 0.3, 0.04
    lon = np.linspace(0, 25000, xdim, dtype=np.float32)
    lat = np.linspace(0, 25000, ydim, dtype=np.float32)
    time = np.arange(np.timedelta64(0, "s"), np.timedelta64(7, "h"), np.timedelta64(1, "m"))
    tsec = timedelta_to_float(time)
    U = (u_g + (u_0 - u_g) * np.cos(f * tsec))[:, None, None, None] * np.ones((1, 1, ydim, xdim))
    V = (-(u_0 - u_g) * np.sin(f * tsec))[:, None, None, None] * np.ones((1, 1, ydim, xdim))
    ds = xr.Dataset(
        {
            "U": (["time", "depth", "YG", "XG"], U.astype(np.float32)),
            "V": (["time", "depth", "YG", "XG"], V.astype(np.float32)),
        },
        coords=_coords_2d(lon, lat, time=time, depth=np.array([0.0]), mesh="flat"),
        attrs={"u_0": u_0, "u_g": u_g, "f": f},
    )
    return _wrap_sgrid(ds, xdim, ydim, y_padding=sgrid.Padding.HIGH)


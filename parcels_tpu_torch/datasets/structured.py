"""Idealized structured datasets with analytic truth trajectories.

The subset of the JAX package's fixture library (datasets/structured.py)
that the port's slices use: the SGRID wrapping helpers, the zero-flow
``simple_UV_dataset`` that tests overwrite, the solid-body rotation, the
Fabbroni (2009) moving and decaying eddies with their closed-form
trajectories, the A- and C-grid peninsula, the Stommel gyre and the rotated
curvilinear grid.
"""

from __future__ import annotations

import numpy as np
from parcels_tpu_torch import xrlite as xr

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch._core.timeutils import timedelta_to_float

__all__ = [
    "curvilinear_rotated_dataset",
    "decaying_moving_eddy_dataset",
    "moving_eddy_dataset",
    "peninsula_dataset",
    "radial_rotation_dataset",
    "simple_UV_dataset",
    "stommel_gyre_dataset",
]

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


def radial_rotation_dataset(xdim=200, ydim=200):
    """Solid-body rotation about (30, 30) with period 1 day, flat mesh."""
    lon = np.linspace(0, 60, xdim, dtype=np.float32)
    lat = np.linspace(0, 60, ydim, dtype=np.float32)
    x0 = y0 = 30.0
    omega = 2 * np.pi / 86400.0

    LON, LAT = np.meshgrid(lon, lat)
    r = np.sqrt((LON - x0) ** 2 + (LAT - y0) ** 2)
    theta = np.arctan2(LAT - y0, LON - x0)
    U = np.broadcast_to(r * np.sin(theta) * omega, (2, 1, ydim, xdim)).astype(np.float32)
    V = np.broadcast_to(-r * np.cos(theta) * omega, (2, 1, ydim, xdim)).astype(np.float32)

    time = np.array([np.timedelta64(0, "s"), np.timedelta64(10, "D")])
    ds = xr.Dataset(
        {"U": (["time", "depth", "YG", "XG"], U), "V": (["time", "depth", "YG", "XG"], V)},
        coords=_coords_2d(lon, lat, time=time, depth=np.array([0.0]), mesh="flat"),
        attrs={"omega": omega},
    )
    return _wrap_sgrid(ds, xdim, ydim, y_padding=sgrid.Padding.HIGH)


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


def decaying_moving_eddy_dataset(xdim=2, ydim=2):
    """Decaying inertial eddy over geostrophic flow (Fabbroni 2009)."""
    u_g, u_0 = 0.04, 0.3
    gamma = 1.0 / (2.89 * 86400)
    gamma_g = 1.0 / (28.9 * 86400)
    f = 1.0e-4
    time = np.arange(
        np.timedelta64(0, "s"), np.timedelta64(1, "D") + np.timedelta64(1, "h"), np.timedelta64(2, "m")
    )
    lon = np.linspace(0, 20000, xdim, dtype=np.float32)
    lat = np.linspace(5000, 12000, ydim, dtype=np.float32)
    tsec = timedelta_to_float(time)
    U = (u_g * np.exp(-gamma_g * tsec) + (u_0 - u_g) * np.exp(-gamma * tsec) * np.cos(f * tsec))[
        :, None, None, None
    ] * np.ones((1, 1, ydim, xdim))
    V = (-(u_0 - u_g) * np.exp(-gamma * tsec) * np.sin(f * tsec))[:, None, None, None] * np.ones(
        (1, 1, ydim, xdim)
    )
    ds = xr.Dataset(
        {
            "U": (["time", "depth", "YG", "XG"], U.astype(np.float32)),
            "V": (["time", "depth", "YG", "XG"], V.astype(np.float32)),
        },
        coords=_coords_2d(lon, lat, time=time, depth=np.array([0.0]), mesh="flat"),
        attrs={"u_0": u_0, "u_g": u_g, "f": f, "gamma": gamma, "gamma_g": gamma_g},
    )
    return _wrap_sgrid(ds, xdim, ydim, y_padding=sgrid.Padding.HIGH)


def _cgrid_coords(lon, lat, xdim, ydim):
    return {
        "YC": (["YC"], np.arange(ydim) - 0.5, {"axis": "Y", "c_grid_axis_shift": +0.5}),
        "YG": (["YG"], np.arange(ydim, dtype=np.float64), {"axis": "Y"}),
        "XC": (["XC"], np.arange(xdim) - 0.5, {"axis": "X", "c_grid_axis_shift": +0.5}),
        "XG": (["XG"], np.arange(xdim, dtype=np.float64), {"axis": "X"}),
        "lat": (["YG"], lat, {"axis": "Y", "units": "m"}),
        "lon": (["XG"], lon, {"axis": "X", "units": "m"}),
    }


def peninsula_dataset(xdim=100, ydim=50, mesh="flat", grid_type="A"):
    """Steady flow around an idealized peninsula (ICES CRR 295 Fig 2.2.3).

    P is the streamfunction; trajectories conserve P exactly, which the
    tests use as the correctness criterion for both A- and C-grid variants.
    """
    domainsizeX, domainsizeY = (1.0e5, 5.0e4)
    La = np.linspace(0, domainsizeX, xdim, dtype=np.float32)
    Wa = np.linspace(0, domainsizeY, ydim, dtype=np.float32)

    u0 = 1
    x0 = domainsizeX / 2
    R = 0.32 * domainsizeX / 2

    x, y = np.meshgrid(La, Wa, sparse=True, indexing="xy")
    P = (u0 * R**2 * y / ((x - x0) ** 2 + y**2) - u0 * y).astype(np.float32)
    landpoints = P >= 0.0
    P[landpoints] = 0.0

    if grid_type == "A":
        U = u0 - u0 * R**2 * ((x - x0) ** 2 - y**2) / (((x - x0) ** 2 + y**2) ** 2)
        V = -2 * u0 * R**2 * ((x - x0) * y) / (((x - x0) ** 2 + y**2) ** 2)
        U = np.broadcast_to(U, P.shape).copy()
        V = np.broadcast_to(V, P.shape).copy()
        U[landpoints] = 0.0
        V[landpoints] = 0.0
        Udims = ["YC", "XC"]
        Vdims = ["YC", "XC"]
    elif grid_type == "C":
        U = np.zeros(P.shape, dtype=np.float32)
        V = np.zeros(P.shape, dtype=np.float32)
        U[1:, :] = -(P[1:, :] - P[:-1, :]) / (Wa[1] - Wa[0])
        V[:, 1:] = (P[:, 1:] - P[:, :-1]) / (La[1] - La[0])
        Udims = ["YG", "XC"]
        Vdims = ["YC", "XG"]
    else:
        raise ValueError(f"grid_type {grid_type} is not a valid option")

    lon = La / 1852.0 / 60.0 if mesh == "spherical" else La
    lat = Wa / 1852.0 / 60.0 if mesh == "spherical" else Wa

    ds = xr.Dataset(
        {
            "U": (Udims, np.asarray(U, dtype=np.float32)),
            "V": (Vdims, np.asarray(V, dtype=np.float32)),
            "P": (["YC", "XC"], P),
        },
        coords=_cgrid_coords(lon, lat, xdim, ydim),
    )
    if mesh == "spherical":
        ds["lon"].attrs["units"] = "degrees_east"
        ds["lat"].attrs["units"] = "degrees_north"
    meta = sgrid.SGrid2DMetadata(
        node_dimensions=("XG", "YG"),
        node_coordinates=("lon", "lat"),
        face_dimensions=(
            sgrid.FaceNodePadding("XC", "XG", sgrid.Padding.LOW),
            sgrid.FaceNodePadding("YC", "YG", sgrid.Padding.LOW),
        ),
    )
    return sgrid.attach_sgrid_metadata(ds, meta)


def stommel_gyre_dataset(xdim=200, ydim=200, grid_type="A"):
    """Stommel western-boundary gyre (Fabbroni 2009); P conserved on trajectories."""
    a = b = 10000 * 1e3
    scalefac = 0.05
    dx, dy = a / xdim, b / ydim

    lon = np.linspace(0, a, xdim, dtype=np.float32)
    lat = np.linspace(0, b, ydim, dtype=np.float32)

    beta = 2e-11
    r = 1 / (11.6 * 86400)
    es = r / (beta * a)

    XI = lon[None, :] / a
    YI = lat[:, None] / b
    P = ((1 - np.exp(-XI / es) - XI) * np.pi * np.sin(np.pi * YI) * scalefac).astype(np.float32)
    U = np.zeros((ydim, xdim), dtype=np.float32)
    V = np.zeros((ydim, xdim), dtype=np.float32)
    if grid_type == "A":
        U = (-(1 - np.exp(-XI / es) - XI) * np.pi**2 * np.cos(np.pi * YI) * scalefac).astype(np.float32)
        V = ((np.exp(-XI / es) / es - 1) * np.pi * np.sin(np.pi * YI) * scalefac).astype(np.float32)
        Udims = ["YC", "XC"]
        Vdims = ["YC", "XC"]
    else:
        U[1:, :] = -(P[1:, :] - P[:-1, :]) / dy * b
        V[:, 1:] = (P[:, 1:] - P[:, :-1]) / dx * a
        Udims = ["YG", "XC"]
        Vdims = ["YC", "XG"]

    ds = xr.Dataset(
        {"U": (Udims, U), "V": (Vdims, V), "P": (["YG", "XG"], P)},
        coords=_cgrid_coords(lon, lat, xdim, ydim),
    )
    meta = sgrid.SGrid2DMetadata(
        node_dimensions=("XG", "YG"),
        node_coordinates=("lon", "lat"),
        face_dimensions=(
            sgrid.FaceNodePadding("XC", "XG", sgrid.Padding.LOW),
            sgrid.FaceNodePadding("YC", "YG", sgrid.Padding.LOW),
        ),
    )
    return sgrid.attach_sgrid_metadata(ds, meta)


def curvilinear_rotated_dataset(xdim=60, ydim=40, angle_deg=30.0, mesh="flat"):
    """A rectilinear grid rotated by ``angle_deg`` -> genuinely 2-D lon/lat.

    Carries a uniform eastward flow, so trajectories have a closed form and
    the curvilinear search/interp path can be validated exactly.
    """
    spacing = 1000.0 if mesh == "flat" else 0.05
    xg, yg = np.meshgrid(np.arange(xdim) * spacing, np.arange(ydim) * spacing)
    th = np.deg2rad(angle_deg)
    lon2d = (np.cos(th) * xg - np.sin(th) * yg).astype(np.float64)
    lat2d = (np.sin(th) * xg + np.cos(th) * yg).astype(np.float64)
    if mesh == "spherical":
        lon2d += 2.0
        lat2d += 45.0

    U = np.ones((2, 1, ydim, xdim), dtype=np.float32)
    V = np.zeros((2, 1, ydim, xdim), dtype=np.float32)
    time = np.array([np.timedelta64(0, "s"), np.timedelta64(10, "D")])
    units = "degrees_east" if mesh == "spherical" else "m"
    units_y = "degrees_north" if mesh == "spherical" else "m"
    ds = xr.Dataset(
        {"U": (["time", "depth", "YG", "XG"], U), "V": (["time", "depth", "YG", "XG"], V)},
        coords={
            "time": (["time"], time, {"axis": "T"}),
            "depth": (["depth"], np.array([0.0]), {"axis": "Z"}),
            "YC": (["YC"], np.arange(ydim) + 0.5, {"axis": "Y"}),
            "YG": (["YG"], np.arange(ydim, dtype=np.float64), {"axis": "Y"}),
            "XC": (["XC"], np.arange(xdim) + 0.5, {"axis": "X"}),
            "XG": (["XG"], np.arange(xdim, dtype=np.float64), {"axis": "X"}),
            "lat": (["YG", "XG"], lat2d, {"axis": "Y", "units": units_y}),
            "lon": (["YG", "XG"], lon2d, {"axis": "X", "units": units}),
        },
    )
    return _wrap_sgrid(ds, xdim, ydim)

"""Idealized triangular-mesh (UGRID) datasets with analytic flows.

Copy of the JAX package's ``datasets/unstructured.py``, which mirrors the
reference fixture library for unstructured grids
(reference src/parcels/_datasets/unstructured/{generic,generated}.py):
Delaunay triangulations of a square carrying uniform-translation,
solid-body-rotation and 3-D helix flows, with data on nodes or faces and
on layer centers (zc) or interfaces (zf).
"""

from __future__ import annotations

import numpy as np

from parcels_tpu_torch import xrlite as xr

__all__ = ["delaunay_flow_dataset", "fesom2_style_dataset"]


def _delaunay_mesh(nx: int, ny: int, extent: float, seed: int = 0):
    from scipy.spatial import Delaunay

    gx, gy = np.meshgrid(np.linspace(0, extent, nx), np.linspace(0, extent, ny))
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    # jitter interior points so triangles are irregular (like real meshes)
    rng = np.random.default_rng(seed)
    interior = (
        (pts[:, 0] > 0) & (pts[:, 0] < extent) & (pts[:, 1] > 0) & (pts[:, 1] < extent)
    )
    h = extent / (nx - 1)
    pts[interior] += rng.uniform(-0.2 * h, 0.2 * h, pts[interior].shape)
    tri = Delaunay(pts)
    return pts[:, 0], pts[:, 1], tri.simplices.astype(np.int32)


def delaunay_flow_dataset(
    flow: str = "uniform",
    placement: str = "node",
    vertical: str = "zc",
    nx: int = 20,
    ny: int = 20,
    extent: float = 1e5,
    maxdepth: float = 100.0,
    nz: int = 5,
    u0: float = 1.0,
    v0: float = 0.5,
    w0: float = 0.0,
    with_w: bool = False,
) -> xr.Dataset:
    """Triangulated square with an analytic flow.

    flow: "uniform" (u0, v0, w0), "rotation" (solid body about the center,
    period 1 day), "helix" (rotation + constant w0 downwelling).
    placement: "node" | "face"; vertical: "zc" | "zf".
    """
    node_lon, node_lat, conn = _delaunay_mesh(nx, ny, extent)
    n_node = node_lon.shape[0]
    n_face = conn.shape[0]
    zf = np.linspace(0, maxdepth, nz)
    zc = 0.5 * (zf[:-1] + zf[1:])
    time = np.array([np.datetime64("2000-01-01"), np.datetime64("2000-01-11")])

    if placement == "node":
        px, py = node_lon, node_lat
        ldim, nl = "n_node", n_node
    else:
        px = node_lon[conn].mean(axis=1)
        py = node_lat[conn].mean(axis=1)
        ldim, nl = "n_face", n_face

    omega = 2 * np.pi / 86400.0
    c = extent / 2
    if flow == "uniform":
        u = np.full(nl, u0)
        v = np.full(nl, v0)
        w = np.full(nl, w0)
    elif flow in ("rotation", "helix"):
        r = np.sqrt((px - c) ** 2 + (py - c) ** 2)
        theta = np.arctan2(py - c, px - c)
        u = r * np.sin(theta) * omega
        v = -r * np.cos(theta) * omega
        w = np.full(nl, w0)
    else:
        raise ValueError(f"Unknown flow {flow!r}")

    vdim = vertical
    nv = nz if vertical == "zf" else nz - 1
    shape = (len(time), nv, nl)

    def full(a):
        return np.broadcast_to(a, shape).astype(np.float32).copy()

    data_vars = {
        "U": ((("time", vdim, ldim)), full(u)),
        "V": ((("time", vdim, ldim)), full(v)),
    }
    if with_w or flow == "helix":
        data_vars["W"] = ((("time", vdim, ldim)), full(w))

    ds = xr.Dataset(
        data_vars,
        coords={
            "time": (("time",), time),
            "zf": (("zf",), zf),
            "zc": (("zc",), zc),
            "node_lon": (("n_node",), node_lon, {"units": "m"}),
            "node_lat": (("n_node",), node_lat, {"units": "m"}),
        },
        attrs={"omega": omega, "center": c, "extent": extent},
    )
    ds["face_node_connectivity"] = xr.DataArray(conn, dims=("n_face", "three"))
    return ds


def fesom2_style_dataset(which: str = "data", nx: int = 16, ny: int = 16, nz: int = 5,
                         extent: float = 1e5):
    """FESOM2-native-convention mimic (reference unstructured/generic.py:112-206
    and the Benchmarks_FESOM2-baroclinic-gyre registry layout).

    ``which='grid'`` returns the mesh file (node coords + triangles, FESOM
    naming: nod2/elem dims); ``which='data'`` returns velocities ``u``/``v``
    on elements over ``nz1`` layer centers plus ``w`` on ``nz`` interfaces —
    the split the real benchmark dataset ships.
    """
    node_lon, node_lat, conn = _delaunay_mesh(nx, ny, extent, seed=3)
    n_node = node_lon.shape[0]
    n_elem = conn.shape[0]
    zf = np.linspace(0, 1000.0, nz)
    zc = 0.5 * (zf[:-1] + zf[1:])
    time = np.array([np.datetime64("2000-01-01"), np.datetime64("2000-01-02")])

    if which == "grid":
        return xr.Dataset(
            {
                "face_nodes": (("elem", "three"), conn),
            },
            coords={
                "lon": (("nod2",), node_lon, {"units": "degrees_east"}),
                "lat": (("nod2",), node_lat, {"units": "degrees_north"}),
                "nz": (("nz",), zf, {"units": "m", "positive": "down"}),
                "nz1": (("nz1",), zc, {"units": "m", "positive": "down"}),
            },
        )
    if which != "data":
        raise ValueError(f"which must be 'data' or 'grid'. Got {which!r}")

    rng = np.random.default_rng(9)
    shp_c = (len(time), nz - 1, n_elem)
    shp_f = (len(time), nz, n_node)
    return xr.Dataset(
        {
            "u": (("time", "nz1", "elem"), rng.uniform(-0.3, 0.3, shp_c).astype(np.float32),
                  {"units": "m/s", "description": "zonal velocity"}),
            "v": (("time", "nz1", "elem"), rng.uniform(-0.3, 0.3, shp_c).astype(np.float32),
                  {"units": "m/s", "description": "meridional velocity"}),
            "w": (("time", "nz", "nod2"), rng.uniform(-1e-4, 1e-4, shp_f).astype(np.float32),
                  {"units": "m/s", "description": "vertical velocity"}),
        },
        coords={
            "time": (("time",), time),
            "nz": (("nz",), zf, {"units": "m", "positive": "down"}),
            "nz1": (("nz1",), zc, {"units": "m", "positive": "down"}),
        },
    )

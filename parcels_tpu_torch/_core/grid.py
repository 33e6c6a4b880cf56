"""Structured grid: host-side descriptor + batched rectilinear search (torch).

Port of the JAX package's ``_core/grid.py``. ``XGrid`` (host) parses SGRID
metadata once at ingest, validates axes and precomputes everything static —
axis sizes, uniform-spacing detection, staggering offsets from padding —
into a hashable ``GridSpec``. ``grid_search`` brackets a particle batch on
the device, dispatching on the static spec.

This slice covers rectilinear grids; curvilinear grids belong to a later
slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.mesh import BaseMesh, get_mesh
from parcels_tpu_torch._core.timeutils import TimeInterval, datetimes_to_float_seconds

__all__ = ["GridSpec", "XGrid", "grid_search"]

_AXES_ORDER = "ZYX"

LATER_SLICE_CURVILINEAR = "the curvilinear C-grid slice of the port"


def _uniform_spacing(arr: np.ndarray) -> tuple[float, float, float] | None:
    """Return (origin, step, last) if ``arr`` is uniformly spaced, else None."""
    if arr.ndim != 1 or arr.shape[0] < 2:
        return None
    d = np.diff(arr.astype(np.float64))
    step = d[0]
    if step <= 0:
        return None
    if np.allclose(d, step, rtol=1e-5, atol=0.0):
        return float(arr[0]), float(step), float(arr[-1])
    return None


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static, hashable description of a rectilinear structured grid."""

    axes: tuple[str, ...]  # subset of ("Z", "Y", "X") present
    spherical: bool
    deg2m: float
    xdim: int  # number of cells along each axis (0 if absent)
    ydim: int
    zdim: int
    lon_uniform: tuple[float, float, float] | None
    lat_uniform: tuple[float, float, float] | None
    depth_uniform: tuple[float, float, float] | None
    time_uniform: tuple[float, float, float] | None
    # staggering offset per axis derived from SGRID padding: 1 if LOW else 0
    offset_x: int = 0
    offset_y: int = 0
    offset_z: int = 0


class XGrid:
    """Host-side rectilinear grid built from an SGRID-annotated dataset."""

    def __init__(self, ds: xr.Dataset, mesh: Literal["flat", "spherical"] | BaseMesh = "flat"):
        self.sgrid_metadata = sgrid.parse_sgrid_metadata(ds)
        self._mesh = get_mesh(mesh)
        md = self.sgrid_metadata

        dim_to_axis = md.dim_to_axis()
        present_axes = sorted(
            {ax for d, ax in dim_to_axis.items() if d in ds.dims}, key=_AXES_ORDER.index
        )
        self.axes: list[str] = list(present_axes)

        self.lon = np.asarray(ds["lon"].values) if "lon" in ds else np.zeros(1)
        self.lat = np.asarray(ds["lat"].values) if "lat" in ds else np.zeros(1)
        self.depth = np.asarray(ds["depth"].values) if "depth" in ds else np.zeros(1)
        if self.lon.ndim != 1 or self.lat.ndim != 1:
            raise NotImplementedError(
                f"Curvilinear grids (2-D lon/lat) belong to {LATER_SLICE_CURVILINEAR}."
            )
        if "X" in self.axes or "Y" in self.axes:
            _validate_lat_lon(self.lon, self.lat)
        if "Z" in self.axes and not np.all(np.diff(self.depth) > 0):
            raise ValueError("Depth coordinate must be strictly increasing.")

        self._datetimes = np.asarray(ds["time"].values) if "time" in ds.dims else None
        if self._datetimes is not None and len(self._datetimes) > 0:
            self.time_interval = _make_time_interval(self._datetimes)
            self.time = datetimes_to_float_seconds(self._datetimes, self.time_interval.left)
        else:
            self.time_interval = None
            self.time = np.zeros(1, dtype=np.float64)

        def cells(axis: str, coord: np.ndarray) -> int:
            if axis not in self.axes:
                return 0
            n_nodes = self.depth.shape[0] if axis == "Z" else coord.shape[0]
            return n_nodes - 1

        offsets = {}
        for axis in ("X", "Y", "Z"):
            try:
                offsets[axis] = 1 if md.axis_padding(axis) == sgrid.Padding.LOW else 0
            except ValueError:
                offsets[axis] = 0

        self.spec = GridSpec(
            axes=tuple(self.axes),
            spherical=self._mesh.is_spherical(),
            deg2m=self.deg2m,
            xdim=cells("X", self.lon),
            ydim=cells("Y", self.lat),
            zdim=cells("Z", self.depth),
            lon_uniform=_uniform_spacing(self.lon),
            lat_uniform=_uniform_spacing(self.lat),
            depth_uniform=_uniform_spacing(self.depth),
            time_uniform=_uniform_spacing(self.time),
            offset_x=offsets["X"],
            offset_y=offsets["Y"],
            offset_z=offsets["Z"],
        )

    @property
    def deg2m(self) -> float:
        return self._mesh.deg2m if self._mesh.is_spherical() else 1.0

    @property
    def mesh(self) -> BaseMesh:
        return self._mesh

    @property
    def xdim(self) -> int:
        return self.spec.xdim

    @property
    def ydim(self) -> int:
        return self.spec.ydim

    @property
    def zdim(self) -> int:
        return self.spec.zdim

    def device_arrays(self, device, dtype=np.float32) -> dict:
        """Grid coordinate arrays on ``device`` (part of the field arrays)."""
        return {
            "lon": torch.as_tensor(self.lon.astype(dtype), device=device),
            "lat": torch.as_tensor(self.lat.astype(dtype), device=device),
            "depth": torch.as_tensor(self.depth.astype(dtype), device=device),
            "time": torch.as_tensor(self.time.astype(np.float32), device=device),
        }

    def make_view(self, garrs: dict):
        from parcels_tpu_torch._core.field import GridView

        return GridView(self.spec, garrs)

    def ravel_index(self, zi, yi, xi):
        ydim = max(self.spec.ydim, 1)
        xdim = max(self.spec.xdim, 1)
        return (zi * ydim + yi) * xdim + xi

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def __repr__(self):
        mesh = "spherical" if self.spec.spherical else "flat"
        return (
            f"XGrid(rectilinear, {mesh}, cells z={self.spec.zdim} y={self.spec.ydim} "
            f"x={self.spec.xdim}, tdim={self.time.shape[0]})"
        )


def _validate_lat_lon(lon: np.ndarray, lat: np.ndarray):
    if lon.shape[0] > 1 and not np.all(np.diff(lon) > 0):
        raise ValueError("1-D lon must be strictly increasing.")
    if lat.shape[0] > 1 and not np.all(np.diff(lat) > 0):
        raise ValueError("1-D lat must be strictly increasing.")


def _make_time_interval(datetimes: np.ndarray) -> TimeInterval | None:
    if len(datetimes) < 2:
        return None
    left, right = datetimes[0], datetimes[-1]
    if np.issubdtype(np.asarray(left).dtype, np.datetime64):
        return TimeInterval(np.datetime64(left, "ns"), np.datetime64(right, "ns"))
    return TimeInterval(left, right)


def grid_search(spec: GridSpec, garrs: dict, z, y, x):
    """Locate particles on a rectilinear grid. Returns {axis: {"index", "bcoord"}}.

    Z, Y and X are independent 1-D brackets (reference XGrid.search).
    """

    def axis(name, coord, pos, uniform):
        if name in spec.axes:
            return index_search.search_1d(garrs[coord], pos, uniform)
        return torch.zeros(pos.shape, dtype=torch.int32, device=pos.device), torch.zeros_like(pos)

    zi, zeta = axis("Z", "depth", z, spec.depth_uniform)
    yi, eta = axis("Y", "lat", y, spec.lat_uniform)
    xi, xsi = axis("X", "lon", x, spec.lon_uniform)
    return {
        "Z": {"index": zi, "bcoord": zeta},
        "Y": {"index": yi, "bcoord": eta},
        "X": {"index": xi, "bcoord": xsi},
    }

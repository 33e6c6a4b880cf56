"""Structured grid: host-side descriptor + batched search (torch).

Port of the JAX package's ``_core/grid.py``. ``XGrid`` (host) parses SGRID
metadata once at ingest, validates axes and precomputes everything static —
axis sizes, uniform-spacing detection, staggering offsets from padding, and
for curvilinear grids the coarse lookup raster, the per-cell tangent-frame
table and the C-grid geometry table — into a hashable ``GridSpec`` and host
arrays. ``grid_search`` brackets a particle batch on the device, dispatching
on the static spec (rectilinear brackets or the curvilinear walk).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.basegrid import BaseGrid
from parcels_tpu_torch._core.mesh import BaseMesh, get_mesh
from parcels_tpu_torch._core.timeutils import TimeInterval, datetimes_to_float_seconds

__all__ = ["GridSpec", "XGrid", "grid_search"]

_AXES_ORDER = "ZYX"


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
    """Static, hashable description of a structured grid."""

    axes: tuple[str, ...]  # subset of ("Z", "Y", "X") present
    curvilinear: bool
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
    has_lookup: bool = False
    # global out-of-bounds limits of a band's or tile's slab (parallel/): the
    # slab's nodes run past the domain edge, the bounds stay the domain's
    y_oob_bounds: tuple[float, float] | None = None
    x_oob_bounds: tuple[float, float] | None = None


class XGrid(BaseGrid):
    """Host-side structured grid built from an SGRID-annotated dataset."""

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
        if "X" in self.axes or "Y" in self.axes:
            _validate_lat_lon(self.lon, self.lat)
        if "Z" in self.axes and not np.all(np.diff(self.depth) > 0):
            raise ValueError("Depth coordinate must be strictly increasing.")
        curvilinear = self.lon.ndim == 2
        if self.lon.ndim > 2:
            raise NotImplementedError("lon/lat arrays with >2 dims are not supported.")

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
            n_nodes = coord.shape[-1] if axis == "X" else coord.shape[0]
            if axis == "Z":
                n_nodes = self.depth.shape[0]
            return n_nodes - 1

        offsets = {}
        for axis in ("X", "Y", "Z"):
            try:
                offsets[axis] = 1 if md.axis_padding(axis) == sgrid.Padding.LOW else 0
            except ValueError:
                offsets[axis] = 0

        self._lookup = _build_curvilinear_lookup(self.lon, self.lat) if curvilinear else None
        # set by the FieldSet when a C-grid vector field lives on this grid
        self._needs_cgrid_geom = False
        self._pic_table_cache = None
        self._cgrid_geom_cache = None

        self.spec = GridSpec(
            axes=tuple(self.axes),
            curvilinear=curvilinear,
            spherical=self._mesh.is_spherical(),
            deg2m=self.deg2m,
            xdim=cells("X", self.lon),
            ydim=cells("Y", self.lat),
            zdim=cells("Z", self.depth),
            lon_uniform=_uniform_spacing(self.lon) if not curvilinear else None,
            lat_uniform=_uniform_spacing(self.lat) if not curvilinear else None,
            depth_uniform=_uniform_spacing(self.depth),
            time_uniform=_uniform_spacing(self.time),
            offset_x=offsets["X"],
            offset_y=offsets["Y"],
            offset_z=offsets["Z"],
            has_lookup=self._lookup is not None,
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

    def get_axis_dim(self, axis: str) -> int:
        """Cell count along an axis."""
        if axis not in self.axes:
            raise ValueError(
                f"Axis {axis!r} is not part of this grid. Available axes: {self.axes}"
            )
        return {"X": self.spec.xdim, "Y": self.spec.ydim, "Z": self.spec.zdim}[axis]

    def get_axis_dim_mapping(self, dims) -> dict[str, str]:
        """``{axis: dim}`` for the dims of ``dims`` that lie on this grid's axes."""
        dim_to_axis = self.sgrid_metadata.dim_to_axis()
        out = {}
        for d in dims:
            ax = dim_to_axis.get(str(d))
            if ax in self.axes:
                out[ax] = str(d)
        return out

    def localize(self, position: dict, dims) -> dict:
        """Convert an f-point search position to a variable's staggered frame.

        Reference API (xgrid.py:233-281 and ``_convert_center_pos_to_fpoint``
        :538-565): given ``position`` as ``{axis: (index, bcoord)}`` (tuples,
        or the ``{"index", "bcoord"}`` dicts ``search`` returns, numpy or
        torch) and the variable's ``dims``, return ``{dim: (index, bcoord)}``
        in the frame of the staggered grid the variable lives on. Face-placed
        dims shift the barycentric coordinate by -0.5 (borrowing a cell when
        it goes negative) and add the LOW/BOTH-padding index offset;
        node-placed dims pass through. Host arithmetic in float64, as the JAX
        package's.
        """
        md = self.sgrid_metadata
        dim_to_axis = md.dim_to_axis()
        axis_to_dim = {dim_to_axis[d]: d for d in dims if d in dim_to_axis}
        out = {}
        for axis, pos in position.items():
            if axis not in axis_to_dim:
                continue
            dim = axis_to_dim[axis]
            index, bcoord = (pos["index"], pos["bcoord"]) if isinstance(pos, dict) else pos
            index, bcoord = _host_array(index), _host_array(bcoord)
            scalar = np.ndim(index) == 0
            bcoord = bcoord.astype(np.float64)
            if md.dim_position(dim) == "face":
                bcoord = bcoord - 0.5
                borrow = bcoord < 0
                bcoord = np.where(borrow, bcoord + 1.0, bcoord)
                index = index - borrow.astype(index.dtype)
                if md.axis_padding(axis) in (sgrid.Padding.BOTH, sgrid.Padding.LOW):
                    index = index + 1
            if scalar:
                out[dim] = (int(index), float(bcoord))
            else:
                out[dim] = (index, bcoord)
        return out

    def device_arrays(self, device, dtype=np.float32) -> dict:
        """Grid coordinate arrays and search tables on ``device`` (part of
        the field arrays)."""
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        arrs = {
            "lon": dev(self.lon.astype(dtype)),
            "lat": dev(self.lat.astype(dtype)),
            "depth": dev(self.depth.astype(dtype)),
            "time": dev(self.time.astype(np.float32)),
        }
        if self._lookup is not None:
            arrs["lookup_yi"] = dev(self._lookup["yi"])
            arrs["lookup_xi"] = dev(self._lookup["xi"])
        if self.spec.curvilinear:
            # per-cell tangent-frame table: one row-gather per point-in-cell
            # instead of 12 scattered corner reads
            arrs["pic_table"] = dev(self.pic_table())
        if self._needs_cgrid_geom and "X" in self.axes and "Y" in self.axes:
            arrs["cgrid_geom"] = dev(self.cgrid_geometry())
        return arrs

    def cgrid_geometry(self) -> np.ndarray:
        """Per-cell C-grid geometry table, (cells_y * cells_x, 9) float32.

        Columns 0-3: corner lon differences [p1-p0, p2-p3, p3-p0, p2-p1]
        (antimeridian-unwrapped); 4-7: the same lat differences; 8: p0's lat.
        Corner order p0=(y,x), p1=(y,x+1), p2=(y+1,x+1), p3=(y+1,x). These 9
        values reconstruct the reference's per-sample corner math (edge
        geodesics and the bilinear Jacobian) from one row-gather.
        """
        if self._cgrid_geom_cache is None:
            self._cgrid_geom_cache = cgrid_geometry_from_coords(
                self.lon, self.lat, self.spec.spherical
            )
        return self._cgrid_geom_cache

    def pic_table(self) -> np.ndarray:
        """Memoized per-cell search-geometry table (index_search.build_pic_table)."""
        if self._pic_table_cache is None:
            self._pic_table_cache = index_search.build_pic_table(
                self.lon, self.lat, self.spec.spherical
            )
        return self._pic_table_cache

    def lookup_meta(self) -> dict | None:
        if self._lookup is None:
            return None
        return {"origin": self._lookup["origin"], "step": self._lookup["step"]}

    def make_view(self, garrs: dict):
        from parcels_tpu_torch._core.field import GridView

        return GridView(self.spec, garrs, self.lookup_meta())

    def _search_device(self, garrs: dict, z, y, x, ei):
        return grid_search(self.spec, garrs, z, y, x, ei=ei, lookup_meta=self.lookup_meta())

    def ravel_index(self, zi, yi, xi):
        ydim = max(self.spec.ydim, 1)
        xdim = max(self.spec.xdim, 1)
        return (zi * ydim + yi) * xdim + xi

    def unravel_index(self, ei):
        ydim = max(self.spec.ydim, 1)
        xdim = max(self.spec.xdim, 1)
        return ei // (xdim * ydim), (ei // xdim) % ydim, ei % xdim

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def __repr__(self):
        kind = "curvilinear" if self.spec.curvilinear else "rectilinear"
        mesh = "spherical" if self.spec.spherical else "flat"
        return (
            f"XGrid({kind}, {mesh}, cells z={self.spec.zdim} y={self.spec.ydim} "
            f"x={self.spec.xdim}, tdim={self.time.shape[0]})"
        )

    def _repr_sections(self):
        s = self.spec
        return [
            ("geometry", [repr(self)]),
            ("staggering", [f"offset_x={s.offset_x} offset_y={s.offset_y} offset_z={s.offset_z}"]),
        ]

    def describe(self, buf=None) -> None:
        from parcels_tpu_torch._repr import write_sections

        write_sections(type(self).__name__, self._repr_sections(), buf)

    def _repr_html_(self):
        from parcels_tpu_torch._repr import html_sections

        return html_sections(type(self).__name__, self._repr_sections())


def _host_array(v) -> np.ndarray:
    """A numpy copy of ``v`` (a torch tensor on any device, or array-like)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def cgrid_geometry_from_coords(lon, lat, spherical: bool) -> np.ndarray:
    """Per-cell C-grid geometry table from node coordinates (see
    XGrid.cgrid_geometry for the column layout); host f64 math."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    if lon.ndim == 1:
        lon2d, lat2d = np.meshgrid(lon, lat)
    else:
        lon2d, lat2d = lon, lat
    px = [lon2d[:-1, :-1], lon2d[:-1, 1:], lon2d[1:, 1:], lon2d[1:, :-1]]
    py = [lat2d[:-1, :-1], lat2d[:-1, 1:], lat2d[1:, 1:], lat2d[1:, :-1]]
    if spherical:
        # antimeridian unwrap relative to p0 (reference corner unwrap)
        px[0] = ((px[0] + 180.0) % 360.0) - 180.0
        for k in (1, 2, 3):
            pk = ((px[k] + 180.0) % 360.0) - 180.0
            pk = np.where(pk - px[0] > 180.0, pk - 360.0, pk)
            pk = np.where(px[0] - pk > 180.0, pk + 360.0, pk)
            px[k] = pk
    cols = [
        px[1] - px[0], px[2] - px[3], px[3] - px[0], px[2] - px[1],
        py[1] - py[0], py[2] - py[3], py[3] - py[0], py[2] - py[1],
        py[0],
    ]
    return np.stack([c.reshape(-1) for c in cols], axis=1).astype(np.float32)


def _validate_lat_lon(lon: np.ndarray, lat: np.ndarray):
    if lon.ndim != lat.ndim:
        raise ValueError("lon and lat must have the same dimensionality.")
    if lon.ndim == 1:
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


def _build_curvilinear_lookup(lon2d: np.ndarray, lat2d: np.ndarray, shape: tuple | None = None):
    """Build a coarse regular raster mapping (lat, lon) -> seed (yi, xi).

    Host-side numpy, once per grid. Each raster cell stores the grid index
    of the nearest f-point; the device-side directed walk converges from
    there. ``shape`` fixes the raster resolution.
    """
    ydim, xdim = lon2d.shape
    if shape is not None:
        ny, nx = shape
    else:
        ny = min(4 * ydim, 2048)
        nx = min(4 * xdim, 2048)
    lat_min, lat_max = float(np.nanmin(lat2d)), float(np.nanmax(lat2d))
    lon_min, lon_max = float(np.nanmin(lon2d)), float(np.nanmax(lon2d))
    pad_y = max((lat_max - lat_min) * 0.01, 1e-9)
    pad_x = max((lon_max - lon_min) * 0.01, 1e-9)
    lat_min -= pad_y
    lat_max += pad_y
    lon_min -= pad_x
    lon_max += pad_x
    step_y = (lat_max - lat_min) / ny
    step_x = (lon_max - lon_min) / nx

    # rasterize grid nodes; fill empty raster cells by nearest-filled
    # propagation (a few dilation passes)
    tbl_y = np.full((ny, nx), -1, dtype=np.int32)
    tbl_x = np.full((ny, nx), -1, dtype=np.int32)
    gy, gx = np.meshgrid(np.arange(ydim), np.arange(xdim), indexing="ij")
    ry = np.clip(((lat2d - lat_min) / step_y).astype(np.int64), 0, ny - 1)
    rx = np.clip(((lon2d - lon_min) / step_x).astype(np.int64), 0, nx - 1)
    tbl_y[ry.ravel(), rx.ravel()] = np.minimum(gy.ravel(), ydim - 2).astype(np.int32)
    tbl_x[ry.ravel(), rx.ravel()] = np.minimum(gx.ravel(), xdim - 2).astype(np.int32)

    empty = tbl_y < 0
    max_pass = max(ny, nx)
    for _ in range(max_pass):
        if not empty.any():
            break
        filled_y = tbl_y.copy()
        filled_x = tbl_x.copy()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            cand_y = np.roll(tbl_y, (dy, dx), axis=(0, 1))
            cand_x = np.roll(tbl_x, (dy, dx), axis=(0, 1))
            take = empty & (cand_y >= 0) & (filled_y < 0)
            filled_y[take] = cand_y[take]
            filled_x[take] = cand_x[take]
        tbl_y, tbl_x = filled_y, filled_x
        empty = tbl_y < 0

    tbl_y[tbl_y < 0] = 0
    tbl_x[tbl_x < 0] = 0
    return {
        "origin": (lat_min, lon_min),
        "step": (step_y, step_x),
        "yi": tbl_y,
        "xi": tbl_x,
    }


def grid_search(spec: GridSpec, garrs: dict, z, y, x, ei=None, lookup_meta: dict | None = None):
    """Locate particles on the grid. Returns {axis: {"index", "bcoord"}}.

    Z is always a 1-D bracket; X/Y are independent 1-D brackets
    (rectilinear) or the joint curvilinear search warm-started from the
    cached element index ``ei`` (reference XGrid.search).
    """

    def axis(name, coord, pos, uniform, oob_bounds=None):
        if name in spec.axes:
            return index_search.search_1d(garrs[coord], pos, uniform, oob_bounds)
        return torch.zeros(pos.shape, dtype=torch.int32, device=pos.device), torch.zeros_like(pos)

    zi, zeta = axis("Z", "depth", z, spec.depth_uniform)
    if spec.curvilinear and "X" in spec.axes and "Y" in spec.axes:
        if ei is not None:
            ydim = max(spec.ydim, 1)
            xdim = max(spec.xdim, 1)
            xi_g = ei % xdim
            yi_g = (ei // xdim) % ydim
        else:
            yi_g = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
            xi_g = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        lookup = None
        if spec.has_lookup and lookup_meta is not None:
            lookup = {**lookup_meta, "yi": garrs["lookup_yi"], "xi": garrs["lookup_xi"]}
        yi, eta, xi, xsi = index_search.curvilinear_search(
            garrs["lon"], garrs["lat"], y, x, yi_g, xi_g, spherical=spec.spherical,
            lookup=lookup, pic_table=garrs.get("pic_table"),
        )
        return {
            "Z": {"index": zi, "bcoord": zeta},
            "Y": {"index": yi, "bcoord": eta},
            "X": {"index": xi, "bcoord": xsi},
        }
    yi, eta = axis("Y", "lat", y, spec.lat_uniform, spec.y_oob_bounds)
    xi, xsi = axis("X", "lon", x, spec.lon_uniform, spec.x_oob_bounds)
    return {
        "Z": {"index": zi, "bcoord": zeta},
        "Y": {"index": yi, "bcoord": eta},
        "X": {"index": xi, "bcoord": xsi},
    }

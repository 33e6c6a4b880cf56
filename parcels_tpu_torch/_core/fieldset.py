"""FieldSet: host container of Fields + device tensors (torch).

Port of the JAX package's ``_core/fieldset.py``: SGRID-convention ingestion
(rectilinear or curvilinear, A- or C-grid) and UGRID-convention ingestion
(triangular meshes), vector-field autodiscovery with C-grid detection,
constant fields and context constants readable inside kernels. At ingest
every field is transposed on the host to a dense (T, Z, Y, X) block, or
(T, Z, N) on a mesh; ``device_arrays()`` ships data, grid coordinates and
search tables to the fieldset's device once and caches them.

A field opened lazily from a store (``parcels_tpu_torch.io``) keeps its
normalization and NaN fill on its handle. ``set_time_window(L)`` streams
the fields instead: each chunk of ``ParticleSet.execute`` reads only the L
levels it needs, staged in pinned memory by a prefetch thread and copied to
the card on a copy stream while the previous chunk computes
(``_core/windowing.py``).

The fieldset's device is ``cuda`` unless the caller names another; without
CUDA the default raises instead of running on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._core.field import Field, FieldView, VectorField, VectorFieldView
from parcels_tpu_torch._core.grid import GridSpec, XGrid
from parcels_tpu_torch._core.mesh import get_mesh
from parcels_tpu_torch._core.windowing import TimeWindow
from parcels_tpu_torch.interpolators import (
    CGrid_Velocity,
    XConstantField,
    XLinear,
    XLinear_Velocity,
)

__all__ = ["FieldSet", "resolve_device"]

_ORDER = "TZYX"


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``cuda`` by default, and never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on the CPU."
            )
        device = "cuda"
    return torch.device(device)


def _fillna(arr: np.ndarray, fill_value) -> np.ndarray:
    """NaN -> fill, skipping the full-size copy for broadcast views.

    ``zero_data`` benchmark fieldsets and constant fields arrive as
    zero-stride broadcasts of one scalar; materializing them via
    ``np.nan_to_num`` costs gigabytes of host copies for nothing (minutes on
    a small-core host at the true MOi resolution). A lazy handle records
    the fill and applies it to each window it reads."""
    if getattr(arr, "_parcels_lazy", False):
        return arr.with_fill(fill_value)
    if arr.ndim and all(s == 0 for s in arr.strides):
        v = arr.reshape(-1)[:1]
        if not (np.issubdtype(arr.dtype, np.floating) and np.isnan(v[0])):
            return arr
        return np.broadcast_to(np.asarray(fill_value, dtype=arr.dtype), arr.shape)
    return np.nan_to_num(arr, nan=fill_value)


def _device_copy(data: np.ndarray, device) -> torch.Tensor:
    """A dense device tensor of ``data``. A zero-stride broadcast crosses
    to the device as its one element and is expanded there; a lazy handle
    is read whole into one host tensor, which crosses as it is."""
    if getattr(data, "_parcels_lazy", False):
        dtype = np.float32 if data.dtype.kind == "f" else data.dtype
        host = torch.from_numpy(np.empty(data.shape, dtype))
        data.read_window(0, data.shape[0], host.numpy())
        return host.to(device)

    def host(a):
        a = np.ascontiguousarray(a)
        return a.astype(np.float32, copy=False) if a.dtype.kind == "f" else a

    if data.ndim and all(s == 0 for s in data.strides):
        one = torch.as_tensor(host(np.array(data.reshape(-1)[:1])), device=device)
        return one.expand(data.shape).contiguous()
    return torch.as_tensor(host(data), device=device)


def _transpose_to_tzyx(da: xr.DataArray, metadata) -> np.ndarray:
    """Transpose/expand a DataArray of any shape into dense (T, Z, Y, X) numpy."""
    dim_to_axis = metadata.dim_to_axis() | {"time": "T"}
    axes_of_dims = []
    for d in da.dims:
        ax = dim_to_axis.get(str(d))
        if ax is None:
            raise ValueError(
                f"Dimension {d!r} of DataArray {da.name!r} is not associated with a grid axis."
            )
        axes_of_dims.append(ax)
    if len(set(axes_of_dims)) != len(axes_of_dims):
        raise ValueError(f"DataArray {da.name!r} has two dimensions on one axis.")
    present = sorted(range(len(axes_of_dims)), key=lambda i: _ORDER.index(axes_of_dims[i]))
    present_axes = sorted(axes_of_dims, key=_ORDER.index)
    if getattr(da.values, "_parcels_lazy", False):
        # disk-backed field: record the normalization on the lazy handle so
        # only the rolling time window is ever read (io/zarrstore.py)
        src_shape = da.values.shape
        shape = [src_shape[axes_of_dims.index(ax)] if ax in present_axes else 1 for ax in _ORDER]
        t_store = axes_of_dims.index("T") if "T" in axes_of_dims else None
        return da.values.with_tzyx(present, shape, t_store)
    arr = np.asarray(da.values).transpose(present)
    shape, k = [], 0
    for ax in _ORDER:
        if ax in present_axes:
            shape.append(arr.shape[k])
            k += 1
        else:
            shape.append(1)
    return arr.reshape(shape)


def _is_agrid(ds: xr.Dataset, u: str, v: str) -> bool:
    """U and V on the same dims -> A-grid (reference model.py:504-507)."""
    return set(ds[u].dims) == set(ds[v].dims)


def _default_vector_field_components(data_vars) -> dict[str, tuple[str, ...]]:
    names = set(data_vars)
    ret: dict[str, tuple[str, ...]] = {}
    if {"U", "V"}.issubset(names):
        ret["UV"] = ("U", "V")
    if {"U", "V", "W"}.issubset(names):
        ret["UVW"] = ("U", "V", "W")
    return ret


def _mesh_from_units(ds: xr.Dataset, metadata) -> str:
    """Autodetect mesh type from node-coordinate units (degrees -> spherical)."""
    if metadata.node_coordinates is None:
        return "flat"
    cx = metadata.node_coordinates[0]
    units = ds[cx].attrs.get("units") if cx in ds else None
    if units is None:
        raise ValueError(f"Coordinate {cx!r} has no 'units' attribute; pass mesh= explicitly.")
    return "spherical" if "degree" in str(units).lower() else "flat"


class _ConstantGrid(XGrid):
    """Degenerate 0-D grid used for constant fields."""

    def __init__(self, mesh):
        self._mesh = get_mesh(mesh)
        self.axes = []
        self.lon = np.zeros(1)
        self.lat = np.zeros(1)
        self.depth = np.zeros(1)
        self.time = np.zeros(1, dtype=np.float64)
        self.time_interval = None
        self.sgrid_metadata = None
        self._lookup = None
        self._needs_cgrid_geom = False
        self.spec = GridSpec(
            axes=(), curvilinear=False, spherical=self._mesh.is_spherical(), deg2m=self.deg2m,
            xdim=0, ydim=0, zdim=0, lon_uniform=None, lat_uniform=None,
            depth_uniform=None, time_uniform=None,
        )


class FieldSet:
    """Container of Fields/VectorFields + context constants, on one device."""

    def __init__(self, fields: list | None = None, device=None):
        object.__setattr__(self, "_fields", {})
        object.__setattr__(self, "context", {})
        object.__setattr__(self, "_gridset", [])
        object.__setattr__(self, "_device_cache", None)
        object.__setattr__(self, "_device_cache_key", None)
        object.__setattr__(self, "_field_tensors", {})
        object.__setattr__(self, "device", resolve_device(device))
        object.__setattr__(self, "_window", None)  # a TimeWindow under set_time_window
        for f in fields or []:
            self.add_field(f)

    def __getattr__(self, name):
        fields = self.__dict__.get("_fields", {})
        if name in fields:
            return fields[name]
        context = self.__dict__.get("context", {})
        if name in context:
            return context[name]
        raise AttributeError(f"FieldSet has no attribute {name!r}")

    def __setattr__(self, name, value):
        context = self.__dict__.get("context")
        if context is not None and name in context:
            raise AttributeError(
                f"Cannot assign '{name}' directly. Use fieldset.context['{name}'] instead."
            )
        object.__setattr__(self, name, value)

    def __add__(self, other):
        """Combine two FieldSets (reference fieldset.py:110-117): union of
        fields and context constants; name collisions raise ValueError.

        The combined set lives on the sources' device and shares their
        field tensors, so nothing crosses to the device again; sources on
        two devices raise ValueError.
        """
        if not isinstance(other, FieldSet):
            return NotImplemented
        if self.device != other.device:
            raise ValueError(
                f"Cannot add FieldSets on different devices ({self.device} and {other.device})."
            )
        common = set(self._fields) & set(other._fields)
        if common:
            raise ValueError(
                "Cannot add FieldSets that have field names in common. "
                f"Duplicate field names are: {sorted(common)}"
            )
        common_ctx = set(self.context) & set(other.context)
        if common_ctx:
            raise ValueError(
                "Cannot add FieldSets that have context value names in common. "
                f"Duplicate context value names are: {sorted(common_ctx)}"
            )
        # shallow-copy fields (sharing data/grid/interpolator) so add_field's
        # igrid/back-pointer assignment cannot corrupt the source fieldsets
        memo: dict = {}

        def copy_field(f):
            if id(f) in memo:
                return memo[id(f)]
            if isinstance(f, VectorField):
                c = VectorField(f.name, copy_field(f.U), copy_field(f.V),
                                copy_field(f.W) if f.W is not None else None,
                                interp_method=f.interp_method)
            else:
                c = Field(f.name, f.data, f.grid, interp_method=f.interp_method)
            memo[id(f)] = c
            return c

        combined = FieldSet(device=self.device)
        for src in (self, other):
            for name, f in src._fields.items():
                combined.add_field(copy_field(f), name)
                if name in src._field_tensors:
                    combined._field_tensors[name] = src._field_tensors[name]
        combined.context.update({**self.context, **other.context})
        return combined

    @property
    def fields(self) -> dict:
        return self._fields

    @property
    def gridset(self) -> list:
        return self._gridset

    @property
    def time_interval(self):
        intervals = [
            f.time_interval
            for f in self._fields.values()
            if isinstance(f, Field) and f.time_interval is not None
        ]
        if not intervals:
            return None
        overlap = intervals[0]
        for ti in intervals[1:]:
            if overlap is None:
                return None
            overlap = overlap.intersection(ti)
        return overlap

    # -- construction --------------------------------------------------------
    def add_field(self, field, name: str | None = None):
        if not isinstance(field, (Field, VectorField)):
            raise ValueError(f"Expected a Field or VectorField. Got {type(field)}")
        name = field.name if name is None else name
        if name in self._fields:
            raise ValueError(f"FieldSet already has a Field with name '{name}'")
        if isinstance(field, Field):
            if field.grid not in self._gridset:
                self._gridset.append(field.grid)
            field.igrid = self._gridset.index(field.grid)
        if isinstance(field, VectorField) and isinstance(field.interp_method, CGrid_Velocity):
            # the grid's device arrays then carry the per-cell C-grid geometry
            field.grid._needs_cgrid_geom = True
        field._fieldset = self
        field._registered_name = name
        self._fields[name] = field
        object.__setattr__(self, "_device_cache", None)

    def add_constant_field(self, name: str, value, mesh: Literal["flat", "spherical"] = "spherical"):
        """Add a field constant in space/time (reference fieldset.py:198-228)."""
        if mesh not in ("flat", "spherical"):
            raise ValueError(f"mesh must be one of ['flat', 'spherical']. Got {mesh!r}.")
        data = np.full((1, 1, 1, 1), value, dtype=np.float32)
        self.add_field(Field(name, data, _ConstantGrid(mesh), interp_method=XConstantField()))

    def add_context(self, name: str, value):
        """Register a simulation constant readable in kernels as ``fieldset.<name>``."""
        if not name.isidentifier():
            raise ValueError(f"Context name must be a valid identifier. Got {name!r}")
        if name in self.context:
            raise ValueError(f"FieldSet already has a context with name '{name}'")
        self.context[name] = value

    @classmethod
    def from_sgrid_conventions(
        cls,
        ds: xr.Dataset,
        mesh=None,
        vector_fields: dict[str, tuple[str, ...]] | None = None,
        fill_value: float = 0.0,
        device=None,
    ) -> "FieldSet":
        """Build a FieldSet from an SGRID-convention dataset.

        Mirrors reference FieldSet.from_sgrid_conventions: mesh
        autodetection from coordinate units, time-axis normalization,
        vector-field discovery (``CGrid_Velocity`` when U and V sit on
        different dims), NaN -> 0 fill, XLinear default scalar
        interpolation. ``device`` defaults to ``cuda``.
        """
        metadata = sgrid.parse_sgrid_metadata(ds)
        if mesh is None:
            mesh = _mesh_from_units(ds, metadata)
        for dim in list(ds.dims):
            if dim == "time" or dim not in ds.coords:
                continue
            if ds[dim].attrs.get("axis") == "T":
                ds = ds.rename({dim: "time"})
                metadata = sgrid.parse_sgrid_metadata(ds)

        data_vars = [v for v in ds.data_vars if ds[v].attrs.get("cf_role") != "grid_topology"]
        if vector_fields is None:
            vector_fields = _default_vector_field_components(data_vars)
        for vname, components in vector_fields.items():
            if len(components) not in (2, 3):
                raise ValueError(
                    f"Vector field {vname!r} must have either 2 or 3 components; got {len(components)}."
                )
            for c in components:
                if c not in data_vars:
                    raise ValueError(f"Vector field {vname!r} component {c!r} not in dataset.")

        grid = XGrid(ds, mesh)
        fs = cls(device=device)
        scalar_fields: dict[str, Field] = {}
        for varname in data_vars:
            arr = _fillna(_transpose_to_tzyx(ds[varname], metadata), fill_value)
            f = Field(str(varname), arr, grid, interp_method=XLinear())
            scalar_fields[str(varname)] = f
            fs.add_field(f)
        for vname, components in vector_fields.items():
            agrid = _is_agrid(ds, components[0], components[1])
            interp = XLinear_Velocity() if agrid else CGrid_Velocity()
            fs.add_field(VectorField(vname, *[scalar_fields[c] for c in components],
                                     interp_method=interp))
        return fs

    @classmethod
    def from_ugrid_conventions(
        cls,
        ds: xr.Dataset,
        mesh: Literal["flat", "spherical"] | None = None,
        vector_fields: dict[str, tuple[str, ...]] | None = None,
        fill_value: float = 0.0,
        device=None,
    ) -> "FieldSet":
        """Build a FieldSet from a UGRID-convention triangular-mesh dataset.

        Mirrors the JAX package: requires dims {time, zf, zc}, node
        coordinates ``node_lon``/``node_lat`` and ``face_node_connectivity``
        (n_face, 3); renames common U/V/W variable names; picks each
        variable's interpolator from its (vertical, lateral) dim placement;
        NaN -> ``fill_value``. ``device`` defaults to ``cuda``.
        """
        from parcels_tpu_torch._core.uxgrid import UxGrid
        from parcels_tpu_torch.interpolators.uxinterp import (
            Ux_Velocity,
            UxConstantFaceConstantZC,
            UxConstantFaceLinearZF,
            UxLinearNodeConstantZC,
            UxLinearNodeLinearZF,
        )

        ds_dims = set(str(d) for d in ds.dims)
        for need in ("time", "zf", "zc"):
            if need not in ds_dims:
                raise ValueError(
                    f"Dataset missing one of the required dimensions 'time', 'zf', or 'zc' "
                    f"for a UGRID dataset. Found dimensions {sorted(ds_dims)}"
                )
        for need in ("node_lon", "node_lat", "face_node_connectivity"):
            if need not in ds:
                raise ValueError(f"UGRID dataset needs a {need!r} variable.")

        # common U/V/W renames
        for u_name, v_name in (("unod", "vnod"), ("u", "v")):
            if u_name in ds.data_vars and "U" not in ds.data_vars:
                ds = ds.rename({u_name: "U", v_name: "V"})
        if "w" in ds.data_vars and "W" not in ds.data_vars:
            ds = ds.rename({"w": "W"})

        if mesh is None:
            units = str(ds["node_lon"].attrs.get("units", ""))
            if not units:
                raise ValueError("node_lon has no 'units' attribute; pass mesh= explicitly.")
            mesh = "spherical" if "degree" in units.lower() else "flat"

        grid = UxGrid(
            np.asarray(ds["node_lon"].values),
            np.asarray(ds["node_lat"].values),
            np.asarray(ds["face_node_connectivity"].values),
            np.asarray(ds["zf"].values, dtype=np.float64),
            mesh=mesh,
            time=np.asarray(ds["time"].values) if "time" in ds else None,
        )

        interp_by_dims = {
            ("zc", "n_face"): UxConstantFaceConstantZC,
            ("zf", "n_face"): UxConstantFaceLinearZF,
            ("zc", "n_node"): UxLinearNodeConstantZC,
            ("zf", "n_node"): UxLinearNodeLinearZF,
        }

        fs = cls(device=device)
        scalar_fields: dict[str, Field] = {}
        skip = {"node_lon", "node_lat", "face_node_connectivity", "zf", "zc", "time"}
        for varname in ds.data_vars:
            if varname in skip or ds[varname].attrs.get("cf_role") == "grid_topology":
                continue
            da = ds[varname]
            dims = tuple(str(d) for d in da.dims)
            vdim = next((d for d in dims if d in ("zc", "zf")), None)
            ldim = next((d for d in dims if d in ("n_face", "n_node")), None)
            if vdim is None or ldim is None:
                continue
            order = [d for d in ("time", vdim, ldim) if d in dims]
            arr = np.asarray(da.values).transpose([dims.index(d) for d in order])
            if "time" not in dims:
                arr = arr[None]
            arr = _fillna(arr, fill_value)
            f = Field(str(varname), arr, grid, interp_method=interp_by_dims[(vdim, ldim)]())
            scalar_fields[str(varname)] = f
            fs.add_field(f)

        if vector_fields is None:
            vector_fields = _default_vector_field_components(scalar_fields)
        for vname, components in vector_fields.items():
            if len(components) not in (2, 3):
                raise ValueError(
                    f"Vector field {vname!r} must have either 2 or 3 components; got {len(components)}."
                )
            for c in components:
                if c not in scalar_fields:
                    raise ValueError(f"Vector field {vname!r} component {c!r} not in dataset.")
            fs.add_field(VectorField(vname, *[scalar_fields[c] for c in components],
                                     interp_method=Ux_Velocity()))
        return fs

    # -- rolling time-window streaming (reference _windowed_array.py) --------
    def set_time_window(self, nlevels: int):
        """Stream fields to the device in a rolling window of ``nlevels`` time
        levels instead of resident-in-full.

        Each chunk of ``ParticleSet.execute`` gets the window of levels it
        needs; chunks at the same window reuse its device tensors. The next
        window is read on a prefetch thread into pinned memory and copied on
        a copy stream while the current chunk computes.
        """
        if nlevels < 2:
            raise ValueError("Time window must hold at least 2 levels.")
        object.__setattr__(self, "_window", TimeWindow(self.device, int(nlevels)))
        self._apply_time_window()
        return self

    @property
    def _time_window(self) -> int | None:
        """Levels a window holds; None without a time window."""
        return None if self._window is None else self._window.nlevels

    @property
    def window_stats(self) -> dict:
        """Loads (fields) and bytes read into windows since ``set_time_window``."""
        if self._window is None:
            raise AttributeError("window_stats: no time window is set")
        return self._window.stats

    def to_windowed_arrays(self, *, max_levels: int | None = None):
        """Reference-named alias (fieldset.py:165): serve field data through a
        rolling time window instead of resident-in-full; returns self for
        chaining. ``max_levels`` caps the resident levels (default 2, the
        reference's steady-state footprint). No-op when no field has more
        time levels than the window."""
        nlevels = max(2, max_levels or 2)
        if all(g.time.shape[0] <= nlevels for g in self._gridset):
            return self
        return self.set_time_window(nlevels)

    def _apply_time_window(self):
        for grid in self._gridset:
            if grid.time.shape[0] > 1:
                # a window's time values are no uniform axis from the grid's
                # origin: the search brackets them (searchsorted over <= L),
                # as the JAX package does. This changes tau's last bits
                # against the resident run (scripts/window_time_spread.py)
                grid.spec = dataclasses.replace(grid.spec, time_uniform=None)
        self._invalidate_caches()

    def _device_shape(self, field) -> tuple:
        """Shape of ``field``'s data on the device: its window's under a time
        window."""
        shape = tuple(field.data.shape)
        if self._time_window is None or shape[0] <= 1:
            return shape
        return (min(self._time_window, shape[0]),) + shape[1:]

    def max_window_endtime(self, t: float, sign_dt: int) -> float:
        """Furthest chunk end time a window anchored at ``t`` can cover.

        The execute loop clamps each chunk to this, so windowed runs
        sub-chunk automatically instead of requiring outputdt to fit.
        """
        L = self._time_window
        if L is None:
            return np.inf * sign_dt
        best = np.inf * sign_dt
        for grid in self._gridset:
            nt = grid.time.shape[0]
            if nt <= 1:
                continue
            if sign_dt >= 0:
                i0 = int(np.clip(np.searchsorted(grid.time, t, side="right") - 1, 0,
                                 max(nt - L, 0)))
                end = grid.time[min(i0 + L - 1, nt - 1)]
                if i0 + L >= nt:
                    end = np.inf
                best = min(best, end)
            else:
                i1 = int(np.clip(np.searchsorted(grid.time, t, side="left"), L - 1, nt - 1))
                start = grid.time[max(i1 - (L - 1), 0)]
                if i1 - (L - 1) <= 0:
                    start = -np.inf
                best = max(best, start)
        return best

    def _window_offsets(self, t_lo: float, t_hi: float, check: bool = True) -> tuple:
        """Per-grid first-level offsets of the window covering [t_lo, t_hi]."""
        L = self._time_window
        t_lo, t_hi = (t_lo, t_hi) if t_lo <= t_hi else (t_hi, t_lo)
        offsets = []
        for grid in self._gridset:
            nt = grid.time.shape[0]
            if nt <= 1:
                offsets.append(0)
                continue
            i0 = int(np.clip(np.searchsorted(grid.time, t_lo, side="right") - 1, 0, max(nt - L, 0)))
            if check and grid.time[min(i0 + L - 1, nt - 1)] < t_hi and i0 + L < nt:
                raise ValueError(
                    f"Time window of {L} levels cannot cover [{t_lo}, {t_hi}] s "
                    f"(levels span {grid.time[i0]}..{grid.time[min(i0 + L - 1, nt - 1)]}). "
                    "Increase the window or reduce outputdt."
                )
            offsets.append(i0)
        return tuple(offsets)

    def _build_window(self, offsets: tuple):
        """Read the window's levels into staging memory and ship them to the
        device (``windowing.Stager``); runs on the prefetch thread, or on the
        caller's for a window that was not prefetched.

        No derived table is built here: ``windowed_arrays`` attaches them on
        the main thread (the JAX package measured eager table builds on a
        second thread at 2.5x slower).
        """
        L = self._time_window
        parts = []
        for i, (i0, grid) in enumerate(zip(offsets, self._gridset)):
            if grid.time.shape[0] > 1:
                t = grid.time[i0:i0 + L].astype(np.float32)
                parts.append((("grid", i), t.shape, t.dtype, _copier(t)))
        loads = nbytes = 0
        for name, f in self._fields.items():
            if isinstance(f, Field) and f.data.shape[0] > 1:
                i0 = offsets[f.igrid]
                n = min(L, f.data.shape[0] - i0)
                shape = (n,) + tuple(f.data.shape[1:])
                parts.append((("field", name), shape, f.data.dtype, _level_reader(f.data, i0, n)))
                loads += 1
                nbytes += int(np.prod(shape)) * f.data.dtype.itemsize
        return self._window.stage(parts, loads, nbytes)

    def prefetch_window(self, t_anchor: float) -> None:
        """Stage the window anchored at ``t_anchor`` on the prefetch thread.

        Called by the execute loop right after queueing a chunk, so the next
        window's reads and its copy to the device overlap the chunk's
        compute. A mispredicted anchor is harmless: ``windowed_arrays``
        then loads its window synchronously.
        """
        if self._window is None:
            return
        key = self._window_offsets(t_anchor, t_anchor, check=False)
        self._window.prefetch(key, self._build_window)

    def windowed_arrays(self, t_lo: float, t_hi: float) -> dict:
        """Device tensors whose time axes cover [t_lo, t_hi] (window mode).

        Keeps the current window plus at most one prefetched successor; a
        window's first use makes the current stream wait for its copy.
        """
        if self._window is None:
            return self.device_arrays()
        key = self._window_offsets(t_lo, t_hi)
        return self._window.take(key, self._build_window, self._window_farrays)

    def _window_static(self) -> dict:
        """What every window shares: the time-invariant field tensors, the
        grid tensors and the cell tables (built once a ``uxcol`` mode)."""
        from parcels_tpu_torch.ops import uxcol
        from parcels_tpu_torch.ops.stagecache import attach_derived_tables

        mode = uxcol._mode()
        if self._window.static is None or self._window.static[0] != mode:
            static = {
                "fields": {name: self._field_tensor(name) for name, f in self._fields.items()
                           if isinstance(f, Field) and f.data.shape[0] <= 1},
                "grids": [grid.device_arrays(self.device) for grid in self._gridset],
            }
            attach_derived_tables(self, static)  # grid-only tables
            self._window.static = (mode, static)
        return self._window.static[1]

    def _grid_arrays(self) -> list:
        """Every grid's device tensors: the resident ones, or the windows'."""
        if self._window is None:
            return self.device_arrays()["grids"]
        return self._window_static()["grids"]

    def _window_farrays(self, window) -> dict:
        """The farrays of a staged window: its tensors over the resident
        (time-invariant) field and grid tensors and the cell tables."""
        static = self._window_static()
        farrays = {"fields": dict(static["fields"]), "grids": [dict(g) for g in static["grids"]]}
        if "celltables" in static:
            farrays["celltables"] = static["celltables"]
        for (kind, key), tensor in window.publish().items():
            if kind == "grid":
                farrays["grids"][key]["time"] = tensor
            else:
                farrays["fields"][key] = tensor
        return farrays

    # -- device tensors ------------------------------------------------------
    def _invalidate_caches(self):
        """Drop the cached device tensors, so that a field's swapped
        ``interp_method`` (and the tables it needs) is seen."""
        object.__setattr__(self, "_device_cache", None)
        object.__setattr__(self, "_field_tensors", {})
        if self._window is not None:
            self._window.current = self._window.static = None

    def _field_tensor(self, name: str) -> torch.Tensor:
        """The whole of field ``name`` on the device; crosses once."""
        fields = self._field_tensors
        if name not in fields:
            data = self._fields[name].data
            if getattr(data, "_parcels_lazy", False) and data.nbytes > 4 << 30:
                raise ValueError(
                    f"Field {name!r} is disk-backed and {data.nbytes / 2**30:.1f} GiB; "
                    "call fieldset.set_time_window(nlevels) to stream it instead of "
                    "materializing it whole."
                )
            fields[name] = _device_copy(data, self.device)
        return fields[name]

    def device_arrays(self) -> dict:
        """All field data + grid coordinates on the fieldset's device; cached.

        Keyed on the ``uxcol`` mode as the grid tensors are; the field
        tensors cross to the device once whatever the mode. A disk-backed
        field over 4 GiB is refused: stream it with ``set_time_window``.
        """
        from parcels_tpu_torch.ops import uxcol
        from parcels_tpu_torch.ops.stagecache import attach_derived_tables

        key = uxcol._mode()
        if self._device_cache is not None and self._device_cache_key == key:
            return self._device_cache
        farrays = {
            "fields": {name: self._field_tensor(name) for name, f in self._fields.items()
                       if isinstance(f, Field)},
            "grids": [grid.device_arrays(self.device) for grid in self._gridset],
        }
        attach_derived_tables(self, farrays)
        object.__setattr__(self, "_device_cache", farrays)
        object.__setattr__(self, "_device_cache_key", key)
        return farrays

    def build_views(self, farrays: dict) -> "FieldSetView":
        """Device field views over ``farrays`` (as ``device_arrays`` returns)."""
        from parcels_tpu_torch.ops import uxcache
        from parcels_tpu_torch.ops.stagecache import soa_cache_owner

        grid_views = [g.make_view(farrays["grids"][i]) for i, g in enumerate(self._gridset)]
        celltables = farrays.get("celltables", {})
        tables = farrays.setdefault("tables", {})
        sc_owner, _ = soa_cache_owner(self)
        uxc_owner, _ = uxcache.soa_cache_owner(self)
        views: dict[str, object] = {}
        for name, f in self._fields.items():
            if isinstance(f, Field):
                views[name] = FieldView(
                    name, farrays["fields"][name], grid_views[f.igrid], f.igrid,
                    f.interp_method, f.data.shape[0] > 1, tables.setdefault(name, {}),
                )
        for name, f in self._fields.items():
            if isinstance(f, VectorField):
                views[name] = VectorFieldView(
                    name, views[f.U.name], views[f.V.name],
                    views[f.W.name] if f.W is not None else None, f.interp_method,
                    sc_owner=name in (sc_owner, uxc_owner), tables=tables.setdefault(name, {}),
                )
                if f.igrid in celltables:
                    views[name]._cell_table = celltables[f.igrid]
        return FieldSetView(views, dict(self.context))

    def eval(self, name: str, t, z, y, x):
        """Host-side sampling of a field by name; returns numpy values.

        ``t`` is float seconds since the fieldset time origin (or
        datetime64/timedelta64).
        """
        from parcels_tpu_torch._core.timeutils import timedelta_to_float

        t = np.atleast_1d(np.asarray(t))
        if np.issubdtype(t.dtype, np.datetime64):
            if self.time_interval is None:
                raise ValueError("datetime sampling requires a fieldset time interval")
            t = timedelta_to_float(t - np.datetime64(self.time_interval.left, "ns"))
        elif np.issubdtype(t.dtype, np.timedelta64):
            t = timedelta_to_float(t)
        arrs = np.broadcast_arrays(
            *(np.atleast_1d(np.asarray(v, dtype=np.float32)) for v in (t, z, y, x))
        )
        t, z, y, x = (torch.as_tensor(np.ascontiguousarray(a), device=self.device) for a in arrs)
        out = getattr(self.build_views(self.device_arrays()), name).eval(t, z, y, x)
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    def memory_report(self, particles: int = 0, device_bytes: int | None = None,
                      bands: int = 1) -> dict:
        """Analytic device-memory budget of this fieldset (no allocation).

        Counts what the port puts on the device: the field tensors (the
        time window's levels when streaming, else the whole time axis), the
        grid tensors (coordinates; the curvilinear search table, 16 f32 a
        cell, and the C-grid geometry, 9 f32 a cell; the lookup raster; a
        UGRID mesh's node, face and raster tables and its fused face rows),
        the stage cache's fused cell rows and the UGRID column tables
        (``ops/stagecache.table_bytes``), and the particle SoA of
        ``particles`` particles after ``ParticleSet``'s capacity padding,
        with the persistent cache columns where they apply. ``bands``
        divides the Y extent of the fields and the per-cell tables, as a
        band of a Y-band decomposition would hold them. ``device_bytes``
        defaults to the card's total memory, and is None on the CPU (then
        ``fits`` is None).
        """
        from parcels_tpu_torch._core.particleset import soa_bytes
        from parcels_tpu_torch._core.uxgrid import UxGrid
        from parcels_tpu_torch.ops import stagecache, uxcol

        fields = {}
        for name, f in self._fields.items():
            if not isinstance(f, Field):
                continue
            shape = self._device_shape(f)
            if len(shape) == 4:
                T, Z, Y, X = shape
                fields[name] = T * Z * -(-Y // bands) * X * 4
            else:
                fields[name] = int(np.prod(shape)) * 4
        tables = stagecache.table_bytes(self)
        grids = []
        for i, g in enumerate(self._gridset):
            if isinstance(g, UxGrid):
                sp = g.spec
                entry = {
                    "coords": (2 * sp.n_node + sp.nz + g.time.size) * 4,
                    "mesh": (sp.n_node * (3 if sp.spherical else 2) * 4
                             + g.face_node_connectivity.nbytes + g._adjacency.nbytes),
                    "lookup": int(g._lookup["fi"].nbytes),
                    "face_table": sp.n_face * uxcol.ROW_WIDTH * 4
                    if uxcol.enabled(sp.n_face, self.device) else 0,
                }
            else:
                coords = sum(int(np.asarray(a).size) * 4 for a in (g.lon, g.lat, g.depth, g.time))
                entry = {"coords": coords, "pic_table": 0, "cgrid_geom": 0, "lookup": 0,
                         "cell_table": tables["cell_table"].get(i, 0) // max(bands, 1)}
                if g.spec.curvilinear:
                    cells = max(g.spec.ydim, 1) * max(g.spec.xdim, 1) // max(bands, 1)
                    entry["pic_table"] = cells * 16 * 4
                    if g._needs_cgrid_geom and "X" in g.axes and "Y" in g.axes:
                        entry["cgrid_geom"] = cells * 9 * 4
                if g._lookup is not None:
                    entry["lookup"] = int(g._lookup["yi"].nbytes + g._lookup["xi"].nbytes)
            grids.append(entry)
        soa = soa_bytes(self, particles)
        total = (sum(fields.values()) + sum(sum(e.values()) for e in grids)
                 + sum(tables["ux_tables"].values()) + soa)
        if device_bytes is None and self.device.type == "cuda":
            device_bytes = torch.cuda.get_device_properties(self.device).total_memory
        return {
            "fields": fields,
            "grids": grids,
            "tables": tables["ux_tables"],
            "soa": soa,
            "total": total,
            "device_bytes": device_bytes,
            "fits": None if device_bytes is None else total <= device_bytes,
        }

    def _repr_sections(self) -> list:
        """Sectioned repr (reference fieldset_repr, _repr_utils.py:25-44)."""
        def line(name, f):
            interp = type(f.interp_method).__name__ if f.interp_method else "-"
            return f"{name}: {f!r} interp={interp}"

        fields = [line(n, f) for n, f in self._fields.items() if not isinstance(f, VectorField)]
        vfields = [line(n, f) for n, f in self._fields.items() if isinstance(f, VectorField)]
        misc = [f"device: {self.device}"]
        if self.context:
            misc.append(f"context: {self.context}")
        if self.time_interval is not None:
            misc.append(f"time_interval: {self.time_interval!r}")
        if self._time_window is not None:
            misc.append(f"time_window: {self._time_window} levels (streaming)")
        mem = self.memory_report()
        if mem["device_bytes"] is None:
            misc.append(f"device memory: {mem['total'] / 2**30:.2f} GiB on {self.device} "
                        "(fields + search tables; no device limit)")
        else:
            card = torch.cuda.get_device_name(self.device)
            mline = (f"device memory: {mem['total'] / 2**30:.2f} GiB of "
                     f"{mem['device_bytes'] / 2**30:.0f} GiB on {card} (fields + search tables)")
            if not mem["fits"]:
                mline += "  ** OVER BUDGET: use set_time_window **"
            misc.append(mline)
        grids = [f"grid[{i}]: {g!r}" for i, g in enumerate(self._gridset)]
        return [("fields", fields), ("vectorfields", vfields), ("grids", grids),
                ("simulation", misc)]

    def describe(self, buf=None) -> None:
        import sys

        (buf or sys.stdout).write(repr(self) + "\n")

    def __repr__(self) -> str:
        from parcels_tpu_torch._repr import format_sections

        return format_sections(type(self).__name__, self._repr_sections())

    def _repr_html_(self) -> str:
        from parcels_tpu_torch._repr import html_sections

        return html_sections(type(self).__name__, self._repr_sections())


def _copier(values: np.ndarray):
    return lambda out: np.copyto(out, values, casting="unsafe")


def _level_reader(data, i0: int, n: int):
    """Writes time levels [i0, i0 + n) of ``data`` into a staging array."""
    if getattr(data, "_parcels_lazy", False):
        return lambda out: data.read_window(i0, i0 + n, out)
    return _copier(data[i0:i0 + n])


class FieldSetView:
    """The ``fieldset`` object seen by kernels inside the engine."""

    __slots__ = ("_views", "_context")

    def __init__(self, views: dict, context: dict):
        object.__setattr__(self, "_views", views)
        object.__setattr__(self, "_context", context)

    def __getattr__(self, name):
        if name in self._views:
            return self._views[name]
        if name in self._context:
            return self._context[name]
        raise AttributeError(f"FieldSet has no attribute {name!r}")

    @property
    def fields(self):
        return self._views

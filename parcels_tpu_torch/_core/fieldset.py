"""FieldSet: host container of Fields + device tensors (torch).

Port of the JAX package's ``_core/fieldset.py`` for structured datasets:
SGRID-convention ingestion (rectilinear or curvilinear, A- or C-grid),
vector-field autodiscovery with C-grid detection, constant fields and
context constants readable inside kernels. At ingest every field is
transposed on the host to a dense (T, Z, Y, X) block; ``device_arrays()``
ships data, grid coordinates and search tables to the fieldset's device
once and caches them.

The fieldset's device is ``cuda`` unless the caller names another; without
CUDA the default raises instead of running on the CPU. Parts of the JAX
package that belong to later slices of the port (UGRID, time windows)
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._core.field import Field, FieldView, VectorField, VectorFieldView
from parcels_tpu_torch._core.grid import GridSpec, XGrid
from parcels_tpu_torch._core.mesh import get_mesh
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
        object.__setattr__(self, "device", resolve_device(device))
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
            arr = np.nan_to_num(_transpose_to_tzyx(ds[varname], metadata), nan=fill_value)
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
    def from_ugrid_conventions(cls, *args, **kwargs):
        raise NotImplementedError("UGRID fieldsets belong to the unstructured-mesh slice of the port.")

    def set_time_window(self, nlevels: int):
        raise NotImplementedError(
            "Time windows belong to the time-windowing slice of the port; "
            "this slice keeps every field resident on the device."
        )

    # -- device tensors ------------------------------------------------------
    def device_arrays(self) -> dict:
        """All field data + grid coordinates on the fieldset's device; cached."""
        if self._device_cache is not None:
            return self._device_cache
        farrays = {
            "fields": {},
            "grids": [grid.device_arrays(self.device) for grid in self._gridset],
        }
        for name, f in self._fields.items():
            if isinstance(f, Field):
                data = f.data.astype(np.float32, copy=False) if f.data.dtype.kind == "f" else f.data
                farrays["fields"][name] = torch.as_tensor(
                    np.ascontiguousarray(data), device=self.device
                )
        from parcels_tpu_torch.ops.stagecache import attach_derived_tables

        attach_derived_tables(self, farrays)
        object.__setattr__(self, "_device_cache", farrays)
        return farrays

    def build_views(self, farrays: dict) -> "FieldSetView":
        """Device field views over ``farrays`` (as ``device_arrays`` returns)."""
        from parcels_tpu_torch.ops.stagecache import soa_cache_owner

        grid_views = [g.make_view(farrays["grids"][i]) for i, g in enumerate(self._gridset)]
        celltables = farrays.get("celltables", {})
        sc_owner, _ = soa_cache_owner(self)
        views: dict[str, object] = {}
        for name, f in self._fields.items():
            if isinstance(f, Field):
                views[name] = FieldView(
                    name, farrays["fields"][name], grid_views[f.igrid], f.igrid,
                    f.interp_method, f.data.shape[0] > 1,
                )
        for name, f in self._fields.items():
            if isinstance(f, VectorField):
                views[name] = VectorFieldView(
                    name, views[f.U.name], views[f.V.name],
                    views[f.W.name] if f.W is not None else None, f.interp_method,
                    sc_owner=name == sc_owner,
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

    def __repr__(self) -> str:
        return f"FieldSet(fields={list(self._fields)}, device={self.device})"


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

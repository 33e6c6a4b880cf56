"""Model-output -> SGRID convention normalizers (NEMO).

Copy of the NEMO part of the JAX package's ``convert.py``: ``nemo_to_sgrid``
and the helpers it calls, unchanged apart from the imports. It takes raw
NEMO/MOi output (xrlite or real xarray datasets, duck-typed) and returns an
SGRID-annotated dataset for ``FieldSet.from_sgrid_conventions``. The
converters for other models belong to a later slice of the port.
"""

from __future__ import annotations

import numpy as np

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._logging import logger

__all__ = ["nemo_to_sgrid"]

_NEMO_VARNAMES_MAPPING = {
    "time_counter": "time",
    "depthw": "depth",
    "uo": "U",
    "vo": "V",
    "wo": "W",
    # MOi/legacy NEMO component names (see the MOi benchmark registry entry,
    # reference _datasets/remote.py:252-257)
    "vozocrtx": "U",
    "vomecrty": "V",
    "vovecrtz": "W",
}

_NEMO_AXIS_VARNAMES = {
    "x": "X", "x_center": "X", "y": "Y", "y_center": "Y",
    "depth": "Z", "depth_center": "Z", "time": "T",
}



def _as_xrlite(ds) -> xr.Dataset:
    """Accept xrlite or real-xarray datasets; normalize to xrlite."""
    if isinstance(ds, xr.Dataset):
        return ds.copy()
    out = xr.Dataset()
    for name in getattr(ds, "data_vars", {}):
        da = ds[name]
        out[name] = xr.DataArray(np.asarray(da.values), dims=tuple(str(d) for d in da.dims),
                                 attrs=dict(da.attrs), name=name)
    for name in getattr(ds, "coords", {}):
        da = ds[name]
        out[name] = xr.DataArray(np.asarray(da.values), dims=tuple(str(d) for d in da.dims),
                                 attrs=dict(da.attrs), name=name)
        out.set_coords(name)
    out.attrs.update(dict(getattr(ds, "attrs", {})))
    return out



def _merge_fields_and_coords(fields: dict, coords) -> xr.Dataset:
    """Merge per-variable datasets/arrays + a coords dataset into one Dataset."""
    ds = xr.Dataset()
    for name, fda in fields.items():
        if hasattr(fda, "data_vars"):  # dataset holding the variable
            fda = fda[name]
        ds[name] = xr.DataArray(np.asarray(fda.values), dims=tuple(str(d) for d in fda.dims),
                                attrs=dict(fda.attrs), name=name)
    if coords is not None:
        names = list(getattr(coords, "data_vars", {})) + list(getattr(coords, "coords", {}))
        if not names and isinstance(coords, xr.Dataset):
            names = list(coords.variables)
        for cname in dict.fromkeys(names):
            da = coords[cname]
            ds[cname] = xr.DataArray(np.asarray(da.values), dims=tuple(str(d) for d in da.dims),
                                     attrs=dict(da.attrs), name=cname)
            ds.set_coords(cname)
    return ds



def _maybe_rename(ds: xr.Dataset, mapping: dict) -> xr.Dataset:
    found = {k: v for k, v in mapping.items() if k in ds or k in ds.dims}
    if found:
        logger.info("convert: renaming %s", found)
        ds = ds.rename(found)
    return ds



def _set_axis_attrs(ds: xr.Dataset, dim_axis: dict) -> xr.Dataset:
    for dim, axis in dim_axis.items():
        if dim in ds:
            ds[dim].attrs["axis"] = axis
    return ds



def _negate_w(ds: xr.Dataset) -> xr.Dataset:
    if "W" in ds.data_vars:
        # up-positive -> down-positive (positive z direction), reference :385
        da = ds["W"]
        ds["W"] = xr.DataArray(-np.asarray(da.values), dims=da.dims, attrs=da.attrs, name="W")
    return ds



def _attach_grid(ds: xr.Dataset, meta: sgrid.SGrid2DMetadata) -> xr.Dataset:
    if any(str(ds[v].attrs.get("cf_role")) == "grid_topology" for v in ds.data_vars):
        raise ValueError("Dataset already has grid_topology metadata.")
    return sgrid.attach_sgrid_metadata(ds, meta)



def nemo_to_sgrid(*, fields: dict, coords) -> xr.Dataset:
    """NEMO output -> SGRID dataset (reference convert.py:308-410).

    ``fields`` maps Parcels names (U, V, W, ...) to DataArrays/Datasets from
    NEMO files; ``coords`` must contain the f-point coordinates glamf/gphif
    (and optionally depthw).
    """
    coords = _as_xrlite(coords) if not isinstance(coords, xr.Dataset) else coords
    picked = xr.Dataset()
    # time_counter/time is carried by the field files in NEMO output; with
    # plain-array datasets it must come through coords instead.
    for name in ("glamf", "gphif", "depthw", "time_counter", "time"):
        if name in coords:
            da = coords[name]
            picked[name] = xr.DataArray(np.asarray(da.values), dims=da.dims, attrs=dict(da.attrs))
            picked.set_coords(name)
        elif name in ("glamf", "gphif"):
            raise ValueError(f"Expected coordinate {name!r} not found in provided coords dataset.")

    fields = dict(fields)
    # accept native NEMO/MOi component names as dict keys (vozocrtx -> U, ...)
    for native, parcels_name in _NEMO_VARNAMES_MAPPING.items():
        if native in fields and parcels_name not in fields:
            fields[parcels_name] = fields.pop(native)
    renamed = {}
    for name, fda in fields.items():
        if hasattr(fda, "data_vars"):
            # resolve the variable inside a multi-variable dataset: the
            # Parcels name, else its native NEMO name (vozocrtx for U, ...),
            # else an unambiguous single data var. Never "the first data
            # var" — MOi files ship diagnostics alongside the velocity.
            dvars = list(getattr(fda, "data_vars", {}))
            natives = [nm for nm, pn in _NEMO_VARNAMES_MAPPING.items() if pn == name]
            if name in dvars:
                fda = fda[name]
            elif any(nm in dvars for nm in natives):
                fda = fda[next(nm for nm in natives if nm in dvars)]
            elif len(dvars) == 1:
                fda = fda[dvars[0]]
            else:
                raise ValueError(
                    f"Cannot resolve field {name!r} in a dataset with variables "
                    f"{dvars}; rename the variable or pass the DataArray directly."
                )
        dims = tuple(str(d) for d in fda.dims)
        # U sits on the y-center row, V on the x-center column (C-grid)
        if name == "U":
            dims = tuple("y_center" if d == "y" else d for d in dims)
        elif name == "V":
            dims = tuple("x_center" if d == "x" else d for d in dims)
        renamed[name] = xr.DataArray(np.asarray(fda.values), dims=dims, attrs=dict(fda.attrs), name=name)

    ds = _merge_fields_and_coords(renamed, picked)

    # squeeze any time/singleton dims off the coordinate arrays
    for cname in ("glamf", "gphif"):
        da = ds[cname]
        vals = np.asarray(da.values)
        dims = list(da.dims)
        for i in reversed(range(vals.ndim)):
            if vals.shape[i] == 1 and vals.ndim > 2:
                vals = np.squeeze(vals, axis=i)
                dims.pop(i)
        ds[cname] = xr.DataArray(vals, dims=dims, attrs=da.attrs)
        ds.set_coords(cname)

    ds = _maybe_rename(ds, _NEMO_VARNAMES_MAPPING)
    # NEMO per-variable depth dims -> shared depth/depth_center
    for name in list(ds.data_vars):
        da = ds[name]
        dims = tuple(
            "depth_center" if d in ("depthu", "depthv", "deptht") else ("depth" if d == "depthw" else d)
            for d in da.dims
        )
        if dims != da.dims:
            ds[name] = xr.DataArray(np.asarray(da.values), dims=dims, attrs=da.attrs, name=name)
    ds = _set_axis_attrs(ds, _NEMO_AXIS_VARNAMES)
    ds = _negate_w(ds)

    ds = _attach_grid(
        ds,
        sgrid.SGrid2DMetadata(
            node_dimensions=("x", "y"),
            node_coordinates=("glamf", "gphif"),
            face_dimensions=(
                sgrid.FaceNodePadding("x_center", "x", sgrid.Padding.LOW),
                sgrid.FaceNodePadding("y_center", "y", sgrid.Padding.LOW),
            ),
            vertical_dimensions=(sgrid.FaceNodePadding("depth_center", "depth", sgrid.Padding.HIGH),),
        ),
    )
    ds["glamf"].attrs["units"] = "degrees"
    ds["gphif"].attrs["units"] = "degrees"
    ds = ds.rename({"gphif": "lat", "glamf": "lon"})
    meta = sgrid.parse_sgrid_metadata(ds)
    ds = sgrid.attach_sgrid_metadata(
        ds,
        sgrid.SGrid2DMetadata(
            node_dimensions=meta.node_dimensions,
            node_coordinates=("lon", "lat"),
            face_dimensions=meta.face_dimensions,
            vertical_dimensions=meta.vertical_dimensions,
        ),
    )
    return ds

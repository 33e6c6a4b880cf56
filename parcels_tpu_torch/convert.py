"""Model-output -> SGRID / UGRID convention normalizers (NEMO, CROCO, FESOM2, ICON).

Copy of the NEMO, CROCO, FESOM2 and ICON parts of the JAX package's
``convert.py``: ``nemo_to_sgrid``, ``croco_to_sgrid``, ``fesom_to_ugrid``,
``icon_to_ugrid`` and the helpers they call, unchanged apart from the
imports. They take raw model output (xrlite or real xarray datasets,
duck-typed) and return a dataset for ``FieldSet.from_sgrid_conventions`` or
``FieldSet.from_ugrid_conventions``. The converters for other models belong
to a later slice of the port.
"""

from __future__ import annotations

import numpy as np

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._logging import logger

__all__ = ["croco_to_sgrid", "fesom_to_ugrid", "icon_to_ugrid", "nemo_to_sgrid"]

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

_CROCO_VARNAMES_MAPPING = {"x_rho": "lon", "y_rho": "lat", "s_w": "depth"}



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



def _maybe_float_time_to_timedelta(ds: xr.Dataset) -> xr.Dataset:
    """Float time axis -> timedelta64[ns] using its units attr (reference :233-260)."""
    if "time" not in ds:
        return ds
    tvals = np.asarray(ds["time"].values)
    if not np.issubdtype(tvals.dtype, np.floating):
        return ds
    units = str(ds["time"].attrs.get("units", "")).lower()
    factor = 1e9
    if "hour" in units:
        factor = 3600.0 * 1e9
    elif "day" in units:
        factor = 86400.0 * 1e9
    elif "minute" in units:
        factor = 60.0 * 1e9
    ns = np.rint(tvals * factor).astype("int64").astype("timedelta64[ns]")
    ds["time"] = xr.DataArray(ns, dims=ds["time"].dims, attrs=ds["time"].attrs)
    ds.set_coords("time")
    logger.info("convert: converted float time axis to timedelta64 (units=%r)", units)
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


def croco_to_sgrid(*, fields: dict, coords) -> xr.Dataset:
    """CROCO output -> SGRID dataset (reference convert.py:469-524).

    Keeps sigma levels as the (dimensionless) depth axis; use the
    kernels.sigmagrids helpers for z<->sigma conversion at runtime.
    """
    ds = _merge_fields_and_coords(dict(fields), coords)
    for name in ("x_rho", "y_rho", "s_w", "time"):
        if name not in ds:
            raise ValueError(f"Expected coordinate {name!r} not found in provided coords dataset.")
    ds = _maybe_rename(ds, _CROCO_VARNAMES_MAPPING)
    ds = _maybe_float_time_to_timedelta(ds)
    ds = _set_axis_attrs(ds, {"lon": "X", "lat": "Y", "depth": "Z", "time": "T"})
    return _attach_grid(
        ds,
        sgrid.SGrid2DMetadata(
            node_dimensions=("lon", "lat"),
            node_coordinates=("lon", "lat"),
            face_dimensions=(
                sgrid.FaceNodePadding("xi_u", "xi_rho", sgrid.Padding.HIGH),
                sgrid.FaceNodePadding("eta_v", "eta_rho", sgrid.Padding.HIGH),
            ),
            vertical_dimensions=(sgrid.FaceNodePadding("s_rho", "depth", sgrid.Padding.HIGH),),
        ),
    )


# vertical dim names per unstructured model
_FESOM2_VERTICAL_DIMS = {"interface": "nz", "center": "nz1"}
_ICON_VERTICAL_DIMS = {"interface": "depth_2", "center": "depth"}


# ---------------------------------------------------------------------------
# Unstructured models (UGRID)
# ---------------------------------------------------------------------------


def _detect_vertical_dims(ds, known: dict | None) -> tuple[str, str]:
    """(interface_dim, center_dim) detection (reference convert.py:656-744)."""
    dims = set(str(d) for d in ds.dims)
    if known:
        i, c = known.get("interface"), known.get("center")
        if i in dims and c in dims:
            return i, c
    z_dims = []
    for d in dims:
        if d in ds:
            a = ds[d].attrs
            if a.get("axis") == "Z" or a.get("positive") in ("up", "down") or "depth" in str(
                a.get("standard_name", "")
            ).lower():
                z_dims.append(d)
    if len(z_dims) == 2:
        z_dims.sort(key=lambda d: ds.sizes[d], reverse=True)
        if ds.sizes[z_dims[0]] == ds.sizes[z_dims[1]] + 1:
            return z_dims[0], z_dims[1]
    skip = {"time", "n_face", "n_node", "n_edge", "n_max_face_nodes"}
    cands = [d for d in dims if d not in skip]
    for d1 in cands:
        for d2 in cands:
            if d1 != d2 and ds.sizes[d1] == ds.sizes[d2] + 1:
                return d1, d2
    raise ValueError(
        f"Could not detect vertical coordinate dimensions in dataset with dims {sorted(dims)}. "
        "Rename them manually to 'zf' (interfaces) and 'zc' (centers)."
    )


def _rename_vertical_dims(ds, interface_dim: str, center_dim: str):
    rename = {}
    if interface_dim != "zf":
        rename[interface_dim] = "zf"
    if center_dim != "zc":
        rename[center_dim] = "zc"
    if rename:
        ds = ds.rename(rename)
    return ds


def fesom_to_ugrid(ds):
    """FESOM2 dataset -> Parcels UGRID naming (reference convert.py:775-811)."""
    ds = _as_xrlite(ds)
    for try_dim, target in (("nod2", "n_face"), ("elem", "n_node")):
        if try_dim in ds.dims:
            ds = ds.rename({try_dim: target})
    i, c = _detect_vertical_dims(ds, _FESOM2_VERTICAL_DIMS)
    return _rename_vertical_dims(ds, i, c)


def icon_to_ugrid(ds):
    """ICON dataset -> Parcels UGRID naming (reference convert.py:813-847)."""
    ds = _as_xrlite(ds)
    i, c = _detect_vertical_dims(ds, _ICON_VERTICAL_DIMS)
    return _rename_vertical_dims(ds, i, c)

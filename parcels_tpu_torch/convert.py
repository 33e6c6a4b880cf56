"""Model-output -> SGRID/UGRID convention normalizers.

Copy of the JAX package's ``convert.py``, unchanged apart from the imports:
per-model functions that take raw model output (xrlite or real xarray
datasets, duck-typed) and return an SGRID/UGRID-annotated dataset for
``FieldSet.from_sgrid_conventions`` / ``from_ugrid_conventions``.

Supported models (the reference's set):
- NEMO (``nemo_to_sgrid``, reference convert.py:308)
- MITgcm (``mitgcm_to_sgrid``, reference convert.py:411)
- CROCO (``croco_to_sgrid``, reference convert.py:469)
- Copernicus Marine (``copernicusmarine_to_sgrid``, reference convert.py:526)
- Delft3D structured (``delft3d_to_sgrid``, reference convert.py:589)
- FESOM2 (``fesom_to_ugrid``, reference convert.py:775)
- ICON (``icon_to_ugrid``, reference convert.py:813)
"""

from __future__ import annotations

import warnings

import numpy as np

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._logging import logger

__all__ = [
    "copernicusmarine_to_sgrid",
    "croco_to_sgrid",
    "delft3d_to_sgrid",
    "fesom_to_ugrid",
    "icon_to_ugrid",
    "mitgcm_to_sgrid",
    "nemo_to_sgrid",
]

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
_MITGCM_VARNAMES_MAPPING = {"XG": "lon", "YG": "lat", "Zl": "depth"}
_MITGCM_AXIS_VARNAMES = {
    "XC": "X", "XG": "X", "Xp1": "X", "lon": "X",
    "YC": "Y", "YG": "Y", "Yp1": "Y", "lat": "Y",
    "Zu": "Z", "Zl": "Z", "Zp1": "Z", "time": "T",
}
_CROCO_VARNAMES_MAPPING = {"x_rho": "lon", "y_rho": "lat", "s_w": "depth"}
_COPERNICUS_AXIS_COORDS = {
    "longitude": "lon", "latitude": "lat", "lon": "lon", "lat": "lat",
    "depth": "depth", "elevation": "depth", "time": "time",
}
_DELFT3D_VARNAMES_MAPPING = {
    "XZETA": "lon", "YZETA": "lat", "SIGMA_C": "depth", "TIME": "time",
}
_DELFT3D_AXIS_VARNAMES = {"M": "X", "N": "Y", "LAYER": "Z", "time": "T"}

# vertical dim names per unstructured model (reference convert.py:650-652)
_FESOM2_VERTICAL_DIMS = {"interface": "nz", "center": "nz1"}
_ICON_VERTICAL_DIMS = {"interface": "depth_2", "center": "depth"}

# CF standard_name pairs identifying the (U, V) velocity components across
# Copernicus Marine products (reference fieldset.py:444-469, where the table
# is defined but never consumed; here it drives actual autodiscovery when the
# caller passes native-named variables instead of U/V keys).
_COPERNICUS_MARINE_CF_STANDARD_NAME_FALLBACKS = {
    "UV": [
        ("eastward_sea_water_velocity", "northward_sea_water_velocity"),
        ("surface_geostrophic_eastward_sea_water_velocity",
         "surface_geostrophic_northward_sea_water_velocity"),
        ("geostrophic_eastward_sea_water_velocity",
         "geostrophic_northward_sea_water_velocity"),
        ("sea_surface_wave_stokes_drift_x_velocity",
         "sea_surface_wave_stokes_drift_y_velocity"),
        ("sea_water_x_velocity", "sea_water_y_velocity"),
        ("eastward_sea_water_velocity_vertical_mean_over_pelagic_layer",
         "northward_sea_water_velocity_vertical_mean_over_pelagic_layer"),
    ],
    "W": ["upward_sea_water_velocity", "vertical_sea_water_velocity"],
}


def _maybe_flip_descending_lat(ds: xr.Dataset) -> xr.Dataset:
    """Reverse a descending 1-D ``lat`` coordinate (and every variable along
    its dimension).

    ERA5 and some Copernicus products ship latitude north-to-south; the grid
    runtime requires strictly increasing axes (as does the reference,
    xgrid.py:512-515, which asks the user to reindex instead — here the
    converter does the reindex).
    """
    if "lat" not in ds:
        return ds
    lat = ds["lat"]
    if lat.ndim != 1 or lat.shape[0] < 2 or not np.all(np.diff(lat.values) < 0):
        return ds
    dim = lat.dims[0]
    logger.info("convert: flipping descending 1-D latitude axis %r", dim)
    out = ds.copy()
    for name, da in list(out.data_vars.items()) + list(out.coords.items()):
        if dim in da.dims:
            ax = da.dims.index(dim)
            da.values = np.flip(np.asarray(da.values), axis=ax)
    return out


def _discover_copernicus_uv(ds: xr.Dataset) -> xr.Dataset:
    """Rename native-named velocity variables to U/V/W via CF standard names.

    No-op when U and V already exist. Raises if two candidate pairs match.
    """
    if "U" in ds.data_vars and "V" in ds.data_vars:
        return ds
    by_std = {}
    for name, da in ds.data_vars.items():
        std = da.attrs.get("standard_name")
        if std:
            by_std.setdefault(std, []).append(name)
    rename: dict[str, str] = {}
    for u_std, v_std in _COPERNICUS_MARINE_CF_STANDARD_NAME_FALLBACKS["UV"]:
        if u_std in by_std and v_std in by_std:
            if rename:
                raise ValueError(
                    "Multiple velocity-component pairs matched Copernicus Marine "
                    "standard-name fallbacks; pass fields={'U': ..., 'V': ...} explicitly."
                )
            if len(by_std[u_std]) > 1 or len(by_std[v_std]) > 1:
                raise ValueError(
                    f"Ambiguous variables for standard names {u_std!r}/{v_std!r}."
                )
            rename[by_std[u_std][0]] = "U"
            rename[by_std[v_std][0]] = "V"
    for w_std in _COPERNICUS_MARINE_CF_STANDARD_NAME_FALLBACKS["W"]:
        if w_std in by_std and "W" not in ds.data_vars and len(by_std[w_std]) == 1:
            rename[by_std[w_std][0]] = "W"
            break
    if rename:
        logger.info("convert: standard-name velocity discovery %s", rename)
        ds = ds.rename(rename)
    return ds


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


def _maybe_swap_depth_direction(ds: xr.Dataset) -> xr.Dataset:
    """Flip a decreasing depth axis (and all data on it) to increasing."""
    if "depth" not in ds:
        return ds
    depth = np.asarray(ds["depth"].values)
    if depth.size > 1 and depth[0] > depth[-1]:
        logger.info("convert: flipping decreasing depth axis")
        ddim = ds["depth"].dims[0]
        for name, da in list(ds.variables.items()):
            if ddim in da.dims:
                ax = da.dims.index(ddim)
                ds[name] = xr.DataArray(np.flip(np.asarray(da.values), axis=ax),
                                        dims=da.dims, attrs=da.attrs, name=name)
    return ds


def _maybe_expand_depth(ds: xr.Dataset, depth_axis_pos: int = 1) -> xr.Dataset:
    """Add a singleton depth dimension to depth-less velocity fields."""
    if "depth" in ds.dims:
        return ds
    for name in list(ds.data_vars):
        da = ds[name]
        if "time" in da.dims and "depth" not in da.dims and da.ndim >= 3:
            vals = np.expand_dims(np.asarray(da.values), axis=depth_axis_pos)
            ds[name] = xr.DataArray(vals, dims=(da.dims[0], "depth") + da.dims[1:],
                                    attrs=da.attrs, name=name)
    ds["depth"] = xr.DataArray(np.zeros(1), dims=("depth",), attrs={"axis": "Z"})
    ds.set_coords("depth")
    logger.info("convert: added singleton depth dimension (surface data)")
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


# ---------------------------------------------------------------------------
# Structured models
# ---------------------------------------------------------------------------


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


def mitgcm_to_sgrid(*, fields: dict, coords) -> xr.Dataset:
    """MITgcm output -> SGRID dataset (reference convert.py:411-468)."""
    ds = _merge_fields_and_coords(dict(fields), coords)
    for name in ("XG", "YG", "Zl"):
        if name not in ds:
            raise ValueError(f"Expected coordinate {name!r} not found in provided coords dataset.")
    ds = _maybe_rename(ds, _MITGCM_VARNAMES_MAPPING)
    ds = _set_axis_attrs(ds, _MITGCM_AXIS_VARNAMES)
    ds = _maybe_swap_depth_direction(ds)
    return _attach_grid(
        ds,
        sgrid.SGrid2DMetadata(
            node_dimensions=("lon", "lat"),
            node_coordinates=("lon", "lat"),
            face_dimensions=(
                sgrid.FaceNodePadding("XC", "lon", sgrid.Padding.HIGH),
                sgrid.FaceNodePadding("YC", "lat", sgrid.Padding.HIGH),
            ),
            vertical_dimensions=(sgrid.FaceNodePadding("depth", "depth", sgrid.Padding.HIGH),),
        ),
    )


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


def copernicusmarine_to_sgrid(*, fields: dict, coords=None) -> xr.Dataset:
    """Copernicus Marine (A-grid) output -> SGRID dataset (reference :526-588)."""
    ds = _merge_fields_and_coords(dict(fields), coords)
    ds = _discover_copernicus_uv(ds)
    ds = _maybe_rename(ds, _COPERNICUS_AXIS_COORDS)
    ds = _maybe_flip_descending_lat(ds)
    ds = _set_axis_attrs(ds, {"lon": "X", "lat": "Y", "depth": "Z", "time": "T"})
    ds = _maybe_expand_depth(ds)
    ds = _negate_w(ds)
    return _attach_grid(
        ds,
        sgrid.SGrid2DMetadata(  # dummy *_center dims: A-grid, all on nodes
            node_dimensions=("lon", "lat"),
            node_coordinates=("lon", "lat"),
            face_dimensions=(
                sgrid.FaceNodePadding("x_center", "lon", sgrid.Padding.LOW),
                sgrid.FaceNodePadding("y_center", "lat", sgrid.Padding.LOW),
            ),
            vertical_dimensions=(sgrid.FaceNodePadding("depth_center", "depth", sgrid.Padding.LOW),),
        ),
    )


def delft3d_to_sgrid(*, fields: dict, coords) -> xr.Dataset:
    """Structured Delft3D output -> SGRID dataset (reference convert.py:589-650)."""
    warnings.warn(
        "The delft3d_to_sgrid function is experimental and may not work for all "
        "Delft3D datasets.",
        UserWarning,
        stacklevel=2,
    )
    ds = _merge_fields_and_coords(dict(fields), coords)
    for name in ("XZETA", "YZETA"):
        if name not in ds:
            raise ValueError(f"Expected coordinate {name!r} not found in provided coords dataset.")
    ds = _maybe_rename(ds, _DELFT3D_VARNAMES_MAPPING)
    ds = _set_axis_attrs(ds, _DELFT3D_AXIS_VARNAMES)
    return _attach_grid(
        ds,
        sgrid.SGrid2DMetadata(
            node_dimensions=("M", "N"),
            node_coordinates=("lon", "lat"),
            face_dimensions=(
                sgrid.FaceNodePadding("X", "M", sgrid.Padding.LOW),
                sgrid.FaceNodePadding("Y", "N", sgrid.Padding.LOW),
            ),
            vertical_dimensions=(sgrid.FaceNodePadding("Z", "LAYER", sgrid.Padding.HIGH),),
        ),
    )


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

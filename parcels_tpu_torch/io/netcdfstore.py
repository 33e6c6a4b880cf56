"""NetCDF dataset reader/writer with lazy time-windowed reads.

Port of the JAX package's ``io/netcdfstore.py``. NetCDF files are either
the classic CDF-1/2 binary format, read everywhere through
``scipy.io.netcdf_file`` (memory-mapped, so a window read touches only its
levels), or netCDF-4 HDF5 containers, read through h5py where it is
importable; without h5py an HDF5 file raises an ``ImportError`` that says
so. The writer writes netCDF-4 through h5py, as the JAX package does, or
classic CDF-2 through scipy (``format="NETCDF3_CLASSIC"``) on a machine
without h5py.

Design as :mod:`parcels_tpu_torch.io.zarrstore`: coordinates load eagerly,
data variables become ``LazyZarrArray`` handles over a small array facade,
so the zarr and NetCDF paths share one window reader. CF time units decode
to datetime64/timedelta64.
"""

from __future__ import annotations

import os

import numpy as np

from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch.io.zarrstore import LazyZarrArray, _cf_encode, _decode_cf_values, _json_safe

__all__ = ["open_netcdf_dataset", "write_netcdf_dataset"]

# netCDF dimensions without a coordinate variable appear in HDF5 as pure
# dimension scales carrying this marker in their NAME attribute
_NC_DIM_MARKER = b"This is a netCDF dimension but not a netCDF variable"

_FORMATS = ("NETCDF4", "NETCDF3_CLASSIC")


class _NCArray:
    """The array surface ``LazyZarrArray`` reads through, over an h5py
    Dataset or a scipy memory-mapped variable."""

    def __init__(self, arr, keepalive=None):
        self._arr = arr
        self._keepalive = keepalive  # the open file object the handle reads from
        self.shape = tuple(int(s) for s in arr.shape)
        self.dtype = np.dtype(arr.dtype)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def read_into(self, box, out: np.ndarray) -> None:
        sel = tuple(slice(lo, hi) for lo, hi in box)
        if hasattr(self._arr, "read_direct") and out.dtype == self.dtype and out.flags.c_contiguous:
            self._arr.read_direct(out, sel)
        else:
            np.copyto(out, self._arr[sel], casting="unsafe")


def _attr_value(v):
    """HDF5/classic attribute to a JSON-ish python value (bytes -> str)."""
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        if v.dtype.kind in "SU" and v.size == 1:
            return _attr_value(v.item())
        return v
    if isinstance(v, np.generic):
        return v.item()
    return v


def _sniff_format(path: str) -> str:
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:3] == b"CDF":
        return "classic"
    if magic == b"\x89HDF\r\n\x1a\n":
        return "hdf5"
    raise ValueError(
        f"{path!r} is not a NetCDF file (magic {magic[:4]!r}); expected "
        "netCDF-classic ('CDF\\x01/\\x02') or netCDF-4/HDF5."
    )


def _h5py(what: str):
    try:
        import h5py
    except ImportError:
        raise ImportError(
            f"{what} needs h5py, which is not importable here. netCDF-classic files "
            "read and write without it (write_netcdf_dataset(..., format='NETCDF3_CLASSIC'))."
        ) from None
    return h5py


def _h5_members(path: str):
    """(global attrs, [(name, dims, attrs, handle)]) of every real variable
    in an HDF5-backed netCDF-4 file (dimension-only scales skipped)."""
    h5py = _h5py(f"The netCDF-4/HDF5 file {path!r}")
    f = h5py.File(path, "r")  # stays open: lazy handles read from it
    global_attrs = {k: _attr_value(v) for k, v in f.attrs.items()}
    skip = ("DIMENSION_LIST", "REFERENCE_LIST", "CLASS", "NAME", "_Netcdf4Dimid",
            "_Netcdf4Coordinates")
    members = []
    for name, dset in f.items():
        if not isinstance(dset, h5py.Dataset):
            continue
        nm = dset.attrs.get("NAME")
        if isinstance(nm, bytes) and nm.startswith(_NC_DIM_MARKER):
            continue
        attrs = {k: _attr_value(v) for k, v in dset.attrs.items() if k not in skip}
        is_scale = dset.attrs.get("CLASS") == b"DIMENSION_SCALE"
        dims = []
        for i, dp in enumerate(dset.dims):
            label = None
            try:
                if len(dp) > 0:
                    label = dp[0].name.rsplit("/", 1)[-1]
            except (KeyError, RuntimeError):
                label = None
            if not label:
                # a dimension scale without further attachment IS the
                # coordinate variable of its own dimension
                label = name if is_scale and dset.ndim == 1 else (dp.label or f"phony_dim_{i}")
            dims.append(str(label))
        members.append((str(name), tuple(dims), attrs, dset))
    return global_attrs, members, f


def _classic_members(path: str):
    """The same for classic-format files through scipy (memory-mapped)."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=True, maskandscale=False)
    global_attrs = {k: _attr_value(v) for k, v in (f._attributes or {}).items()}
    members = []
    for name, var in f.variables.items():
        attrs = {k: _attr_value(v) for k, v in (var._attributes or {}).items()}
        members.append((str(name), tuple(var.dimensions), attrs, var.data))
    return global_attrs, members, f


def open_netcdf_dataset(path: str, decode_times: bool = True) -> xr.Dataset:
    """Open a NetCDF file as an xrlite Dataset with lazy data variables.

    NetCDF twin of :func:`parcels_tpu_torch.io.open_zarr_dataset`:
    coordinates load eagerly, data variables stay on disk until the
    simulation's rolling time window requests them.
    """
    path = os.fspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    read = _h5_members if _sniff_format(path) == "hdf5" else _classic_members
    # the open file must outlive every lazy handle
    group_attrs, members, keepalive = read(path)

    declared_coords = set(str(group_attrs.get("coordinates", "")).split())
    data_vars: dict[str, xr.DataArray] = {}
    coords: dict[str, xr.DataArray] = {}
    for name, dims, attrs, handle in members:
        ndim = len(dims)
        is_coord = (
            name in declared_coords
            or (ndim == 1 and dims[0] == name)
            or attrs.get("cf_role") == "grid_topology"
        )
        if is_coord or ndim <= 2 or attrs.get("cf_role"):
            # np.array: detach eager values from any underlying mmap
            values = np.array(handle[...] if ndim else handle[()])
            if decode_times:
                values = _decode_cf_values(values, attrs)
            da = xr.DataArray(values, dims, attrs, name)
        else:
            lazy = LazyZarrArray(_NCArray(handle, keepalive), name=name)
            da = xr.DataArray(lazy, dims, attrs, name)
        (coords if is_coord else data_vars)[name] = da

    ds = xr.Dataset()
    ds.data_vars = data_vars
    ds.coords = coords
    ds.attrs = {k: v for k, v in group_attrs.items() if k != "coordinates"}
    ds._check_dims()
    return ds


def _collect(ds):
    coords = dict(getattr(ds, "coords", {}))
    data_vars = dict(getattr(ds, "data_vars", {}))
    attrs = dict(getattr(ds, "attrs", {}) or {})
    if coords:
        attrs["coordinates"] = " ".join(sorted(str(k) for k in coords))
    return coords, data_vars, attrs


def _encode(da):
    return _cf_encode(np.asarray(da.values), dict(getattr(da, "attrs", {}) or {}))


def _dims(da) -> tuple:
    return tuple(str(d) for d in (getattr(da, "dims", ()) or ()))


def write_netcdf_dataset(ds, path: str, chunk_time: int = 1, format: str = "NETCDF4") -> None:
    """Write an (xrlite or xarray) Dataset to a NetCDF file.

    ``format="NETCDF4"`` (h5py, as the JAX package writes): data variables
    are chunked ``chunk_time`` levels along a leading 'time' dimension, and
    coordinate variables become HDF5 dimension scales so any NetCDF reader
    sees named dims. ``format="NETCDF3_CLASSIC"`` (scipy, CDF-2): each
    variable is stored contiguously, so a window is one contiguous read;
    64-bit integers (CF times included) are stored as float64, which
    classic files lack. Datetimes encode as CF 'seconds since <epoch>'.
    """
    if format not in _FORMATS:
        raise ValueError(f"format must be one of {_FORMATS}. Got {format!r}")
    path = os.fspath(path)
    if format == "NETCDF3_CLASSIC":
        _write_classic(ds, path)
        return
    h5py = _h5py("Writing netCDF-4")
    coords, data_vars, attrs = _collect(ds)
    with h5py.File(path, "w") as f:
        for k, v in attrs.items():
            if _json_safe(v):
                f.attrs[k] = v

        dim_sizes: dict[str, int] = {}
        for da in {**coords, **data_vars}.values():
            for d, s in zip(_dims(da), np.shape(da.values)):
                dim_sizes[d] = int(s)

        # coordinate variables first: they double as dimension scales
        for name, da in coords.items():
            values, var_attrs = _encode(da)
            dset = f.create_dataset(str(name), data=values)
            for k, v in var_attrs.items():
                if _json_safe(v):
                    dset.attrs[k] = v
            if values.ndim == 1 and _dims(da) == (str(name),):
                dset.make_scale(str(name))

        # dimension-only scales for dims without a coordinate variable
        for d, s in dim_sizes.items():
            if d not in f:
                dset = f.create_dataset(d, data=np.arange(s, dtype=np.int32))
                dset.attrs["NAME"] = _NC_DIM_MARKER + b" %d" % s
                dset.make_scale(d)

        for name, da in data_vars.items():
            values, var_attrs = _encode(da)
            chunks = None
            if _dims(da) and _dims(da)[0] == "time" and values.ndim > 1:
                chunks = (min(chunk_time, values.shape[0]),) + values.shape[1:]
            dset = f.create_dataset(str(name), data=values, chunks=chunks)
            for k, v in var_attrs.items():
                if _json_safe(v):
                    dset.attrs[k] = v

        # attach dimension scales to EVERY variable (incl. coordinate vars
        # on a foreign dimension, e.g. lat(YG)) so named dims round-trip
        for name, da in {**coords, **data_vars}.items():
            dset = f[str(name)]
            for i, d in enumerate(_dims(da)):
                if d in f and f[d].name != dset.name:
                    dset.dims[i].attach_scale(f[d])


def _write_classic(ds, path: str) -> None:
    from scipy.io import netcdf_file

    coords, data_vars, attrs = _collect(ds)
    f = netcdf_file(path, "w", version=2)
    try:
        for k, v in attrs.items():
            if isinstance(v, (str, int, float)):
                setattr(f, k, v)
        for name, da in {**coords, **data_vars}.items():
            values, var_attrs = _encode(da)
            if values.dtype.kind in "iu" and values.dtype.itemsize == 8:
                values = values.astype(np.float64)
            elif values.dtype.kind == "b":
                values = values.astype(np.int8)
            dims = _dims(da) or tuple(f"{name}_dim_{i}" for i in range(values.ndim))
            for d, s in zip(dims, values.shape):
                if d not in f.dimensions:
                    f.createDimension(d, int(s))
            var = f.createVariable(str(name), values.dtype, dims)
            var[...] = values
            for k, v in var_attrs.items():
                if isinstance(v, (str, int, float)):
                    setattr(var, k, v)
    finally:
        f.close()

"""Minimal xarray-compatible labeled-array containers.

The runtime environment of the TPU build does not ship xarray/dask; this
module provides the small Dataset/DataArray subset the ingestion layer needs
(dims, coords, attrs, rename, item access) with an API mirroring xarray's, so
that real ``xarray.Dataset`` objects are accepted interchangeably everywhere
parcels_tpu_torch consumes datasets (everything is duck-typed against this
interface). Field *data* never lives here long: ingestion immediately
normalizes it to dense (T,Z,Y,X) numpy and ships it to the device.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

__all__ = ["DataArray", "Dataset"]


class DataArray:
    """A named n-d array with dimension names and attributes."""

    __slots__ = ("name", "dims", "values", "attrs")

    def __init__(self, data, dims: Iterable[str] | None = None, attrs: dict | None = None, name=None):
        if isinstance(data, DataArray):
            self.values = data.values
            self.dims = tuple(dims) if dims is not None else data.dims
            self.attrs = dict(attrs) if attrs is not None else dict(data.attrs)
            self.name = name if name is not None else data.name
            return
        # lazy disk-backed arrays (io.zarrstore.LazyZarrArray) pass through
        # un-materialized; everything downstream duck-types on shape/dtype
        self.values = data if getattr(data, "_parcels_lazy", False) else np.asarray(data)
        self.dims = tuple(dims) if dims is not None else tuple(f"dim_{i}" for i in range(self.values.ndim))
        if len(self.dims) != self.values.ndim:
            raise ValueError(f"dims {self.dims} do not match array with {self.values.ndim} dims")
        self.attrs = dict(attrs) if attrs is not None else {}
        self.name = name

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def data(self):
        return self.values

    @property
    def sizes(self):
        return dict(zip(self.dims, self.values.shape))

    def copy(self, deep: bool = False):
        """Metadata copy; values shared unless ``deep``.

        DELIBERATE DIVERGENCE from xarray: ``xr.DataArray.copy`` defaults to
        ``deep=True``; here the default is shallow because deep-copying
        silently duplicated multi-GB fields on every rename at MOi scale.
        Callers must not mutate ``.values`` in place after a default copy —
        in-repo call sites reassign instead. Pass ``deep=True`` for xarray
        semantics."""
        vals = self.values
        if deep and not getattr(vals, "_parcels_lazy", False):
            vals = vals.copy()
        return DataArray(vals, self.dims, dict(self.attrs), self.name)

    def rename_dims(self, mapping: Mapping[str, str]):
        return DataArray(
            self.values, tuple(mapping.get(d, d) for d in self.dims), dict(self.attrs), self.name
        )

    def isel(self, indexers: Mapping[str, object] | None = None, **indexers_kwargs):
        """Positional indexing along named dimensions (xarray-compatible subset).

        Integer indexers drop the dimension; slices and integer arrays keep it.
        """
        idx = dict(indexers or {}) | indexers_kwargs
        key = []
        dims = []
        for d, n in zip(self.dims, self.shape):
            sel = idx.pop(d, slice(None))
            key.append(sel)
            if not isinstance(sel, (int, np.integer)):
                dims.append(d)
        if idx:
            raise ValueError(f"Dimensions {sorted(idx)} not found in DataArray dims {self.dims}")
        return DataArray(np.asarray(self.values)[tuple(key)], tuple(dims), dict(self.attrs), self.name)

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def __repr__(self):
        return f"<DataArray {self.name!r} dims={self.dims} shape={self.shape}>"


class Dataset:
    """A dict of DataArrays sharing dimensions, split into data_vars and coords."""

    def __init__(self, data_vars: Mapping | None = None, coords: Mapping | None = None, attrs: dict | None = None):
        self.data_vars: dict[str, DataArray] = {}
        self.coords: dict[str, DataArray] = {}
        self.attrs: dict = dict(attrs) if attrs else {}
        for name, spec in (coords or {}).items():
            self.coords[name] = _as_dataarray(name, spec)
        for name, spec in (data_vars or {}).items():
            self.data_vars[name] = _as_dataarray(name, spec)
        self._check_dims()

    def _check_dims(self):
        sizes: dict[str, int] = {}
        for da in list(self.data_vars.values()) + list(self.coords.values()):
            for d, s in zip(da.dims, da.shape):
                if d in sizes and sizes[d] != s:
                    raise ValueError(f"Conflicting sizes for dim {d!r}: {sizes[d]} vs {s}")
                sizes[d] = s
        self._sizes = sizes

    @property
    def sizes(self) -> dict[str, int]:
        self._check_dims()
        return dict(self._sizes)

    @property
    def sgrid(self):
        """SGRID accessor (reference _sgrid/accessor.py:12): metadata /
        rename / padding-aware paired isel on this dataset."""
        from parcels_tpu_torch._sgrid import SgridAccessor

        return SgridAccessor(self)

    @property
    def dims(self):
        return self.sizes

    @property
    def variables(self) -> dict[str, DataArray]:
        return {**self.coords, **self.data_vars}

    def __contains__(self, name) -> bool:
        return name in self.data_vars or name in self.coords

    def __getitem__(self, name) -> DataArray:
        if name in self.data_vars:
            return self.data_vars[name]
        if name in self.coords:
            return self.coords[name]
        raise KeyError(name)

    def __setitem__(self, name, value):
        self.data_vars[name] = _as_dataarray(name, value)
        self._check_dims()

    def set_coords(self, name):
        if name in self.data_vars:
            self.coords[name] = self.data_vars.pop(name)
        return self

    def copy(self) -> "Dataset":
        ds = Dataset()
        ds.data_vars = {k: v.copy() for k, v in self.data_vars.items()}
        ds.coords = {k: v.copy() for k, v in self.coords.items()}
        ds.attrs = dict(self.attrs)
        ds._check_dims()
        return ds

    def rename(self, mapping: Mapping[str, str]) -> "Dataset":
        ds = Dataset()
        ds.attrs = dict(self.attrs)
        for k, v in self.data_vars.items():
            ds.data_vars[mapping.get(k, k)] = v.rename_dims(mapping)
        for k, v in self.coords.items():
            ds.coords[mapping.get(k, k)] = v.rename_dims(mapping)
        ds._check_dims()
        return ds

    def isel(self, indexers: Mapping[str, object] | None = None, **indexers_kwargs) -> "Dataset":
        """Positional indexing along named dimensions (xarray-compatible subset).

        Variables lacking an indexed dimension pass through unchanged.
        """
        idx = dict(indexers or {}) | indexers_kwargs
        unknown = set(idx) - set(self.sizes)
        if unknown:
            raise ValueError(f"Dimensions {sorted(unknown)} not found in dataset dims {sorted(self.sizes)}")
        ds = Dataset(attrs=dict(self.attrs))
        for group_src, group_dst in ((self.data_vars, ds.data_vars), (self.coords, ds.coords)):
            for name, da in group_src.items():
                hit = {d: s for d, s in idx.items() if d in da.dims}
                group_dst[name] = da.isel(hit) if hit else da.copy()
        ds._check_dims()
        return ds

    def drop_vars(self, names) -> "Dataset":
        names = {names} if isinstance(names, str) else set(names)
        ds = self.copy()
        for n in names:
            ds.data_vars.pop(n, None)
            ds.coords.pop(n, None)
        return ds

    def __repr__(self):
        return (
            f"<Dataset dims={self.sizes} data_vars={list(self.data_vars)} "
            f"coords={list(self.coords)}>"
        )


def _as_dataarray(name, spec) -> DataArray:
    if isinstance(spec, DataArray):
        da = spec.copy()
        da.name = name
        return da
    if hasattr(spec, "values") and hasattr(spec, "dims"):  # real xarray object
        return DataArray(np.asarray(spec.values), tuple(spec.dims), dict(spec.attrs), name)
    if isinstance(spec, tuple):
        if len(spec) == 2:
            dims, values = spec
            attrs = None
        elif len(spec) == 3:
            dims, values, attrs = spec
        else:
            raise ValueError(f"Cannot interpret tuple of length {len(spec)} as a DataArray")
        return DataArray(np.asarray(values), tuple(dims), attrs, name)
    return DataArray(np.asarray(spec), name=name)

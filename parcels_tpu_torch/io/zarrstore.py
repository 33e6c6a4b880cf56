"""Zarr dataset reader/writer with lazy time-windowed reads (numpy).

Port of the JAX package's ``io/zarrstore.py``: forcing fields larger than
host memory are opened *lazily*, and only the rolling time window the
simulation needs is read from disk (``FieldSet.set_time_window``).

The JAX package reads and writes through tensorstore. The port reads the
chunk files itself with numpy, for the layouts the standard library
decodes:

- zarr v2 arrays (``.zarray``) with no compressor, ``zlib`` or ``gzip``, no
  filters, C or F order, ``.`` or ``/`` as the key separator;
- zarr v3 arrays (``zarr.json``) whose codecs are ``bytes`` (either endian)
  optionally followed by ``gzip``, with the default or v2 chunk keys.

Missing chunks read as the array's ``fill_value``. Any other codec (blosc,
the JAX writer's default, or zstd, transpose, checksums) is read through
tensorstore where it is importable; otherwise opening the array raises an
``ImportError`` that names the codec. The writer writes zarr v2 with numpy,
uncompressed by default or with ``zlib``; tensorstore reads what it writes.

A window read lands directly in a caller-given buffer (``LazyZarrArray.
read_window``): an uncompressed chunk whose rows are contiguous in that
buffer is read with ``readinto``, which releases the interpreter lock, with
no temporary. Normalization to the engine's (T, Z, Y, X) order and the NaN
fill are recorded on the handle and applied to each window after its read.

Layout: a zarr group directory; each member array carries the xarray
``_ARRAY_DIMENSIONS`` attribute (v2) or ``dimension_names`` (v3).
Coordinate arrays (1-D named after their own dimension, listed in the
group's ``coordinates`` attribute, or of at most 2 dimensions) are read
eagerly. Data variables become ``LazyZarrArray``s. CF-encoded time
coordinates ("<unit> since <epoch>") decode to np.datetime64; bare
duration units decode to np.timedelta64.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import re
import shutil
import zlib

import numpy as np

from parcels_tpu_torch import xrlite as xr

__all__ = ["LazyZarrArray", "open_raw_zarr", "open_zarr_dataset", "write_zarr_dataset"]

_CF_TIME_RE = re.compile(
    r"^\s*(second|sec|s|minute|min|hour|hr|h|day|d)s?\s+since\s+(.+?)\s*$", re.IGNORECASE
)
_UNIT_CODE = {
    "second": "s", "sec": "s", "s": "s",
    "minute": "m", "min": "m",
    "hour": "h", "hr": "h", "h": "h",
    "day": "D", "d": "D",
}
_BARE_DURATION = {"second", "sec", "s", "seconds", "minute", "minutes", "min",
                  "hour", "hours", "hr", "h", "day", "days", "d"}

#: compressors of zarr v2 (and the v3 bytes-to-bytes codec) the port decodes
_DECOMPRESS = {
    None: None,
    "zlib": zlib.decompress,
    "gzip": gzip.decompress,
}


class _UnsupportedLayout(Exception):
    """An array layout the numpy reader does not decode (carries its name)."""


def _fill_value(raw, dtype: np.dtype):
    if raw is None:
        return dtype.type(0)
    if isinstance(raw, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if raw not in special:
            raise _UnsupportedLayout(f"fill_value {raw!r}")
        return dtype.type(special[raw])
    return dtype.type(raw)


class _ChunkFiles:
    """One zarr array on disk, read chunk file by chunk file with numpy."""

    def __init__(self, path, shape, chunks, dtype, compressor, fill, order, key):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.chunks = tuple(int(c) for c in chunks)
        self.dtype = dtype
        self._decompress = _DECOMPRESS[compressor]
        self._fill = fill
        self._order = order
        self._key = key

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @classmethod
    def open_v2(cls, path: str, meta: dict) -> "_ChunkFiles":
        if meta.get("filters"):
            ids = ", ".join(f.get("id", "?") for f in meta["filters"])
            raise _UnsupportedLayout(f"filters {ids}")
        comp = meta.get("compressor")
        cid = None if comp is None else comp.get("id")
        if cid not in _DECOMPRESS:
            raise _UnsupportedLayout(f"the {cid!r} compressor")
        if not isinstance(meta["dtype"], str):
            raise _UnsupportedLayout(f"structured dtype {meta['dtype']!r}")
        dtype = np.dtype(meta["dtype"])
        order = meta.get("order", "C")
        sep = meta.get("dimension_separator", ".")
        ndim = len(meta["shape"])

        def key(idx):
            return sep.join(map(str, idx)) if ndim else "0"

        return cls(path, meta["shape"], meta["chunks"], dtype, cid,
                   _fill_value(meta.get("fill_value"), dtype), order, key)

    @classmethod
    def open_v3(cls, path: str, meta: dict) -> "_ChunkFiles":
        grid = meta.get("chunk_grid", {})
        if grid.get("name") != "regular":
            raise _UnsupportedLayout(f"chunk grid {grid.get('name')!r}")
        chunks = grid["configuration"]["chunk_shape"]
        codecs = list(meta.get("codecs", []))
        if not codecs or codecs[0].get("name") != "bytes":
            raise _UnsupportedLayout("codecs " + ", ".join(c.get("name", "?") for c in codecs))
        endian = codecs[0].get("configuration", {}).get("endian", "little")
        dtype = np.dtype(meta["data_type"]).newbyteorder("<" if endian == "little" else ">")
        rest = [c.get("name") for c in codecs[1:]]
        if rest not in ([], ["gzip"]):
            raise _UnsupportedLayout("the " + ", ".join(map(repr, rest)) + " codec")
        enc = meta.get("chunk_key_encoding", {"name": "default"})
        default_sep = "/" if enc["name"] == "default" else "."
        sep = enc.get("configuration", {}).get("separator", default_sep)
        ndim = len(meta["shape"])
        if enc["name"] == "default":
            def key(idx):
                return sep.join(["c", *map(str, idx)])
        elif enc["name"] == "v2":
            def key(idx):
                return sep.join(map(str, idx)) if ndim else "0"
        else:
            raise _UnsupportedLayout(f"chunk key encoding {enc['name']!r}")
        return cls(path, meta["shape"], chunks, dtype, rest[0] if rest else None,
                   _fill_value(meta.get("fill_value"), dtype), "C", key)

    def _decode(self, fname: str) -> np.ndarray:
        with open(fname, "rb") as fh:
            raw = fh.read()
        if self._decompress is not None:
            raw = self._decompress(raw)
        n = int(np.prod(self.chunks))
        if len(raw) != n * self.dtype.itemsize:
            raise ValueError(f"chunk {fname!r} holds {len(raw)} bytes, expected "
                             f"{n * self.dtype.itemsize}")
        if self._order == "F":
            return np.frombuffer(raw, self.dtype).reshape(self.chunks[::-1]).T
        return np.frombuffer(raw, self.dtype).reshape(self.chunks)

    def _read_rows(self, fname: str, src, dst, out) -> bool:
        """Read an uncompressed chunk's rows straight into ``out`` when they
        are contiguous there; False when the chunk needs the decode path."""
        if (self._decompress is not None or self._order != "C" or out.dtype != self.dtype
                or not out.flags.c_contiguous or self.ndim == 0):
            return False
        for k in range(1, self.ndim):
            if not (src[k].start == 0 and src[k].stop == self.chunks[k] == out.shape[k]):
                return False
        row = int(np.prod(self.chunks[1:])) * self.dtype.itemsize
        view = memoryview(out[dst[0]].reshape(-1).view(np.uint8))
        with open(fname, "rb", buffering=0) as fh:
            fh.seek(src[0].start * row)
            got = 0
            while got < view.nbytes:
                n = fh.readinto(view[got:])
                if not n:
                    raise ValueError(f"chunk {fname!r} is shorter than its rows {src[0]}")
                got += n
        return True

    def read_into(self, box, out: np.ndarray) -> None:
        """Copy the array's ``box`` (a (start, stop) pair per axis) into
        ``out``, of the box's shape; values cast to ``out``'s dtype."""
        spans = [range(lo // c, -(-hi // c)) for (lo, hi), c in zip(box, self.chunks)]
        for idx in itertools.product(*spans):
            origin = [i * c for i, c in zip(idx, self.chunks)]
            src, dst = [], []
            for (lo, hi), o, c in zip(box, origin, self.chunks):
                a, b = max(lo, o), min(hi, o + c)
                src.append(slice(a - o, b - o))
                dst.append(slice(a - lo, b - lo))
            src, dst = tuple(src), tuple(dst)
            fname = os.path.join(self.path, self._key(idx))
            if not os.path.exists(fname):
                out[dst] = self._fill
            elif not self._read_rows(fname, src, dst, out):
                out[dst] = self._decode(fname)[src]

    def read(self) -> np.ndarray:
        out = np.empty(self.shape, self.dtype)
        self.read_into([(0, s) for s in self.shape], out)
        return out


class _TensorStoreArray:
    """An array whose codec only tensorstore decodes, behind the same surface."""

    def __init__(self, store):
        self._store = store
        self.shape = tuple(int(s) for s in store.shape)
        self.dtype = np.dtype(store.dtype.numpy_dtype)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def read_into(self, box, out: np.ndarray) -> None:
        sel = tuple(slice(lo, hi) for lo, hi in box)
        out[...] = np.asarray(self._store[sel].read().result())

    def read(self) -> np.ndarray:
        return np.asarray(self._store.read().result())


def _open_array(path: str):
    """Open one zarr array (v3 when zarr.json is present, else v2)."""
    v3 = os.path.exists(os.path.join(path, "zarr.json"))
    with open(os.path.join(path, "zarr.json" if v3 else ".zarray")) as fh:
        meta = json.load(fh)
    try:
        return (_ChunkFiles.open_v3 if v3 else _ChunkFiles.open_v2)(path, meta)
    except _UnsupportedLayout as what:
        try:
            import tensorstore
        except ImportError:
            raise ImportError(
                f"zarr array {path!r} uses {what}, which this reader decodes only through "
                "tensorstore, and tensorstore is not importable. Rewrite the store "
                "uncompressed or with zlib (write_zarr_dataset(..., compressor='zlib'))."
            ) from None
        spec = {"driver": "zarr3" if v3 else "zarr", "kvstore": {"driver": "file", "path": path}}
        return _TensorStoreArray(tensorstore.open(spec).result())


class LazyZarrArray:
    """Lazy view of one on-disk array, normalized to the engine's axis order.

    Duck-types the slice of numpy the FieldSet windowing path uses:
    ``.shape/.dtype/.ndim``, time-leading ``__getitem__`` returning dense
    numpy, ``__array__``/``astype`` full materialization, and
    ``read_window`` into a caller's buffer. The TZYX normalization
    (``perm`` axis permutation + ``out_shape`` singleton insertion) and NaN
    fill are applied to each window after the read.
    """

    _parcels_lazy = True

    def __init__(self, store, perm=None, out_shape=None, t_store=None, fill=None, name=None):
        self._store = store
        self._perm = tuple(perm) if perm is not None else tuple(range(store.ndim))
        self._out_shape = (
            tuple(out_shape) if out_shape is not None
            else tuple(store.shape[i] for i in self._perm)
        )
        if int(np.prod(self._out_shape)) != int(np.prod(store.shape)):
            raise ValueError(
                f"Normalized shape {self._out_shape} incompatible with store shape {store.shape}"
            )
        # store axis that carries time (None for time-invariant fields); a
        # freshly opened, un-normalized array is sliceable on store axis 0
        self._t_store = t_store if out_shape is not None else 0
        self._fill = fill
        self.name = name

    # -- construction of derived views (used by ingestion) -------------------
    def with_tzyx(self, perm, out_shape, t_store) -> "LazyZarrArray":
        return LazyZarrArray(self._store, perm, out_shape, t_store, self._fill, self.name)

    def with_fill(self, fill_value) -> "LazyZarrArray":
        return LazyZarrArray(
            self._store, self._perm, self._out_shape, self._t_store, fill_value, self.name
        )

    # -- numpy-facing surface -------------------------------------------------
    @property
    def shape(self):
        return self._out_shape

    @property
    def ndim(self):
        return len(self._out_shape)

    @property
    def dtype(self):
        return self._store.dtype.newbyteorder("=")

    @property
    def size(self):
        return int(np.prod(self._out_shape))

    @property
    def nbytes(self):
        return self.size * self.dtype.itemsize

    def read_window(self, i0: int, i1: int, out: np.ndarray) -> np.ndarray:
        """Read time levels [i0, i1) into ``out``, of shape ``(i1 - i0,) +
        shape[1:]`` (any dtype: values are cast), normalized and NaN-filled.

        With the axes already in (T, Z, Y, X) order the store's rows land in
        ``out`` directly; otherwise through one temporary of the raw window.
        """
        box = [(0, s) for s in self._store.shape]
        if self._t_store is not None:
            box[self._t_store] = (i0, i1)
        elif (i0, i1) != (0, 1):
            raise IndexError("Array has no time axis; only [0:1] is valid.")
        raw_shape = tuple(hi - lo for lo, hi in box)
        if self._perm == tuple(sorted(self._perm)):
            self._store.read_into(box, out.reshape(raw_shape))
        else:
            raw = np.empty(raw_shape, self._store.dtype)
            self._store.read_into(box, raw)
            out[...] = raw.transpose(self._perm).reshape(out.shape)
        # the finiteness scan is ~10x cheaper than nan_to_num's passes, and
        # forcing data rarely holds a NaN outside its land mask
        if self._fill is not None and out.dtype.kind == "f" and not np.isfinite(out).all():
            np.nan_to_num(out, copy=False, nan=self._fill)
        return out

    def __getitem__(self, idx) -> np.ndarray:
        """Read a time window. idx is an int or slice on the leading axis."""
        if isinstance(idx, tuple):
            if len(idx) != 1:
                raise IndexError(
                    "LazyZarrArray supports leading-axis (time) indexing only; "
                    "materialize with np.asarray() for full access."
                )
            idx = idx[0]
        scalar = isinstance(idx, (int, np.integer))
        if scalar:
            idx = slice(int(idx), int(idx) + 1)
        if not isinstance(idx, slice) or idx.step not in (None, 1):
            raise IndexError(f"Unsupported index {idx!r} for LazyZarrArray")
        nt = self._out_shape[0] if self._t_store is not None else 1
        i0, i1, _ = idx.indices(nt)
        i1 = max(i0, i1)
        out = np.empty((i1 - i0,) + self._out_shape[1:], self.dtype)
        self.read_window(i0, i1, out)
        return out[0] if scalar else out

    def __array__(self, dtype=None, copy=None):
        full = self[0:self._out_shape[0]]
        return full.astype(dtype) if dtype is not None else full

    def astype(self, dtype):
        return self.__array__(np.dtype(dtype))

    def copy(self):
        return self

    def __repr__(self):
        return f"<LazyZarrArray {self.name!r} shape={self._out_shape} dtype={self.dtype}>"


def _decode_cf_values(values: np.ndarray, attrs: dict) -> np.ndarray:
    """Decode CF time units to datetime64/timedelta64 (reference: cftime)."""
    units = attrs.get("units")
    if not isinstance(units, str) or values.dtype.kind not in "ifu":
        return values
    m = _CF_TIME_RE.match(units)
    if m:
        code = _UNIT_CODE[m.group(1).lower()]
        epoch = np.datetime64(m.group(2).strip().replace(" ", "T").rstrip("Z"), code)
        return epoch + values.astype(np.int64).astype(f"timedelta64[{code}]")
    if units.strip().lower() in _BARE_DURATION:
        u = units.strip().lower().rstrip("s")
        code = _UNIT_CODE.get(u, None)
        if code is not None:
            return values.astype(np.int64).astype(f"timedelta64[{code}]")
    return values


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def open_zarr_dataset(path: str, decode_times: bool = True) -> xr.Dataset:
    """Open a zarr group as an xrlite Dataset with lazy data variables.

    Coordinates load eagerly; data variables stay on disk until the
    simulation's rolling time window requests them.
    """
    path = os.fspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    group_attrs = _read_json(os.path.join(path, ".zattrs"))
    group_attrs.update(_read_json(os.path.join(path, "zarr.json")).get("attributes", {}))

    members = sorted(
        name for name in os.listdir(path)
        if os.path.exists(os.path.join(path, name, ".zarray"))
        or _read_json(os.path.join(path, name, "zarr.json")).get("node_type") == "array"
    )
    if not members:
        raise ValueError(f"No zarr arrays found under {path!r}")

    declared_coords = set(str(group_attrs.get("coordinates", "")).split())
    data_vars: dict[str, xr.DataArray] = {}
    coords: dict[str, xr.DataArray] = {}
    for name in members:
        apath = os.path.join(path, name)
        v3 = _read_json(os.path.join(apath, "zarr.json"))
        attrs = dict(v3.get("attributes", {}))
        attrs.update(_read_json(os.path.join(apath, ".zattrs")))
        dims = attrs.pop("_ARRAY_DIMENSIONS", None) or v3.get("dimension_names")
        store = _open_array(apath)
        if dims is None or any(d is None for d in dims):
            dims = [f"dim_{i}" for i in range(store.ndim)]
        dims = tuple(str(d) for d in dims)
        is_coord = (
            name in declared_coords
            or (store.ndim == 1 and len(dims) == 1 and dims[0] == name)
            or attrs.get("cf_role") == "grid_topology"
        )
        if is_coord or store.ndim <= 2 or attrs.get("cf_role"):
            values = store.read()
            if decode_times:
                values = _decode_cf_values(values, attrs)
            da = xr.DataArray(values, dims, attrs, name)
        else:
            da = xr.DataArray(LazyZarrArray(store, name=name), dims, attrs, name)
        (coords if is_coord else data_vars)[name] = da

    ds = xr.Dataset()
    ds.data_vars = data_vars
    ds.coords = coords
    ds.attrs = {k: v for k, v in group_attrs.items() if k != "coordinates"}
    ds._check_dims()
    return ds


def open_raw_zarr(store, decode_times: bool = True) -> xr.Dataset:
    """Open a zarr store as a Dataset with lazy data variables.

    Name/behaviour parity with the reference's ``parcels.open_raw_zarr``:
    accepts a filesystem path or any store object exposing ``.root`` or
    ``.path`` (e.g. a zarr ``LocalStore``).
    """
    path = getattr(store, "root", None) or getattr(store, "path", None) or store
    return open_zarr_dataset(os.fspath(path), decode_times=decode_times)


def _cf_encode(values: np.ndarray, attrs: dict):
    """datetime64 -> int64 'seconds since <first>'; timedelta64 -> 'seconds'."""
    if values.dtype.kind == "M":
        base = values.astype("datetime64[s]")
        epoch = base.min()
        attrs["units"] = f"seconds since {np.datetime_as_string(epoch, unit='s')}"
        values = (base - epoch).astype("timedelta64[s]").astype(np.int64)
    elif values.dtype.kind == "m":
        values = values.astype("timedelta64[s]").astype(np.int64)
        attrs["units"] = "seconds"
    return values, attrs


def _write_array(apath: str, values: np.ndarray, chunks, compressor) -> None:
    if os.path.isdir(apath):
        shutil.rmtree(apath)
    os.makedirs(apath)
    meta = {
        "zarr_format": 2,
        "shape": list(values.shape),
        "chunks": list(chunks),
        "dtype": values.dtype.str,
        "compressor": None if compressor is None else {"id": "zlib", "level": 1},
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(apath, ".zarray"), "w") as fh:
        json.dump(meta, fh)
    spans = [range(-(-s // c)) for s, c in zip(values.shape, chunks)]
    for idx in itertools.product(*spans):
        sel = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        block = values[sel]
        if block.shape != tuple(chunks):  # edge chunks are stored whole
            full = np.zeros(chunks, values.dtype)
            full[tuple(slice(0, s) for s in block.shape)] = block
            block = full
        buf = memoryview(np.ascontiguousarray(block).reshape(-1).view(np.uint8))
        if compressor is not None:
            buf = zlib.compress(buf, 1)
        with open(os.path.join(apath, ".".join(map(str, idx)) if idx else "0"), "wb") as fh:
            fh.write(buf)


def write_zarr_dataset(ds, path: str, chunk_time: int = 1, compressor: str | None = None) -> None:
    """Write an (xrlite or xarray) Dataset to a zarr v2 group directory.

    Data variables are chunked ``chunk_time`` levels at a time along a
    leading 'time' dimension so windowed readers only touch the levels
    they need. Times encode as CF 'seconds since <epoch>' / 'seconds'.
    ``compressor`` is None (raw chunks) or ``"zlib"``.
    """
    if compressor not in (None, "zlib"):
        raise ValueError(f"compressor must be None or 'zlib'. Got {compressor!r}")
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as fh:
        json.dump({"zarr_format": 2}, fh)
    coords = dict(getattr(ds, "coords", {}))
    data_vars = dict(getattr(ds, "data_vars", {}))
    attrs = dict(getattr(ds, "attrs", {}) or {})
    if coords:
        attrs["coordinates"] = " ".join(sorted(str(k) for k in coords))
    with open(os.path.join(path, ".zattrs"), "w") as fh:
        json.dump({k: v for k, v in attrs.items() if _json_safe(v)}, fh)

    for name, da in {**coords, **data_vars}.items():
        values, var_attrs = _cf_encode(np.asarray(da.values), dict(getattr(da, "attrs", {}) or {}))
        apath = os.path.join(path, str(name))
        chunks = [max(s, 1) for s in values.shape]
        dims = tuple(getattr(da, "dims", ()) or ())
        if dims and dims[0] == "time" and values.ndim > 1:
            chunks[0] = max(1, min(chunk_time, values.shape[0]))
        _write_array(apath, values, chunks, compressor)
        var_attrs["_ARRAY_DIMENSIONS"] = [str(d) for d in dims] if dims else [
            f"dim_{i}" for i in range(values.ndim)
        ]
        with open(os.path.join(apath, ".zattrs"), "w") as fh:
            json.dump({k: v for k, v in var_attrs.items() if _json_safe(v)}, fh)


def _json_safe(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False

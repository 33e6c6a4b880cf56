"""Streaming Parquet trajectory output with an async writer thread.

Port of the JAX package's ``_core/particlefile.py`` (reference
src/parcels/_core/particlefile.py: schema, CF time metadata,
|t - t_out| <= dt/2 write mask, zstd row groups). Snapshots are dicts of
device tensors pushed to a background thread, which copies them to the host
and writes them, so output IO overlaps the next chunk. ``pyarrow`` is
imported where a file is written or read, not when the module is imported.
"""

from __future__ import annotations

import queue
import threading
from datetime import timedelta
from pathlib import Path
from typing import Literal

import numpy as np

from parcels_tpu_torch._core.particle import ParticleClass
from parcels_tpu_torch._core.timeutils import timedelta_to_float

__all__ = ["ParticleFile", "read_particlefile"]


def _get_vars_to_write(pclass: ParticleClass):
    return [v for v in pclass.variables if v.to_write]


def _get_schema(pclass: ParticleClass, file_metadata: dict, fset_time_interval):
    import pyarrow as pa

    fields = []
    for v in _get_vars_to_write(pclass):
        attrs = {str(k): str(val) for k, val in v.attrs.items()}
        if v.name == "t" and fset_time_interval is not None:
            attrs.update({str(k): str(val) for k, val in fset_time_interval.get_cf_attrs().items()})
        fields.append(pa.field(v.name, pa.from_numpy_dtype(v.dtype), metadata=attrs))
    return pa.schema(fields, metadata={str(k): str(v) for k, v in file_metadata.items()})


class ParticleFile:
    """Trajectory output to a Parquet file at ``outputdt`` cadence."""

    def __init__(
        self,
        path,
        outputdt,
        compression: Literal["zstd", "gzip", "snappy", "brotli", None] = "zstd",
        mode: Literal[None, "w"] = None,
    ):
        if not isinstance(outputdt, (np.timedelta64, timedelta, float, int)):
            raise ValueError(
                f"Expected outputdt to be a np.timedelta64, datetime.timedelta or float (seconds); "
                f"got {type(outputdt)}"
            )
        outputdt = timedelta_to_float(outputdt)
        if outputdt <= 0:
            raise ValueError(f"outputdt must be positive/non-zero. Got {outputdt!r}")
        path = Path(path)
        if path.suffix != ".parquet":
            raise ValueError(
                f"ParticleFile data is stored in Parquet files - extension must be '.parquet'. "
                f"Got {path.suffix!r}."
            )
        if mode not in {None, "w"}:
            raise ValueError(f"Invalid mode value {mode!r}. Expected one of None or 'w'.")
        if path.exists():
            if mode is None:
                raise ValueError(f"Path '{path}' already exists. Use mode='w' or use a new path.")
            path.unlink()
        if not path.parent.exists():
            raise ValueError(f"Folder location for '{path}' does not exist. Create it first.")

        self._outputdt = outputdt
        self._path = path
        self._compression = compression
        self._writer = None
        self.metadata: dict = {}
        self._pclass: ParticleClass | None = None
        self._time_interval = None

        self._queue: queue.Queue = queue.Queue(maxsize=4)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    @property
    def outputdt(self):
        return self._outputdt

    @property
    def path(self):
        return self._path

    def set_metadata(self, fieldset, pclass: ParticleClass, kernels):
        import parcels_tpu_torch

        self._pclass = pclass
        self._time_interval = fieldset.time_interval
        mesh = fieldset.gridset[0].mesh if fieldset.gridset else None
        self.metadata.update(
            {
                "feature_type": "trajectory",
                "Conventions": "CF-1.6/CF-1.7",
                "ncei_template_version": "NCEI_NetCDF_Trajectory_Template_v2.0",
                "parcels_version": parcels_tpu_torch.__version__,
                "parcels_grid_mesh": repr(mesh),
                "parcels_kernels": "".join(getattr(k, "__name__", str(k)) for k in kernels),
            }
        )

    # -- async write path -----------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    snapshot, t = item
                    self._write_sync(snapshot, t)
            except BaseException as e:  # surfaced at next write/flush
                self._error = e
            finally:
                self._queue.task_done()

    def write_snapshot(self, snapshot: dict, t: float):
        """Queue a device-side SoA snapshot for background writing.

        Only the columns the file needs (the to-write variables plus the
        t/dt/_active write-mask inputs) are kept, so the writer copies no
        more from the device than it writes.
        """
        if self._error is not None:
            raise self._error
        assert self._pclass is not None, "set_metadata must be called before writing"
        keep = {v.name for v in _get_vars_to_write(self._pclass)} | {"t", "dt", "_active"}
        snapshot = {k: v for k, v in snapshot.items() if k in keep}
        self._ensure_thread()
        self._queue.put((snapshot, float(t)))

    def write(self, pset, t, fieldset=None, indices=None):
        """Synchronous write of a ParticleSet state (reference-compatible API)."""
        if self._pclass is None:
            self._pclass = pset._pclass
            self._time_interval = (fieldset or pset.fieldset).time_interval
        self._write_sync(dict(pset._data), timedelta_to_float(t), indices=indices)

    @staticmethod
    def _to_host(v) -> np.ndarray:
        """Device->host copy of one snapshot column."""
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    def _write_sync(self, snapshot: dict, t: float, indices=None):
        import pyarrow as pa
        import pyarrow.parquet as pq

        if self._writer is None:
            self._writer = pq.ParquetWriter(
                self._path,
                _get_schema(self._pclass, self.metadata, self._time_interval),
                compression=self._compression,
            )
        data = {k: self._to_host(v) for k, v in snapshot.items()}
        if indices is None:
            mask = _to_write_particles(data, t)
        else:
            mask = np.asarray(indices)
        table = {}
        for v in _get_vars_to_write(self._pclass):
            table[v.name] = pa.array(data[v.name][mask].astype(v.dtype))
        self._writer.write_table(pa.table(table, schema=self._writer.schema))

    def flush(self):
        """Drain the queue (called at end of execute)."""
        if self._thread is not None:
            self._queue.join()
        if self._error is not None:
            raise self._error

    def close(self):
        if self._thread is not None:
            self._queue.join()
            self._queue.put(None)
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def __repr__(self):
        return f"ParticleFile(path={self._path!r}, outputdt={self._outputdt})"


def _to_write_particles(data: dict, t: float) -> np.ndarray:
    """Particles with |t_p - t| <= |dt|/2, valid and active (reference :198-221)."""
    pt = data["t"]
    dt = data["dt"]
    finite = np.isfinite(pt)
    mask = (
        np.less_equal(t - np.abs(dt) / 2, pt, where=finite, out=np.zeros_like(finite))
        & np.greater_equal(t + np.abs(dt) / 2, pt, where=finite, out=np.zeros_like(finite))
        | (np.isnan(dt) & np.equal(t, pt, where=finite, out=np.zeros_like(finite)))
    ) & finite
    if "_active" in data:
        mask = mask & data["_active"]
    return mask


def read_particlefile(path, decode_times: bool = True):
    """Read a trajectory Parquet file into a pandas DataFrame.

    With ``decode_times=True`` the numeric ``t`` column is decoded from the
    CF units metadata into datetime64/timedelta64 values.
    """
    import pyarrow.parquet as pq

    path = Path(path)
    if path.suffix != ".parquet":
        raise ValueError("Only Parquet files are supported")
    table = pq.read_table(path)
    df = table.to_pandas()
    return _decode_times_df(df, table, decode_times)


def _decode_times_df(df, table, decode_times: bool):
    try:
        time_field = table.field("t")
    except KeyError as e:
        raise ValueError("Could not find 't' column. Is this a particlefile?") from e
    if not decode_times:
        return df

    import pandas as pd

    meta = {k.decode(): v.decode() for k, v in (time_field.metadata or {}).items()}
    units = meta.get("units", "seconds")
    calendar = meta.get("calendar", "").lower()
    values = df["t"].to_numpy()
    if "since" in units:
        origin = units.split("since", 1)[1].strip()
        if calendar in ("360_day", "365_day", "366_day", "noleap", "all_leap", "julian"):
            # non-standard model calendar: decode to CFDatetime objects
            # (reference round-trips cftime the same way, particlefile.py:224-286)
            from datetime import timedelta as _td

            from parcels_tpu_torch._core.calendars import parse_cf_origin

            base = parse_cf_origin(origin, calendar)
            df["t"] = np.asarray([base + _td(seconds=float(v)) for v in values], dtype=object)
        else:
            base = np.datetime64(pd.Timestamp(origin))
            df["t"] = base + (values * 1e9).astype("timedelta64[ns]")
    else:
        df["t"] = (values * 1e9).astype("timedelta64[ns]")
    return df

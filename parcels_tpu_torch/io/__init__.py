"""Host-side dataset I/O: zarr and NetCDF stores with lazy time-windowed reads.

Port of the JAX package's ``io``. Forcing fields open lazily; only the
rolling time window the simulation needs (``FieldSet.set_time_window``) is
read from disk. Zarr chunks and classic NetCDF files are read with numpy
and scipy; other codecs and netCDF-4/HDF5 need tensorstore or h5py where
they are importable (see the two modules).
"""

from parcels_tpu_torch.io.netcdfstore import (
    open_netcdf_dataset,
    write_netcdf_dataset,
)
from parcels_tpu_torch.io.zarrstore import (
    LazyZarrArray,
    open_raw_zarr,
    open_zarr_dataset,
    write_zarr_dataset,
)

__all__ = [
    "LazyZarrArray",
    "open_netcdf_dataset",
    "open_raw_zarr",
    "open_zarr_dataset",
    "write_netcdf_dataset",
    "write_zarr_dataset",
]

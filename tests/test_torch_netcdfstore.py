"""NetCDF ingestion in the port against parcels_tpu.io.

Mirrors tests/test_netcdfstore.py through ``parcels_tpu_torch.io``: write a
dataset to NetCDF, reopen it lazily, stream it through the windowed path
and get the in-memory run's trajectories (rtol 1e-6, atol 1e-3 m, the
tolerance of tests/test_netcdfstore.py). Cases that need h5py (netCDF-4)
skip where it is absent. Then: each package reads the other's files to the
same values; the classic format (scipy) reads and writes with h5py hidden,
and an HDF5 file then raises an ``ImportError`` that names h5py.
"""

import sys

import numpy as np
import pytest

import parcels_tpu.io as jio
import parcels_tpu_torch as tp
from parcels_tpu.datasets import moving_eddy_dataset as j_eddy
from parcels_tpu_torch.datasets import moving_eddy_dataset
from parcels_tpu_torch.io import open_netcdf_dataset, write_netcdf_dataset


@pytest.fixture(scope="module", params=["NETCDF4", "NETCDF3_CLASSIC"])
def eddy_nc(request, tmp_path_factory):
    if request.param == "NETCDF4":
        pytest.importorskip("h5py")
    path = tmp_path_factory.mktemp("nc") / f"eddy_{request.param}.nc"
    write_netcdf_dataset(moving_eddy_dataset(), path, format=request.param)
    return str(path)


def test_roundtrip_values_and_time_decode(eddy_nc):
    src = moving_eddy_dataset()
    ds = open_netcdf_dataset(eddy_nc)
    assert set(ds.data_vars) >= {"U", "V"}
    assert getattr(ds["U"].values, "_parcels_lazy", False)
    np.testing.assert_array_equal(np.asarray(ds["lon"]), np.asarray(src["lon"]))
    t_src = np.asarray(src["time"].values).astype("timedelta64[s]")
    t_rt = np.asarray(ds["time"].values).astype("timedelta64[s]")
    np.testing.assert_array_equal(t_rt, t_src)
    assert ds["U"].attrs.get("units") == src["U"].attrs.get("units")
    np.testing.assert_array_equal(np.asarray(ds["U"]), np.asarray(src["U"].values))


def test_lazy_window_reads_only_window(eddy_nc):
    lazy = open_netcdf_dataset(eddy_nc)["U"].values
    win = lazy[3:7]
    assert isinstance(win, np.ndarray)
    assert win.shape[0] == 4
    np.testing.assert_array_equal(win, np.asarray(moving_eddy_dataset()["U"].values)[3:7])


def test_fieldset_from_netcdf_matches_memory(eddy_nc):
    """End-to-end: NetCDF-backed windowed run == in-memory run."""
    fs_mem = tp.FieldSet.from_sgrid_conventions(moving_eddy_dataset(), mesh="flat", device="cpu")
    fs_nc = tp.FieldSet.from_sgrid_conventions(open_netcdf_dataset(eddy_nc), mesh="flat",
                                               device="cpu")
    fs_nc.set_time_window(16)

    def run(fs):
        pset = tp.ParticleSet(fs, x=[12000.0, 15000.0], y=[12500.0, 9000.0], t=[0.0, 0.0])
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(6, "h"))
        return np.stack([pset.x, pset.y])

    np.testing.assert_allclose(run(fs_nc), run(fs_mem), rtol=1e-6, atol=1e-3)
    assert fs_nc.window_stats["loads"] >= 2


def test_classic_format_via_scipy(tmp_path):
    """netCDF-classic (CDF-1) files read through the scipy path."""
    from scipy.io import netcdf_file

    path = str(tmp_path / "classic.nc")
    f = netcdf_file(path, "w")
    f.createDimension("time", 3)
    f.createDimension("lat", 4)
    f.createDimension("lon", 5)
    v = f.createVariable("time", "i4", ("time",))
    v[:] = [0, 60, 120]
    v.units = "seconds"
    v = f.createVariable("lat", "f4", ("lat",))
    v[:] = np.linspace(-1.0, 1.0, 4)
    v = f.createVariable("lon", "f4", ("lon",))
    v[:] = np.linspace(0.0, 2.0, 5)
    v = f.createVariable("temp", "f8", ("time", "lat", "lon"))
    data = np.arange(60, dtype=np.float64).reshape(3, 4, 5)
    v[:] = data
    v.units = "degC"
    f.close()

    ds = open_netcdf_dataset(path)
    assert ds["temp"].dims == ("time", "lat", "lon")
    np.testing.assert_array_equal(np.asarray(ds["temp"]), data)
    np.testing.assert_array_equal(np.asarray(ds["time"]), np.array([0, 60, 120], "timedelta64[s]"))
    assert ds["temp"].attrs["units"] == "degC"


def test_non_netcdf_file_rejected(tmp_path):
    p = tmp_path / "not_nc.bin"
    p.write_bytes(b"garbage!")
    with pytest.raises(ValueError, match="not a NetCDF file"):
        open_netcdf_dataset(str(p))


def test_interpolation_fixture_reads(tmp_path):
    """A fixture laid out as the reference's interpolation test data (random
    U/V/W over time, depth, lat and lon; written here with scipy) opens
    through this path to the values written, as through parcels_tpu.io."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(0)
    shape = (2, 3, 4, 5)
    path = str(tmp_path / "interpolation_data_random.nc")
    f = netcdf_file(path, "w")
    for dim, n in zip(("time", "depth", "lat", "lon"), shape):
        f.createDimension(dim, n)
        f.createVariable(dim, "f8", (dim,))[:] = np.arange(n, dtype=np.float64)
    want = {}
    for name in ("U", "V", "W"):
        want[name] = rng.standard_normal(shape).astype(np.float32)
        f.createVariable(name, "f4", ("time", "depth", "lat", "lon"))[:] = want[name]
    f.close()

    ds = open_netcdf_dataset(path)
    assert {"U", "V", "W"} <= (set(ds.data_vars) | set(ds.coords))
    for name, values in want.items():
        np.testing.assert_array_equal(np.asarray(ds[name]), values)
    _assert_same_values(ds, jio.open_netcdf_dataset(path))


# -- the two packages' files, read by each other ---------------------------------


def _assert_same_values(a, b):
    """Equal values and types; a classic file's big-endian data may come
    back in either byte order."""
    assert set(a.data_vars) == set(b.data_vars) and set(a.coords) == set(b.coords)
    for name in list(a.data_vars) + list(a.coords):
        va, vb = np.asarray(a[name].values), np.asarray(b[name].values)
        assert va.dtype.newbyteorder("=") == vb.dtype.newbyteorder("="), name
        np.testing.assert_array_equal(va, vb, err_msg=name)
        assert tuple(a[name].dims) == tuple(b[name].dims), name


def test_port_reads_the_jax_writers_file(tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "jax.nc")
    jio.write_netcdf_dataset(j_eddy(), path)
    _assert_same_values(open_netcdf_dataset(path), jio.open_netcdf_dataset(path))


def test_jax_reads_the_ports_file(eddy_nc):
    _assert_same_values(jio.open_netcdf_dataset(eddy_nc), open_netcdf_dataset(eddy_nc))


def test_without_h5py_classic_works_and_hdf5_names_h5py(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    hdf5 = str(tmp_path / "eddy4.nc")
    write_netcdf_dataset(moving_eddy_dataset(), hdf5)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import raises ImportError
    with pytest.raises(ImportError, match="h5py"):
        open_netcdf_dataset(hdf5)
    with pytest.raises(ImportError, match="h5py"):
        write_netcdf_dataset(moving_eddy_dataset(), str(tmp_path / "again.nc"))
    classic = str(tmp_path / "eddy3.nc")
    write_netcdf_dataset(moving_eddy_dataset(), classic, format="NETCDF3_CLASSIC")
    np.testing.assert_array_equal(open_netcdf_dataset(classic)["U"].values[5:9],
                                  np.asarray(moving_eddy_dataset()["U"].values)[5:9])

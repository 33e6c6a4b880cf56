"""Zarr ingestion in the port against parcels_tpu.io.

Mirrors tests/test_zarrstore.py through ``parcels_tpu_torch.io``, whose
reader decodes chunk files with numpy. Then: the port reads a store the JAX
writer wrote (blosc, through tensorstore here) to the same bytes as
``parcels_tpu.io``; the JAX reader reads the port's uncompressed and zlib
stores to the same bytes; a zarr v3 store with bytes + gzip reads; an
unknown codec raises an ``ImportError`` naming it when tensorstore cannot
be imported; a window read touches only the window's chunk files.
Trajectories are held at the tolerance of tests/test_zarrstore.py (rtol
1e-6, atol 1e-3 m); values read back must be equal.
"""

import gzip
import json
import os
import sys

import numpy as np
import pytest

import parcels_tpu.io as jio
import parcels_tpu_torch as tp
from parcels_tpu.datasets import moving_eddy_dataset as j_eddy
from parcels_tpu_torch.datasets import moving_eddy_dataset
from parcels_tpu_torch.io import LazyZarrArray, open_raw_zarr, open_zarr_dataset, write_zarr_dataset


@pytest.fixture(scope="module")
def eddy_zarr(tmp_path_factory):
    path = tmp_path_factory.mktemp("zarr") / "eddy.zarr"
    write_zarr_dataset(moving_eddy_dataset(), path)
    return str(path)


def test_roundtrip_values_and_time_decode(eddy_zarr):
    src = moving_eddy_dataset()
    ds = open_zarr_dataset(eddy_zarr)
    assert set(ds.data_vars) >= {"U", "V"}
    # lazy data vars, eager coords
    assert getattr(ds["U"].values, "_parcels_lazy", False)
    np.testing.assert_array_equal(np.asarray(ds["lon"]), np.asarray(src["lon"]))
    t_src = np.asarray(src["time"].values).astype("timedelta64[s]")
    t_rt = np.asarray(ds["time"].values).astype("timedelta64[s]")
    np.testing.assert_array_equal(t_rt, t_src)
    assert ds["U"].attrs.get("units") == src["U"].attrs.get("units")
    np.testing.assert_array_equal(np.asarray(ds["U"]), np.asarray(src["U"].values))


def test_lazy_window_reads_only_window(eddy_zarr):
    lazy = open_zarr_dataset(eddy_zarr)["U"].values
    win = lazy[3:7]
    assert isinstance(win, np.ndarray)
    assert win.shape[0] == 4
    src = np.asarray(moving_eddy_dataset()["U"].values)
    np.testing.assert_array_equal(win, src[3:7])
    assert lazy.shape[0] == src.shape[0]


def test_lazy_time_axis_only_indexing(eddy_zarr):
    lazy = open_zarr_dataset(eddy_zarr)["U"].values
    with pytest.raises(IndexError):
        lazy[0, 1]
    np.testing.assert_array_equal(lazy[2], np.asarray(moving_eddy_dataset()["U"].values)[2])


def test_fieldset_from_zarr_matches_memory(eddy_zarr):
    """End-to-end: disk-backed windowed run == in-memory run, small reads."""
    fs_mem = tp.FieldSet.from_sgrid_conventions(moving_eddy_dataset(), mesh="flat", device="cpu")
    fs_zarr = tp.FieldSet.from_sgrid_conventions(open_zarr_dataset(eddy_zarr), mesh="flat",
                                                 device="cpu")
    fs_zarr.set_time_window(16)

    def run(fs):
        pset = tp.ParticleSet(fs, x=[12000.0, 15000.0], y=[12500.0, 9000.0], t=[0.0, 0.0])
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(6, "h"))
        return np.stack([pset.x, pset.y])

    np.testing.assert_allclose(run(fs_zarr), run(fs_mem), rtol=1e-6, atol=1e-3)
    stats = fs_zarr.window_stats
    assert stats["loads"] >= 2
    assert isinstance(fs_zarr.fields["U"].data, LazyZarrArray)
    # U on disk is (420, 1, 2, 2) f32: each load reads at most one window
    assert stats["bytes_read"] <= stats["loads"] * 16 * 1 * 2 * 2 * 4


def test_nan_fill_applied_per_window(tmp_path):
    ds = moving_eddy_dataset()
    u = np.asarray(ds["U"].values).copy()
    u[5] = np.nan
    ds["U"].values[...] = u
    path = str(tmp_path / "nan.zarr")
    write_zarr_dataset(ds, path)
    fs = tp.FieldSet.from_sgrid_conventions(open_zarr_dataset(path), mesh="flat", device="cpu")
    window = fs.fields["U"].data[4:7]
    assert np.all(np.isfinite(window))
    assert np.all(window[1] == 0.0)


# -- the two packages' stores, read by each other --------------------------------


def _assert_same_dataset(a, b):
    assert set(a.data_vars) == set(b.data_vars) and set(a.coords) == set(b.coords)
    for name in list(a.data_vars) + list(a.coords):
        va, vb = np.asarray(a[name].values), np.asarray(b[name].values)
        assert va.dtype == vb.dtype and va.shape == vb.shape, name
        assert va.tobytes() == vb.tobytes(), name
        assert tuple(a[name].dims) == tuple(b[name].dims), name
        assert a[name].attrs == b[name].attrs, name
    assert a.attrs == b.attrs


def test_port_reads_the_jax_writers_store(tmp_path):
    path = str(tmp_path / "jax.zarr")
    jio.write_zarr_dataset(j_eddy(), path)
    with open(os.path.join(path, "U", ".zarray")) as fh:
        assert json.load(fh)["compressor"]["id"] == "blosc"
    _assert_same_dataset(open_zarr_dataset(path), jio.open_zarr_dataset(path))


@pytest.mark.parametrize("compressor", [None, "zlib"])
def test_jax_reads_the_ports_store(tmp_path, compressor):
    path = str(tmp_path / f"port_{compressor}.zarr")
    write_zarr_dataset(moving_eddy_dataset(), path, compressor=compressor)
    _assert_same_dataset(jio.open_zarr_dataset(path), open_zarr_dataset(path))
    assert open_raw_zarr(path)["U"].values.shape == (420, 1, 2, 2)


def test_zarr_v3_bytes_gzip(tmp_path):
    """A v3 array (bytes + gzip, default chunk keys, a missing chunk) reads
    as zarr's rules say, through numpy alone."""
    path = tmp_path / "v3.zarr"
    (path / "T").mkdir(parents=True)
    (path / "zarr.json").write_text(json.dumps({"zarr_format": 3, "node_type": "group",
                                                "attributes": {"title": "v3"}}))
    data = np.arange(4 * 3 * 5, dtype=">f8").reshape(4, 3, 5)
    meta = {
        "zarr_format": 3, "node_type": "array", "shape": [4, 3, 5], "data_type": "float64",
        "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [3, 3, 5]}},
        "chunk_key_encoding": {"name": "default", "configuration": {"separator": "/"}},
        "fill_value": "NaN", "dimension_names": ["time", "y", "x"],
        "codecs": [{"name": "bytes", "configuration": {"endian": "big"}},
                   {"name": "gzip", "configuration": {"level": 1}}],
    }
    (path / "T" / "zarr.json").write_text(json.dumps(meta))
    (path / "T" / "c" / "0" / "0").mkdir(parents=True)
    (path / "T" / "c" / "0" / "0" / "0").write_bytes(gzip.compress(data[:3].tobytes()))
    ds = open_zarr_dataset(str(path))  # chunk c/1/0/0 (level 3) is missing
    assert ds.attrs == {"title": "v3"} and ds["T"].dims == ("time", "y", "x")
    lazy = ds["T"].values
    assert lazy.dtype == np.float64
    np.testing.assert_array_equal(lazy[0:3], data[:3])
    assert np.isnan(lazy[3]).all()
    out = np.empty((2, 1, 3, 5), np.float32)  # TZYX-normalized window, cast on the way
    lazy.with_tzyx((0, 1, 2), (4, 1, 3, 5), 0).read_window(1, 3, out)
    np.testing.assert_array_equal(out[:, 0], data[1:3].astype(np.float32))


def test_unknown_codec_without_tensorstore_names_it(tmp_path, monkeypatch):
    path = str(tmp_path / "blosc.zarr")
    jio.write_zarr_dataset(j_eddy(), path)
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import raises ImportError
    with pytest.raises(ImportError, match="blosc"):
        open_zarr_dataset(path)


def test_window_read_touches_only_its_chunk_files(tmp_path):
    """Every U chunk outside levels 3-6 is cut to 3 bytes: reading the
    window still works, reading anything else fails."""
    path = tmp_path / "cut.zarr"
    write_zarr_dataset(moving_eddy_dataset(), path)
    for level in range(420):
        if not 3 <= level < 7:
            (path / "U" / f"{level}.0.0.0").write_bytes(b"cut")
    lazy = open_zarr_dataset(str(path))["U"].values
    src = np.asarray(moving_eddy_dataset()["U"].values)
    out = np.empty((4,) + src.shape[1:], np.float32)
    lazy.read_window(3, 7, out)
    np.testing.assert_array_equal(out, src[3:7])
    with pytest.raises(ValueError, match="shorter"):
        lazy[7]


def test_large_disk_backed_field_needs_a_window(eddy_zarr, monkeypatch):
    """device_arrays refuses to materialise a disk-backed field over 4 GiB
    (the JAX package's guard); a time window streams it instead."""
    fs = tp.FieldSet.from_sgrid_conventions(open_zarr_dataset(eddy_zarr), mesh="flat", device="cpu")
    monkeypatch.setattr(LazyZarrArray, "nbytes", property(lambda self: (4 << 30) + 1))
    with pytest.raises(ValueError, match="set_time_window"):
        fs.device_arrays()
    fs.set_time_window(4)
    assert fs.windowed_arrays(0.0, 60.0)["fields"]["U"].shape == (4, 1, 2, 2)

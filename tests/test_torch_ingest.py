"""Ingest of broadcast (zero-stride) field data: the port keeps such a field a
view on the host up to its device copy, as parcels_tpu keeps it a view
(``_fillna``), and samples it as parcels_tpu does.
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import xrlite as jxr
from parcels_tpu._core.fieldset import _fillna as j_fillna
from parcels_tpu.datasets.structured import _coords_2d as j_coords, _wrap_sgrid as j_wrap
from parcels_tpu_torch import xrlite as txr
from parcels_tpu_torch._core import fieldset as tfieldset
from parcels_tpu_torch.convert import nemo_to_sgrid
from parcels_tpu_torch.datasets import moi_like_inputs
from parcels_tpu_torch.datasets.structured import _coords_2d as t_coords, _wrap_sgrid as t_wrap

torch.set_num_threads(1)

SHAPE = (2, 3, 24, 40)


def _zero_strides(a) -> bool:
    return all(s == 0 for s in a.strides)


def test_zero_data_moi_field_stays_zero_stride_to_the_device_copy(monkeypatch):
    fields, coords = moi_like_inputs(xdim=64, ydim=48, zdim=5, tdim=2, zero_data=True)
    assert _zero_strides(fields["vozocrtx"].values)
    fs = tp.FieldSet.from_sgrid_conventions(nemo_to_sgrid(fields=fields, coords=coords),
                                            device="cpu")
    seen = []
    copy = tfieldset._device_copy
    monkeypatch.setattr(tfieldset, "_device_copy",
                        lambda data, device: seen.append(data.strides) or copy(data, device))
    farrays = fs.device_arrays()
    for name in ("U", "V"):
        assert _zero_strides(fs.fields[name].data), name
        dev = farrays["fields"][name]
        assert dev.is_contiguous() and tuple(dev.shape) == fs.fields[name].data.shape
        assert dev.dtype == torch.float32 and not bool(dev.any())
    assert seen.count((0, 0, 0, 0)) == 2
    # the device copy is dense memory: writing one element changes only it
    farrays["fields"]["U"][0, 0, 0, 0] = 1.0
    assert float(farrays["fields"]["U"].sum()) == 1.0


@pytest.mark.parametrize("value", [np.nan, 0.25, -3.0])
def test_fillna_matches_reference_and_keeps_broadcasts(value):
    arr = np.broadcast_to(np.float32(value), SHAPE)
    got, ref = tfieldset._fillna(arr, -7.5), j_fillna(arr, -7.5)
    assert _zero_strides(got)
    np.testing.assert_array_equal(got, ref)
    assert float(got[0, 0, 0, 0]) == (-7.5 if np.isnan(value) else value)


def test_fillna_fills_dense_arrays_like_reference():
    rng = np.random.default_rng(0)
    arr = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    arr[rng.uniform(size=SHAPE) < 0.1] = np.nan
    np.testing.assert_array_equal(tfieldset._fillna(arr, 2.0), j_fillna(arr, 2.0))


def _broadcast_dataset(pkg, u, v):
    """A flat rectilinear dataset whose U and V are zero-stride broadcasts."""
    xr, coords, wrap = (jxr, j_coords, j_wrap) if pkg == "jax" else (txr, t_coords, t_wrap)
    T, Z, Y, X = SHAPE
    lon = np.linspace(0.0, 1000.0 * (X - 1), X)
    lat = np.linspace(0.0, 1000.0 * (Y - 1), Y)
    taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s") for i in range(T)])
    dims = ["time", "depth", "YG", "XG"]
    data = {"U": (dims, np.broadcast_to(np.float32(u), SHAPE)),
            "V": (dims, np.broadcast_to(np.float32(v), SHAPE))}
    ds = xr.Dataset(data, coords=coords(lon, lat, time=taxis, depth=np.linspace(0.0, 20.0, Z),
                                        mesh="flat"))
    return wrap(ds, X, Y)


def test_broadcast_fields_advect_like_reference():
    """U a broadcast of 0.2 m/s, V a broadcast of NaN (filled with 0): both
    packages move every particle 0.2 m/s east."""
    tfs = tp.FieldSet.from_sgrid_conventions(_broadcast_dataset("torch", 0.2, np.nan), mesh="flat",
                                             device="cpu")
    jfs = jp.FieldSet.from_sgrid_conventions(_broadcast_dataset("jax", 0.2, np.nan), mesh="flat")
    assert _zero_strides(tfs.fields["U"].data) and _zero_strides(tfs.fields["V"].data)
    rng = np.random.default_rng(3)
    n = 64
    seeds = dict(x=rng.uniform(2e3, 2e4, n), y=rng.uniform(2e3, 2e4, n), z=rng.uniform(2, 18, n),
                 t=np.zeros(n))
    out = {}
    for mod, fs in ((tp, tfs), (jp, jfs)):
        pset = mod.ParticleSet(fs, **seeds)
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(300, "s"), runtime=np.timedelta64(1, "h"))
        out[mod] = pset
    np.testing.assert_allclose(out[tp].x, out[jp].x, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(out[tp].y, out[jp].y, rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(out[tp].state, out[jp].state)
    np.testing.assert_allclose(out[tp].x, seeds["x"] + 0.2 * 3600, rtol=1e-5)
    np.testing.assert_allclose(out[tp].y, seeds["y"], rtol=1e-6)

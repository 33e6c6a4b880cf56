"""The port's converters and model-convention datasets against parcels_tpu.

Every converter's output dataset is compared with the JAX package's on the
same inputs (``tests/test_convert.py``'s and the circulation-model mimics):
coordinates, data, attrs and the SGRID/UGRID metadata, exactly (the same
host code). Then one short run of each new converter's output goes through
both packages, held to its closed form at the reference test's tolerance
and to the JAX package's trajectory at rtol 1e-5 with equal states.
"""

import warnings

import numpy as np
import pytest

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import _sgrid as jsgrid
from parcels_tpu import convert as jconvert
from parcels_tpu import xrlite as jxr
from parcels_tpu.datasets import circulation_models as jcm
from parcels_tpu.datasets import remote as jremote
from parcels_tpu.datasets import unstructured as jun
from parcels_tpu_torch import _sgrid as tsgrid
from parcels_tpu_torch import convert as tconvert
from parcels_tpu_torch import xrlite as txr
from parcels_tpu_torch.datasets import circulation_models as tcm
from parcels_tpu_torch.datasets import remote as tremote
from parcels_tpu_torch.datasets import unstructured as tun

SIDE = {jp: (jconvert, jcm, jxr, jsgrid), tp: (tconvert, tcm, txr, tsgrid)}


def assert_same_dataset(t, j):
    """Same variables, dims, values, attrs and grid metadata."""
    assert sorted(t.data_vars) == sorted(j.data_vars)
    assert sorted(t.coords) == sorted(j.coords)
    assert dict(t.sizes) == dict(j.sizes)
    for name in list(j.data_vars) + list(j.coords):
        a, b = t[name], j[name]
        assert tuple(a.dims) == tuple(b.dims), name
        assert a.attrs == b.attrs, name
        va, vb = np.asarray(a.values), np.asarray(b.values)
        assert va.dtype == vb.dtype, name
        np.testing.assert_array_equal(va, vb, err_msg=name)
    if "grid" in j.data_vars:
        assert repr(tsgrid.parse_sgrid_metadata(t)) == repr(jsgrid.parse_sgrid_metadata(j))


def _time_axis(n=2):
    return np.array([np.datetime64("2000-01-01") + np.timedelta64(i, "D") for i in range(n)])


def _w_inputs(mod):
    xr = SIDE[mod][2]
    shp = (2, 3, 4, 4)
    dims = ("time", "depth", "latitude", "longitude")
    fields = {"U": xr.DataArray(np.ones(shp, np.float32), dims=dims),
              "V": xr.DataArray(np.zeros(shp, np.float32), dims=dims),
              "W": xr.DataArray(np.full(shp, 2.0, np.float32), dims=dims)}
    coords = xr.Dataset(coords={"time": (("time",), _time_axis()),
                                "depth": (("depth",), np.linspace(0, 10, 3)),
                                "latitude": (("latitude",), np.linspace(0, 3, 4)),
                                "longitude": (("longitude",), np.linspace(0, 3, 4))})
    return fields, coords


def _surface_inputs(mod):
    xr = SIDE[mod][2]
    dims = ("time", "latitude", "longitude")
    fields = {"U": xr.DataArray(np.full((2, 5, 6), 0.5, np.float32), dims=dims, name="U"),
              "V": xr.DataArray(np.zeros((2, 5, 6), np.float32), dims=dims, name="V")}
    coords = xr.Dataset(coords={"time": (("time",), _time_axis()),
                                "latitude": (("latitude",), np.linspace(0, 4, 5), {"units": "m"}),
                                "longitude": (("longitude",), np.linspace(0, 5, 6), {"units": "m"})})
    return fields, coords


def _registry_uv(mod, key, u, v, std=False):
    xr = SIDE[mod][2]
    raw = SIDE[mod][1].datasets[key]
    fu, fv = raw[u], raw[v]
    if std:  # tests/test_convert.py's ERA5 input: velocity standard names added
        fu = xr.DataArray(fu.values, fu.dims, {**fu.attrs,
                          "standard_name": "eastward_sea_water_velocity"}, name=u)
        fv = xr.DataArray(fv.values, fv.dims, {**fv.attrs,
                          "standard_name": "northward_sea_water_velocity"}, name=v)
    return {u: fu, v: fv}, xr.Dataset(coords=dict(raw.coords))


CONVERSIONS = {
    "nemo_style": ("nemo_to_sgrid", lambda mod: SIDE[mod][1].nemo_style()),
    "mitgcm_style": ("mitgcm_to_sgrid", lambda mod: SIDE[mod][1].mitgcm_style()),
    "croco_style": ("croco_to_sgrid", lambda mod: SIDE[mod][1].croco_style()),
    "copernicusmarine_style": ("copernicusmarine_to_sgrid",
                               lambda mod: SIDE[mod][1].copernicusmarine_style()),
    "delft3d_style": ("delft3d_to_sgrid", lambda mod: SIDE[mod][1].delft3d_style()),
    "copernicus_uo_vo": ("copernicusmarine_to_sgrid",
                         lambda mod: _registry_uv(mod, "ds_copernicusmarine", "uo", "vo")),
    "copernicus_stokes": ("copernicusmarine_to_sgrid",
                          lambda mod: _registry_uv(mod, "ds_copernicusmarine_waves", "VSDX", "VSDY")),
    "hycom_espc": ("copernicusmarine_to_sgrid",
                   lambda mod: _registry_uv(mod, "ds_hycom_espc", "water_u", "water_v")),
    "era5_surface": ("copernicusmarine_to_sgrid",
                     lambda mod: _registry_uv(mod, "ds_ERA5_wind", "u10", "v10", std=True)),
    "copernicus_w_negated": ("copernicusmarine_to_sgrid", _w_inputs),
    "copernicus_surface_depth": ("copernicusmarine_to_sgrid", _surface_inputs),
}


@pytest.mark.parametrize("case", sorted(CONVERSIONS))
def test_structured_converters_equal_reference(case):
    conv, inputs = CONVERSIONS[case]
    out = []
    for mod in (jp, tp):
        fields, coords = inputs(mod)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out.append(getattr(SIDE[mod][0], conv)(fields=fields, coords=coords))
        experimental = [w for w in rec if "experimental" in str(w.message)]
        assert bool(experimental) == (conv == "delft3d_to_sgrid")
    assert_same_dataset(out[1], out[0])
    if case == "copernicus_w_negated":
        np.testing.assert_array_equal(np.asarray(out[1]["W"].values), -2.0)
    if case == "copernicus_surface_depth":
        assert "depth" in out[1].dims


@pytest.mark.parametrize("model", ["fesom", "icon"])
def test_unstructured_converters_equal_reference(model):
    out = []
    for un, conv in ((jun, jconvert), (tun, tconvert)):
        if model == "fesom":
            out.append(conv.fesom_to_ugrid(un.fesom2_style_dataset("data")))
        else:
            ds = un.delaunay_flow_dataset(nx=6, ny=6).rename({"zf": "depth_2", "zc": "depth"})
            out.append(conv.icon_to_ugrid(ds))
    assert_same_dataset(out[1], out[0])


def test_copernicus_ambiguity_raises_like_reference():
    for mod in (jp, tp):
        cm, xr = SIDE[mod][1], SIDE[mod][2]
        raw = cm._copernicusmarine_ds()
        dup = xr.DataArray(raw["uo"].values, raw["uo"].dims, dict(raw["uo"].attrs), name="uo2")
        with pytest.raises(ValueError, match="Ambiguous"):
            SIDE[mod][0].copernicusmarine_to_sgrid(
                fields={"uo": raw["uo"], "vo": raw["vo"], "uo2": dup},
                coords=xr.Dataset(coords=dict(raw.coords)))


def test_circulation_model_registry_equals_reference():
    assert sorted(tcm.datasets) == sorted(jcm.datasets)
    for key in jcm.datasets:
        assert_same_dataset(tcm.datasets[key], jcm.datasets[key])
    assert tcm.__all__ == jcm.__all__


def _mitgcm_uniform(mod):
    cm = SIDE[mod][1]
    fields, coords = cm.mitgcm_style()  # Zl decreasing: the converter flips it
    return SIDE[mod][0].mitgcm_to_sgrid(fields=fields, coords=coords)


def _copernicus_uniform(mod):
    fields, coords = SIDE[mod][1].copernicusmarine_style()
    return SIDE[mod][0].copernicusmarine_to_sgrid(fields=fields, coords=coords)


def _delft3d_uniform(mod):
    fields, coords = SIDE[mod][1].delft3d_style(n=20, extent=9000.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return SIDE[mod][0].delft3d_to_sgrid(fields=fields, coords=coords)


RUNS = {
    # dataset maker, release, closed-form x after 1 h, its reference tolerance
    "mitgcm": (_mitgcm_uniform, dict(x=[1000.0, 2000.0], y=[5000.0, 3000.0], z=[10.0, 40.0]), 3600.0,
               1e-4),
    "copernicusmarine": (_copernicus_uniform, dict(x=[500.0, 1500.0], y=[5000.0, 2000.0]), 3600.0,
                         1e-5),
    "delft3d": (_delft3d_uniform, dict(x=[500.0, 1500.0], y=[5000.0, 2000.0]), 3600.0, 1e-4),
}


@pytest.mark.parametrize("model", sorted(RUNS))
def test_new_converters_run_like_reference(model):
    """Uniform 1 m/s zonal flow through each new converter and FieldSet:
    x moves 3600 m in an hour, in both packages."""
    build, release, shift, rtol = RUNS[model]
    out = {}
    for mod in (jp, tp):
        kw = {} if mod is jp else {"device": "cpu"}
        fs = mod.FieldSet.from_sgrid_conventions(build(mod), mesh="flat", **kw)
        n = len(release["x"])
        pset = mod.ParticleSet(fs, t=np.zeros(n), **release)
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"))
        out[mod] = [np.asarray(getattr(pset, v)) for v in ("x", "y", "state")]
    np.testing.assert_allclose(out[tp][0], np.asarray(release["x"]) + shift, rtol=rtol)
    np.testing.assert_allclose(out[tp][1], release["y"], atol=1e-3)
    for a, b in zip(out[tp][:2], out[jp][:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_array_equal(out[tp][2], out[jp][2])


def _mitgcm_staggered(mod, seed=5):
    """``mitgcm_style``'s names staggered as MITgcm writes a C-grid: U on
    (Zl, YC, XG), V on (Zl, YG, XC), seeded random velocities."""
    cm, xr = SIDE[mod][1], SIDE[mod][2]
    fields, coords = cm.mitgcm_style(nx=12, ny=10, nz=4, extent=11000.0)
    c = {k: coords[k] for k in coords.coords}
    for centre, corner in (("XC", "XG"), ("YC", "YG")):
        g = np.asarray(coords[corner].values)
        c[centre] = ((centre,), g + 0.5 * (g[1] - g[0]), {"units": "m"})
    rng = np.random.default_rng(seed)
    dims = {"U": ("time", "Zl", "YC", "XG"), "V": ("time", "Zl", "YG", "XC")}
    staggered = {k: xr.DataArray(rng.uniform(-0.3, 0.3, fields[k].values.shape).astype(np.float32),
                                 d, dict(fields[k].attrs), name=k) for k, d in dims.items()}
    return SIDE[mod][0].mitgcm_to_sgrid(fields=staggered, coords=xr.Dataset(coords=c))


def test_mitgcm_staggered_cgrid_runs_like_reference():
    """The MITgcm converter on a staggered C-grid layout: the same dataset
    in both packages, a ``CGrid_Velocity`` field set, and a short run of
    random flow equal to the JAX package's at rtol 1e-5 with equal states."""
    assert_same_dataset(_mitgcm_staggered(tp), _mitgcm_staggered(jp))
    rng = np.random.default_rng(6)
    release = dict(x=rng.uniform(3000, 8000, 32), y=rng.uniform(3000, 6000, 32),
                   z=rng.uniform(10, 90, 32), t=np.zeros(32))
    out = {}
    for mod in (jp, tp):
        kw = {} if mod is jp else {"device": "cpu"}
        fs = mod.FieldSet.from_sgrid_conventions(_mitgcm_staggered(mod), mesh="flat", **kw)
        assert type(fs.UV.interp_method).__name__ == "CGrid_Velocity"
        pset = mod.ParticleSet(fs, **release)
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"))
        out[mod] = [np.asarray(getattr(pset, v)) for v in ("x", "y", "state")]
    for a, b in zip(out[tp][:2], out[jp][:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_array_equal(out[tp][2], out[jp][2])
    assert not np.allclose(out[tp][0], release["x"])


def test_copernicus_native_names_run_like_reference():
    """The native uo/vo product (random velocities, spherical) through the
    converter's standard-name discovery and a short run in both packages."""
    out = {}
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-9, -1, 64), rng.uniform(31, 39, 64)
    for mod in (jp, tp):
        fields, coords = _registry_uv(mod, "ds_copernicusmarine", "uo", "vo")
        ds = SIDE[mod][0].copernicusmarine_to_sgrid(fields=fields, coords=coords)
        kw = {} if mod is jp else {"device": "cpu"}
        fs = mod.FieldSet.from_sgrid_conventions(ds, **kw)
        pset = mod.ParticleSet(fs, x=x, y=y, z=np.full(64, 1.0), t=np.zeros(64))
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(15, "m"), runtime=np.timedelta64(6, "h"))
        out[mod] = [np.asarray(getattr(pset, v)) for v in ("x", "y", "state")]
    for a, b in zip(out[tp][:2], out[jp][:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_array_equal(out[tp][2], out[jp][2])


def test_remote_registry_serves_cache_and_generated_tiers(tmp_path, monkeypatch):
    """The port's registry: the reference's names and purposes, a cached
    store opened from PARCELS_DATA_HOME with the port's reader, the
    generated benchmark equivalents equal to the JAX package's, and no
    download tier (an entry with neither raises, naming the cache path)."""
    monkeypatch.setenv("PARCELS_DATA_HOME", str(tmp_path))
    assert tremote.list_remote_datasets() == jremote.list_remote_datasets()
    assert tremote.list_remote_datasets("testing") == jremote.list_remote_datasets("testing")
    with pytest.raises(ValueError, match="purpose"):
        tremote.list_remote_datasets("nope")
    assert not hasattr(tremote, "_try_download")
    for name in ("Benchmarks_MOi_data_metadata-only/U", "Benchmarks_MOi_data_metadata-only/W",
                 "Benchmarks_MOi_data_metadata-only/mesh"):
        with pytest.warns(UserWarning, match="local equivalent"):
            t = tremote.open_remote_dataset(name)
        with pytest.warns(UserWarning, match="local equivalent"):
            j = jremote.open_remote_dataset(name)
        assert_same_dataset(t, j)
    with pytest.raises(RuntimeError, match=str(tmp_path)):
        tremote.open_remote_dataset("SCHISM_LakeOntario/out2d")
    with pytest.raises(ValueError, match="Unknown remote dataset"):
        tremote.open_remote_dataset("bogus/entry")
    from parcels_tpu_torch.datasets import moving_eddy_dataset
    from parcels_tpu_torch.io import write_zarr_dataset

    store = tmp_path / "CROCOidealized_data" / "data.zarr"
    store.parent.mkdir()
    write_zarr_dataset(moving_eddy_dataset(), str(store))
    got = tremote.open_remote_dataset("CROCOidealized_data/data")
    np.testing.assert_array_equal(np.asarray(got["U"].values), moving_eddy_dataset()["U"].values)

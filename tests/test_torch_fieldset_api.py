"""The rest of the port's single-card FieldSet/XGrid API against parcels_tpu.

Same seeded inputs through both packages (the port on the CPU): ``FieldSet +
FieldSet`` (shared tensors, collisions, devices), ``memory_report`` (field
and grid entries equal the JAX report's; the total equals the bytes of the
tensors the port holds during a chunk), the sectioned reprs and
``describe``, ``XGrid.get_axis_dim_mapping``/``localize``, the construction
checks of ``tests/test_fieldset.py`` and the sampled values of
``tests/test_interpolation.py``.

Tolerances: the ramp samples at rtol 1e-6 (the same f32 multilinear
arithmetic); ``localize`` bit for bit (the same float64 host code).
"""

import io

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import xrlite as jxr
from parcels_tpu.datasets import delaunay_flow_dataset as j_delaunay
from parcels_tpu.datasets import generic_datasets as j_generic
from parcels_tpu.datasets import moi_like_fieldset as j_moi
from parcels_tpu.datasets import moving_eddy_dataset as j_eddy
from parcels_tpu.datasets import padded_variant_dataset as j_padded
from parcels_tpu.datasets import simple_UV_dataset as j_simple
from parcels_tpu.datasets.structured import _coords_2d as j_coords
from parcels_tpu.datasets.structured import _wrap_sgrid as j_wrap
from parcels_tpu_torch import xrlite as txr
from parcels_tpu_torch.datasets import delaunay_flow_dataset as t_delaunay
from parcels_tpu_torch.datasets import generic_datasets as t_generic
from parcels_tpu_torch.datasets import moi_like_fieldset as t_moi
from parcels_tpu_torch.datasets import moving_eddy_dataset as t_eddy
from parcels_tpu_torch.datasets import padded_variant_dataset as t_padded
from parcels_tpu_torch.datasets import simple_UV_dataset as t_simple
from parcels_tpu_torch.datasets.structured import _coords_2d as t_coords
from parcels_tpu_torch.datasets.structured import _wrap_sgrid as t_wrap
from parcels_tpu_torch.ops import stagecache

BOTH = (jp, tp)


def _kw(mod):
    return {} if mod is jp else {"device": "cpu"}


def _sgrid(mod, ds, **kw):
    return mod.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw, **_kw(mod))


def _simple(mod, dims=(2, 2, 8, 8)):
    return (j_simple if mod is jp else t_simple)(dims=dims, mesh="flat")


# -- FieldSet + FieldSet ------------------------------------------------------

@pytest.mark.parametrize("mod", BOTH, ids=["jax", "port"])
def test_add_combines_fields_and_context(mod):
    """The JAX test's inputs (tests/test_misc.py): fields and context of both
    sources, sources unharmed, collisions raise; values equal across the
    packages."""
    fs1 = _sgrid(mod, (j_eddy if mod is jp else t_eddy)())
    fs2 = mod.FieldSet(**_kw(mod))
    fs2.add_constant_field("Kh", 10.0, mesh="flat")
    fs2.add_context("dres", 0.01)
    fs1.add_context("alpha", 2.0)
    fs = fs1 + fs2
    assert set(fs.fields) >= {"U", "V", "UV", "Kh"}
    assert fs.dres == 0.01 and fs.alpha == 2.0
    assert np.asarray(fs.Kh.eval(0.0, 0.0, 0.0, 0.0))[0] == 10.0
    u = np.asarray(fs.U.eval(0.0, 0.0, 12500.0, 12000.0))
    np.testing.assert_array_equal(u, np.asarray(fs1.U.eval(0.0, 0.0, 12500.0, 12000.0)))
    with pytest.raises(ValueError, match="field names in common"):
        fs1 + fs1
    fs3 = mod.FieldSet(**_kw(mod))
    fs3.add_context("alpha", 1.0)
    with pytest.raises(ValueError, match="context value names in common"):
        fs1 + fs3
    ds2 = _simple(mod)
    merged = _sgrid(mod, _simple(mod), vector_fields={}) + _sgrid(
        mod, ds2.rename({"U": "U2", "V": "V2"}), vector_fields={})
    assert merged.time_interval == merged.U.time_interval


def test_add_shares_tensors_and_refuses_two_devices():
    fs1 = _sgrid(tp, t_eddy())
    tensors = fs1.device_arrays()["fields"]
    fs2 = tp.FieldSet(device="cpu")
    fs2.add_constant_field("Kh", 10.0, mesh="flat")
    fs = fs1 + fs2
    assert fs.device == fs1.device
    for name in ("U", "V"):
        assert fs.device_arrays()["fields"][name] is tensors[name]
    with pytest.raises(ValueError, match="different devices"):
        fs1 + tp.FieldSet(device="meta")


# -- memory_report ------------------------------------------------------------

def _report_case(mod, case):
    if case == "simple":
        return _sgrid(mod, _simple(mod, (4, 3, 40, 50))), {}
    if case == "windowed":
        fs = _sgrid(mod, _simple(mod, (8, 3, 40, 50)))
        fs.set_time_window(2)
        return fs, {}
    moi = j_moi if mod is jp else t_moi
    fs = moi(xdim=96, ydim=64, zdim=4, **_kw(mod))
    return fs, {"bands": 2} if case == "moi_bands" else {}


@pytest.mark.parametrize("case", ["simple", "windowed", "moi", "moi_bands"])
def test_memory_report_entries_match_reference(case):
    """Field entries equal the JAX report's, and so do the grids' coordinate,
    search-table, geometry and raster entries (tests/test_memory_report.py's
    inputs); the analytic report builds no table."""
    jrep = _report_case(jp, case)[0].memory_report(**_report_case(jp, case)[1])
    fs, kw = _report_case(tp, case)
    rep = fs.memory_report(particles=1000, **kw)
    assert rep["fields"] == jrep["fields"]
    for g, jg in zip(rep["grids"], jrep["grids"]):
        for key in ("coords", "pic_table", "cgrid_geom", "lookup"):
            assert g[key] == jg[key], key
    assert getattr(fs.gridset[0], "_pic_table_cache", None) is None
    assert rep["device_bytes"] is None and rep["fits"] is None
    assert fs.memory_report(device_bytes=rep["total"] - 1, **kw)["fits"] is (rep["soa"] > 0)


def _tensor_bytes(obj, out):
    if isinstance(obj, torch.Tensor):
        out[obj.untyped_storage().data_ptr()] = obj.untyped_storage().nbytes()
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensor_bytes(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensor_bytes(v, out)
    return out


@pytest.mark.parametrize("case", ["rect", "cgrid", "ugrid"])
def test_memory_report_total_equals_the_ports_tensors(case):
    """After a run, the report's total equals the bytes of every tensor the
    port holds during a chunk: the device arrays, the tables the engine
    builds before its step loop (the stage cache's fused cell rows, the
    UGRID column and z-row tables) and the padded particle SoA with its
    cache columns."""
    n = 1000
    rng = np.random.default_rng(0)
    if case == "rect":
        fs = _sgrid(tp, t_eddy())
        seeds = dict(x=rng.uniform(11000, 13000, n), y=rng.uniform(12000, 13000, n))
        dt = 300
    elif case == "cgrid":
        fs = t_moi(xdim=96, ydim=64, zdim=4, device="cpu")
        seeds = dict(x=rng.uniform(-30, 30, n), y=rng.uniform(-20, 20, n))
        dt = 1800
    else:
        ds = t_delaunay(flow="rotation", placement="node", vertical="zf", nx=40, ny=40)
        fs = tp.FieldSet.from_ugrid_conventions(ds, mesh="flat", device="cpu")
        seeds = dict(x=rng.uniform(4e4, 6e4, n), y=rng.uniform(4e4, 6e4, n), z=np.full(n, 10.0))
        dt = 120
    pset = tp.ParticleSet(fs, t=np.zeros(n), **seeds)
    opts = tp.EngineOptions(stagecache="force", uxcol="force", uxcache="force")
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(dt, "s"), runtime=np.timedelta64(2 * dt, "s"),
                 options=opts)
    with opts.applied():
        rep = fs.memory_report(particles=n)
        farrays = fs.device_arrays()
        fsview = fs.build_views(farrays)
        stagecache.prebuild_tables(fsview)
    held = _tensor_bytes(farrays, {})
    for v in fsview.fields.values():
        _tensor_bytes(getattr(v, "_cell_table", None), held)
        _tensor_bytes(v._tables, held)
    soa = _tensor_bytes({k: v for k, v in pset._data.items() if k != "_rng"}, {})
    assert rep["soa"] == sum(soa.values())
    assert rep["total"] == sum(held.values()) + sum(soa.values())
    if case == "cgrid":
        assert rep["grids"][0]["cell_table"] > 0
    if case == "ugrid":
        assert rep["grids"][0]["face_table"] > 0 and rep["tables"]


# -- reprs and describe -------------------------------------------------------

def _sections(text):
    """{section: lines} of a format_sections text."""
    out, cur = {}, None
    for ln in text.splitlines()[1:]:
        if ln.startswith("    ") and not ln.startswith("        "):
            cur = ln.strip().rstrip(":")
            out[cur] = []
        else:
            out[cur].append(ln.strip())
    return out


def test_fieldset_and_field_reprs_match_reference(tmp_path):
    """The reference's sections (tests/test_repr.py): fields, vector fields
    and grids equal; the simulation section names the port's device and its
    memory line, which on the CPU has no device limit."""
    fss = {mod: _sgrid(mod, (j_eddy if mod is jp else t_eddy)()) for mod in BOTH}
    texts = {}
    for mod, fs in fss.items():
        buf = io.StringIO()
        fs.describe(buf)
        texts[mod] = buf.getvalue()
        assert texts[mod].rstrip("\n") == repr(fs)
    js, ts = _sections(texts[jp]), _sections(texts[tp])
    for name in ("fields", "vectorfields", "grids"):
        assert ts[name] == js[name]
    assert "device: cpu" in ts["simulation"]
    assert any(ln.startswith("device memory:") and "no device limit" in ln
               for ln in ts["simulation"])
    assert "UV" in fss[tp]._repr_html_()
    for name in ("U", "UV"):
        assert fss[tp].fields[name]._repr_html_() == fss[jp].fields[name]._repr_html_()
        buf = io.StringIO()
        fss[tp].fields[name].describe(buf)
        assert "interp_method" in buf.getvalue()
    assert fss[tp].gridset[0]._repr_html_() == fss[jp].gridset[0]._repr_html_()
    pfs = [mod.ParticleFile(tmp_path / f"{mod.__name__}.parquet", outputdt=np.timedelta64(10, "m"),
                            mode="w") for mod in BOTH]
    assert pfs[0]._repr_html_().replace(jp.__name__, tp.__name__) == pfs[1]._repr_html_()


def test_uxgrid_describe_matches_reference():
    kw = dict(flow="rotation", placement="node", vertical="zf", nx=20, ny=20)
    grids = [jp.FieldSet.from_ugrid_conventions(j_delaunay(**kw), mesh="flat").gridset[0],
             tp.FieldSet.from_ugrid_conventions(t_delaunay(**kw), mesh="flat",
                                                device="cpu").gridset[0]]
    texts = []
    for g in grids:
        buf = io.StringIO()
        g.describe(buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "boundary edges" in grids[1]._repr_html_()


# -- XGrid --------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["left", "right", "inner", "outer"])
def test_localize_and_axis_dim_mapping_match_reference(variant):
    """tests/test_xgrid.py's inputs on every padding layout: a node, an
    interior point and arrays of seeded points, for node- and face-placed
    dims; equal to the JAX package's, bit for bit."""
    grids = {}
    for mod in BOTH:
        ds = (j_padded if mod is jp else t_padded)(variant)
        fs = _sgrid(mod, ds, vector_fields={"UV": ("U_A_grid", "V_A_grid")})
        grids[mod] = fs.gridset[0]
    rng = np.random.default_rng(1)
    points = [(0.0, 0.0, 0.0), (0.0, 3250.0, 2750.0),
              (rng.uniform(0, 20, 16), rng.uniform(0, 5000, 16), rng.uniform(0, 6000, 16))]
    for dims in (("time", "ZG", "YG", "XC"), ("time", "ZG", "YC", "XG"), ("ZC", "YC", "XC")):
        assert grids[tp].get_axis_dim_mapping(dims) == grids[jp].get_axis_dim_mapping(dims)
        for z, y, x in points:
            jpos = grids[jp].search(z, y, x)
            tpos = grids[tp].search(z, y, x, device="cpu")
            jloc = grids[jp].localize(jpos, dims)
            tloc = grids[tp].localize(tpos, dims)
            assert tloc.keys() == jloc.keys()
            for d in jloc:
                np.testing.assert_array_equal(tloc[d][0], np.asarray(jloc[d][0]))
                np.testing.assert_array_equal(tloc[d][1], np.asarray(jloc[d][1]))
            scalar = {ax: (int(np.ravel(p["index"])[0]), float(np.ravel(p["bcoord"])[0]))
                      for ax, p in jpos.items()}
            assert grids[tp].localize(scalar, dims) == grids[jp].localize(scalar, dims)


# -- construction checks (tests/test_fieldset.py) -----------------------------

@pytest.mark.parametrize("vector_fields, match", [
    ({"UV": ("U",)}, "either 2 or 3 components"),
    ({"UV": ("U", "V", "U", "V")}, "either 2 or 3 components"),
    ({"UV": ("U", "NOPE")}, "not in dataset"),
])
def test_invalid_vector_fields_raise_like_reference(vector_fields, match):
    for mod in BOTH:
        with pytest.raises(ValueError, match=match):
            _sgrid(mod, _simple(mod), vector_fields=vector_fields)


def test_construction_checks_match_reference():
    for mod in BOTH:
        fs = _sgrid(mod, _simple(mod))
        assert len(fs.gridset) == 1 and fs.fields["U"].grid is fs.fields["V"].grid
        with pytest.raises(ValueError, match="already has a Field"):
            fs.add_field(fs.fields["U"], name="U")
        fs.add_context("dres", 0.01)
        with pytest.raises(ValueError, match="already has a context"):
            fs.add_context("dres", 0.02)
        ti = fs.time_interval
        fs.add_constant_field("Kh", 10.0, mesh="flat")
        assert fs.time_interval == ti
        with pytest.raises(ValueError, match="mesh"):
            fs.add_constant_field("Kbad", 1.0, mesh="cubed")
        assert "flow" in _sgrid(mod, _simple(mod), vector_fields={"flow": ("U", "V")}).fields
        generic = (j_generic if mod is jp else t_generic)()
        for name, ds in generic.items():
            fsg = _sgrid(mod, ds, vector_fields={"UV": ("U_A_grid", "V_A_grid")})
            assert "UV" in fsg.fields, name


# -- sampled values (tests/test_interpolation.py) -------------------------------

def _ramp(mod, interp=None):
    xr, coords, wrap = (jxr, j_coords, j_wrap) if mod is jp else (txr, t_coords, t_wrap)
    lon, lat, depth = np.linspace(0, 1000, 3), np.linspace(0, 1000, 4), np.linspace(0, 100, 4)
    time = np.array([np.datetime64("2000-01-01") + np.timedelta64(i * 3600, "s")
                     for i in range(4)])
    T, Z, Y, X = np.meshgrid(np.arange(4) * 3600.0, depth, lat, lon, indexing="ij")
    P = (2.0 * T + 3.0 * Z + 5.0 * Y + 7.0 * X).astype(np.float32)
    if interp == "land":
        P[:] = 1.0
        P[..., 0] = 0.0
    ds = xr.Dataset({"P": (["time", "depth", "YG", "XG"], P)},
                    coords=coords(lon, lat, time=time, depth=depth, mesh="flat"))
    fs = _sgrid(mod, wrap(ds, 3, 4))
    if interp == "nearest":
        fs.fields["P"].interp_method = mod.XNearest()
    elif interp == "land":
        fs.fields["P"].interp_method = mod.XLinearInvdistLandTracer()
    fs.add_constant_field("K", 42.0, mesh="flat")
    fs._invalidate_caches()
    return fs


SAMPLES = {
    "ramp": (None, "P", 5000.0, 42.0),
    "time_blend": (None, "P", 1800.0, 0.0),
    "edge_and_oob": (None, "P", 0.0, 100.0),
    "nearest": ("nearest", "P", 0.0, 0.0),
    "land": ("land", "P", 0.0, 0.0),
    "constant": (None, "K", 123.0, 9.0),
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_sampled_values_match_reference(case):
    interp, name, t, z = SAMPLES[case]
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1000, 20), [0.0, 1000.0, 2000.0, -5.0, 400.0]])
    y = np.concatenate([rng.uniform(0, 1000, 20), [0.0, 1000.0, 500.0, 500.0, 100.0]])
    got = [np.asarray(_ramp(mod, interp).fields[name].eval(t, z, y, x)) for mod in BOTH]
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6)
    if case == "ramp":
        np.testing.assert_allclose(got[1][:20], 2 * t + 3 * z + 5 * y[:20] + 7 * x[:20], rtol=1e-5)
    if case == "edge_and_oob":
        assert got[1][22] == 0.0 and got[1][23] == 0.0

"""The port's UGRID mesh, search, face table and host helpers against parcels_tpu.

Each package makes the same dataset with its own dataset function (the
functions are the same code) and ingests it. Face indices and search sentinels must be
identical. Barycentric coordinates are held to rtol 1e-6 with an absolute
floor of 1e-6 (a few f32 ulps of 1): XLA's CPU backend contracts the area
products ``a*b - c*d`` into a fused multiply-add, eager torch does not.

On spherical meshes the port signs each sub-triangle area along the face
normal, where the JAX package takes the unsigned area; the JAX walk then
has no direction and fails or misplaces some interior points
(``test_spherical_search_repair``). There the port's coordinates are held
to the JAX package's at an absolute 2e-5, the f32 rounding of the two
packages' sine and cosine of the query point over the faces' angular size
(about 0.017 rad).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import native as j_native
from parcels_tpu._core.uxgrid import ux_search as j_ux_search
from parcels_tpu.datasets.unstructured import _delaunay_mesh as j_mesh
from parcels_tpu.datasets.unstructured import delaunay_flow_dataset as j_dataset
from parcels_tpu.ops import uxcol as j_uxcol
from parcels_tpu_torch import native as t_native
from parcels_tpu_torch._core import uxgrid as t_uxgrid
from parcels_tpu_torch.datasets.unstructured import _delaunay_mesh as t_mesh
from parcels_tpu_torch.datasets.unstructured import delaunay_flow_dataset as t_dataset
from parcels_tpu_torch.ops import uxcol as t_uxcol

BC_TOL = dict(rtol=1e-6, atol=1e-6)
SPHERE_BC_ATOL = 2e-5


def _pair(mesh="flat", **kw):
    jfs = jp.FieldSet.from_ugrid_conventions(j_dataset(**kw), mesh=mesh)
    tfs = tp.FieldSet.from_ugrid_conventions(t_dataset(**kw), mesh=mesh, device="cpu")
    return jfs, tfs


def _points(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, n).astype(np.float32), rng.uniform(lo, hi, n).astype(np.float32),
            rng)


def test_mesh_tables_match():
    """Lookup raster, adjacency, spec and the fused face table, bit for bit."""
    jfs, tfs = _pair(flow="uniform", placement="face", vertical="zc", nx=18, ny=16)
    jg, tg = jfs.gridset[0], tfs.gridset[0]
    assert isinstance(tg, tp.UxGrid) and isinstance(tg, tp.BaseGrid)
    assert dataclasses.astuple(tg.spec) == dataclasses.astuple(jg.spec)
    np.testing.assert_array_equal(tg._lookup["fi"], jg._lookup["fi"])
    assert tg._lookup["origin"] == jg._lookup["origin"] and tg._lookup["step"] == jg._lookup["step"]
    np.testing.assert_array_equal(tg._adjacency, jg._adjacency)
    nodes = np.stack([jg.node_lon, jg.node_lat], axis=-1).astype(np.float32)
    jt = j_uxcol.build_face_table(nodes, jg.face_node_connectivity, jg._adjacency)
    tt = tg.face_table()
    np.testing.assert_array_equal(tt.view(np.int32), jt.view(np.int32))
    # ids read back exactly through the port's row ops (copies and gathers only)
    n = tg.spec.n_face
    rows = t_uxcol.face_rows(torch.as_tensor(tt), torch.arange(n, dtype=torch.int32))
    np.testing.assert_array_equal(t_uxcol.nids_from_rows(rows).numpy(), tg.face_node_connectivity)
    for k in range(3):
        got = t_uxcol.adj_from_rows(rows, torch.full((n,), k, dtype=torch.int32)).numpy()
        ref = np.asarray(j_uxcol.adj_from_rows(j_uxcol.face_rows(jnp.asarray(jt), jnp.arange(n)),
                                               jnp.full(n, k, jnp.int32)))
        np.testing.assert_array_equal(got, ref)
    assert (tg._adjacency < 0).any()  # the -1 (NaN bit pattern) ids are covered


def test_native_helpers_match_both_fallbacks(monkeypatch):
    """The port's native adjacency and raster equal the JAX package's and the
    numpy fallbacks the port keeps (the inputs of tests/test_native.py)."""
    node_lon, node_lat, conn = t_mesh(25, 25, 1e5, seed=4)
    j_lon, j_lat, j_conn = j_mesh(25, 25, 1e5, seed=4)
    np.testing.assert_array_equal(conn, j_conn)
    assert t_native.get_lib() is not None, "g++ is available here: the native library must build"
    assert str(t_native.BUILD_DIR) in t_native.get_lib()._name

    native_adj = t_native.build_face_adjacency(conn)
    np.testing.assert_array_equal(native_adj, j_native.build_face_adjacency(j_conn))
    native_lookup = t_uxgrid._build_face_lookup(node_lon, node_lat, conn)
    monkeypatch.setattr(t_native, "build_face_adjacency", lambda c: None)
    monkeypatch.setattr(t_native, "rasterize_faces", lambda *a: None)
    np.testing.assert_array_equal(t_uxgrid._build_face_adjacency(conn), native_adj)
    fallback_lookup = t_uxgrid._build_face_lookup(node_lon, node_lat, conn)
    np.testing.assert_array_equal(fallback_lookup["fi"], native_lookup["fi"])

    lat_min, lon_min = node_lat.min() - 1, node_lon.min() - 1
    step_y = (node_lat.max() + 1 - lat_min) / 64
    step_x = (node_lon.max() + 1 - lon_min) / 64
    monkeypatch.undo()
    args = (lat_min, lon_min, step_y, step_x, 64, 64)
    np.testing.assert_array_equal(t_native.rasterize_faces(node_lon, node_lat, conn, *args),
                                  j_native.rasterize_faces(j_lon, j_lat, j_conn, *args))


@pytest.mark.parametrize("table", [False, True], ids=["conn", "face_table"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_ux_search_matches(monkeypatch, table, warm):
    """ux_search warm (from cached faces) and cold (raster + walk), with and
    without the fused face table, on points in and around a flat mesh."""
    monkeypatch.setenv("PARCELS_TPU_UXCOL", "force" if table else "off")
    jfs, tfs = _pair(flow="uniform", placement="node", vertical="zc", nx=20, ny=20)
    jg, tg = jfs.gridset[0], tfs.gridset[0]
    jga, tga = jg.device_arrays(), tg.device_arrays("cpu")
    assert ("face_table" in jga) == ("face_table" in tga) == table
    x, y, rng = _points(11, 600, -2e3, 1.02e5)
    z = np.full(x.size, 10.0, np.float32)
    ei = rng.integers(0, tg.spec.n_face, x.size).astype(np.int32) if warm else None
    jr = j_ux_search(jg.spec, jga, jnp.asarray(z), jnp.asarray(y), jnp.asarray(x),
                     ei=None if ei is None else jnp.asarray(ei), lookup_meta=jg.lookup_meta())
    tr = t_uxgrid.ux_search(tg.spec, tga, torch.as_tensor(z), torch.as_tensor(y),
                            torch.as_tensor(x), ei=None if ei is None else torch.as_tensor(ei))
    ti = tr["FACE"]["index"].numpy()
    np.testing.assert_array_equal(ti, np.asarray(jr["FACE"]["index"]))
    assert (ti == -1).any() and (ti >= 0).mean() > 0.9
    np.testing.assert_allclose(tr["FACE"]["bcoord"].numpy(), np.asarray(jr["FACE"]["bcoord"]),
                               **BC_TOL)
    np.testing.assert_array_equal(tr["Z"]["index"].numpy(), np.asarray(jr["Z"]["index"]))


@pytest.mark.parametrize("kind", ["xgrid", "uxgrid"])
def test_basegrid_search_matches(kind):
    """BaseGrid.search of an XGrid and a UxGrid: equal indices, bcoords at
    rtol 1e-5, as numpy."""
    rng = np.random.default_rng(5)
    if kind == "uxgrid":
        jfs, tfs = _pair(flow="uniform", placement="face", vertical="zf", nx=16, ny=16)
        x, y = rng.uniform(0, 1e5, 300), rng.uniform(0, 1e5, 300)
        z = rng.uniform(0, 100.0, 300)
    else:
        from parcels_tpu.datasets.structured import simple_UV_dataset as j_uv
        from parcels_tpu_torch.datasets import simple_UV_dataset as t_uv

        jfs = jp.FieldSet.from_sgrid_conventions(j_uv(dims=(2, 3, 20, 30), mesh="flat"), mesh="flat")
        tfs = tp.FieldSet.from_sgrid_conventions(t_uv(dims=(2, 3, 20, 30), mesh="flat"),
                                                 mesh="flat", device="cpu")
        x, y, z = rng.uniform(-1e4, 1.1e6, 300), rng.uniform(-1e4, 1.1e6, 300), np.zeros(300)
    jg, tg = jfs.gridset[0], tfs.gridset[0]
    jr = jg.search(z, y, x)
    tr = tg.search(z, y, x, device="cpu")
    assert set(tr) == set(jr) == ({"Z", "FACE"} if kind == "uxgrid" else {"Z", "Y", "X"})
    for ax in tr:
        np.testing.assert_array_equal(tr[ax]["index"], jr[ax]["index"])
        np.testing.assert_allclose(tr[ax]["bcoord"], jr[ax]["bcoord"], rtol=1e-5, atol=1e-6)
    for axis in tg.axes:
        assert tg.get_axis_dim(axis) == jg.get_axis_dim(axis)
    with pytest.raises(ValueError):
        tg.get_axis_dim("W")
    ei = tg.ravel_index(*(np.array([1, 2]) for _ in range(3)))
    np.testing.assert_array_equal(np.stack(tg.unravel_index(ei)), np.stack(jg.unravel_index(ei)))


def _holds(grid, fi, x, y):
    """Least signed barycentric coordinate of (x, y) deg in faces ``fi``, in
    f64 on the unit sphere (-inf where fi < 0)."""
    nodes = grid.embedding()
    lon, lat = np.deg2rad(x.astype(np.float64)), np.deg2rad(y.astype(np.float64))
    p = np.stack([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat), np.sin(lat)], -1)
    v = nodes[grid.face_node_connectivity[np.clip(fi, 0, None)]]  # (n, 3, 3)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    p = p - np.sum((p - v[:, 0]) * nrm, -1, keepdims=True) * nrm

    def area(a, b, c):
        return np.sum(np.cross(b - a, c - a) * nrm, -1)

    a = area(v[:, 0], v[:, 1], v[:, 2])
    bc = np.stack([area(p, v[:, 1], v[:, 2]), area(p, v[:, 2], v[:, 0]),
                   area(p, v[:, 0], v[:, 1])], -1) / a[:, None]
    return np.where(fi >= 0, bc.min(-1), -np.inf)


@pytest.mark.parametrize("seed", [0, 1])
def test_spherical_search_repair(seed):
    """On a spherical mesh the port finds a face holding every interior
    point. Where the JAX package's face holds the point (least signed
    coordinate >= -1e-5 in f64), the port picks the same face with the same
    coordinates; every lane the JAX package fails or misplaces gets a face
    that holds it, as a brute-force check over all faces confirms."""
    jfs, tfs = _pair(mesh="spherical", flow="uniform", placement="node", vertical="zf",
                     nx=20, ny=20, extent=20.0)
    jg, tg = jfs.gridset[0], tfs.gridset[0]
    rng = np.random.default_rng(seed)
    n = 2000
    x, y = rng.uniform(1, 19, n), rng.uniform(1, 19, n)
    z = np.full(n, 10.0)
    jr, tr = jg.search(z, y, x)["FACE"], tg.search(z, y, x, device="cpu")["FACE"]
    jf, tf = jr["index"], tr["index"]
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    j_right = _holds(tg, jf, x32, y32) >= -1e-5
    assert (~j_right).sum() > 20, "the probe no longer shows the JAX package's fault"
    np.testing.assert_array_equal(tf[j_right], jf[j_right])
    np.testing.assert_allclose(tr["bcoord"][j_right], jr["bcoord"][j_right], rtol=0,
                               atol=SPHERE_BC_ATOL)
    assert (tf >= 0).all()
    assert (_holds(tg, tf, x32, y32) >= -1e-5).all()
    # brute force: the faces that hold each lane the JAX package got wrong
    wrong = np.nonzero(~j_right)[0]
    for i in wrong:
        best = _holds(tg, np.arange(tg.spec.n_face), np.full(tg.spec.n_face, x32[i]),
                      np.full(tg.spec.n_face, y32[i]))
        assert best[tf[i]] >= -1e-5 and best.max() >= -1e-5


def test_spherical_execute_uniform():
    """A spherical UGRID fieldset advects with uniform flow without error:
    u0 m/s eastward is u0 / (deg2m cos(lat)) deg/s."""
    ds = t_dataset(flow="uniform", placement="node", vertical="zf", nx=20, ny=20,
                   extent=20.0, u0=1.0, v0=0.0)
    fs = tp.FieldSet.from_ugrid_conventions(ds, mesh="spherical", device="cpu")
    rng = np.random.default_rng(3)
    x0, y0 = rng.uniform(2, 8, 200), rng.uniform(2, 18, 200)
    pset = tp.ParticleSet(fs, x=x0, y=y0, z=np.full(200, 10.0), t=np.zeros(200))
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(1, "h"), runtime=np.timedelta64(2, "D"))
    order = np.argsort(pset.particle_id)
    deg2m = fs.gridset[0].deg2m
    np.testing.assert_allclose(pset.y[order], y0, atol=1e-4)
    np.testing.assert_allclose(pset.x[order], x0 + 2 * 86400 / (deg2m * np.cos(np.deg2rad(y0))),
                               rtol=1e-4)
    assert (pset.state == tp.StatusCode.EndofLoop).all()


@pytest.mark.parametrize("model", ["fesom", "icon"])
def test_ugrid_converters_match(model):
    """fesom_to_ugrid / icon_to_ugrid renames equal the JAX package's
    (the inputs of tests/test_convert.py)."""
    from parcels_tpu import convert as jconv
    from parcels_tpu import xrlite as jxr
    from parcels_tpu_torch import convert as tconv
    from parcels_tpu_torch import xrlite as txr

    def ds(xr):
        t = np.array([np.datetime64("2000-01-01"), np.datetime64("2000-01-02")])
        if model == "fesom":
            return xr.Dataset({"u": (("time", "nz1", "nod2"), np.zeros((2, 4, 10), np.float32))},
                              coords={"time": (("time",), t),
                                      "nz": (("nz",), np.linspace(0, 100, 5)),
                                      "nz1": (("nz1",), np.linspace(10, 90, 4))})
        return xr.Dataset({"u": (("time", "depth", "ncells"), np.zeros((2, 4, 10), np.float32))},
                          coords={"time": (("time",), t),
                                  "depth_2": (("depth_2",), np.linspace(0, 100, 5)),
                                  "depth": (("depth",), np.linspace(10, 90, 4))})

    fn = f"{model}_to_ugrid"
    jout, tout = getattr(jconv, fn)(ds(jxr)), getattr(tconv, fn)(ds(txr))
    assert dict(tout.sizes) == dict(jout.sizes)
    assert "zf" in tout.dims and tout.sizes["zf"] == tout.sizes["zc"] + 1
    assert tuple(tout["u"].dims) == tuple(jout["u"].dims)


def test_fesom2_style_dataset_runs():
    """The FESOM2-convention mimic -> fesom_to_ugrid -> a fieldset that
    advects. The converter's dim map (nod2 -> n_face, elem -> n_node) is the
    JAX package's; the mesh comes from the mimic's grid file."""
    from parcels_tpu_torch import convert
    from parcels_tpu_torch import xrlite as xr
    from parcels_tpu_torch.datasets import fesom2_style_dataset

    grid = fesom2_style_dataset("grid")
    data = convert.fesom_to_ugrid(fesom2_style_dataset("data"))
    assert tuple(data["u"].dims) == ("time", "zc", "n_node")
    assert tuple(data["w"].dims) == ("time", "zf", "n_face")
    lon, lat = np.asarray(grid["lon"].values), np.asarray(grid["lat"].values)
    data["node_lon"] = xr.DataArray(lon, dims=("nod2",), attrs={"units": "m"})
    data["node_lat"] = xr.DataArray(lat, dims=("nod2",), attrs={"units": "m"})
    data["face_node_connectivity"] = xr.DataArray(np.asarray(grid["face_nodes"].values),
                                                  dims=("elem", "three"))
    fs = tp.FieldSet.from_ugrid_conventions(data, mesh="flat", device="cpu")
    assert isinstance(fs.U.interp_method, tp.interpolators.UxLinearNodeConstantZC)
    assert isinstance(fs.W.interp_method, tp.interpolators.UxConstantFaceLinearZF)
    assert isinstance(fs.UVW.interp_method, tp.interpolators.Ux_Velocity)
    rng = np.random.default_rng(2)
    n = 50
    x, y = rng.uniform(3e4, 7e4, n), rng.uniform(3e4, 7e4, n)
    pset = tp.ParticleSet(fs, x=x, y=y, z=np.full(n, 100.0), t=np.zeros(n))
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(10, "m"), runtime=np.timedelta64(1, "h"))
    assert np.isfinite(pset.x).all() and np.isfinite(pset.y).all()
    assert (pset.state == tp.StatusCode.EndofLoop).all()
    assert np.abs(pset.x - x).max() > 0


def test_ugrid_fieldset_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.FieldSet.from_ugrid_conventions(t_dataset(nx=8, ny=8), mesh="flat")


def test_weight_row_matches():
    """weight_row: hat time x tap z weights, padding zeros, as the JAX package."""
    T, Z, width = 2, 5, t_uxcol.ROW_WIDTH
    ti = np.array([0, 0, 1, 1], np.int32)
    tau = np.array([0.25, 0.0, 1.0, 0.6], np.float32)
    zi = np.array([2, 0, 4, 3], np.int32)
    w = np.array([0.3, 0.5, 0.9, 0.1], np.float32)

    def taps(mod, arr):
        z = arr(zi)
        return [(z, arr(w)), (mod.clip(z + 1, 0, Z - 1), arr(1 - w))]

    got = t_uxcol.weight_row(T, Z, width, torch.as_tensor(ti), torch.as_tensor(tau),
                             taps(torch, torch.as_tensor)).numpy()
    ref = np.asarray(j_uxcol.weight_row(T, Z, width, jnp.asarray(ti), jnp.asarray(tau),
                                        taps(jnp, jnp.asarray)))
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[:, T * Z:] == 0.0)

"""The curvilinear C-grid slice of the port against parcels_tpu: host tables,
the curvilinear search and C-grid sampling, same inputs in both packages.

The host tables are the same f64 numpy code and must be bit-identical. The
search runs the same f32 operations in another order (XLA against eager
torch), so a lane may legitimately land in the neighbouring cell where its
local coordinate sits on the +-2e-4 in-cell tolerance edge: a lane whose
JAX (xsi, eta) lies within 1e-5 of -2e-4 or 1 + 2e-4 is a tolerance-edge
lane. Every other lane must get the same cell (or the same sentinel), and at
most 0.1 % of lanes may be tolerance-edge lanes; the tests count them.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import xrlite as jxr
from parcels_tpu._core import grid as jgrid
from parcels_tpu._core import index_search as jis
from parcels_tpu.datasets import curvilinear_rotated_dataset as j_rotated
from parcels_tpu.datasets import moi_like_fieldset as j_moi
from parcels_tpu.datasets import peninsula_dataset as j_peninsula
from parcels_tpu.datasets.structured import _wrap_sgrid as j_wrap
from parcels_tpu_torch import xrlite as txr
from parcels_tpu_torch._core import grid as tgrid
from parcels_tpu_torch._core import index_search as tis
from parcels_tpu_torch.datasets import curvilinear_rotated_dataset as t_rotated
from parcels_tpu_torch.datasets import moi_like_fieldset as t_moi
from parcels_tpu_torch.datasets import peninsula_dataset as t_peninsula
from parcels_tpu_torch.datasets.structured import _wrap_sgrid as t_wrap

PIC_TOL = 2e-4
#: local coordinates of lanes found in the same cell: the same f32 inverse in
#: another order, amplified by the tangent-plane conditioning of a cell
BC_ATOL = 2e-5


def tolerance_edge(xsi, eta):
    """Lanes whose local coordinates sit on the +-2e-4 in-cell tolerance edge."""
    def near(v):
        return (np.abs(v + PIC_TOL) <= 1e-5) | (np.abs(v - (1 + PIC_TOL)) <= 1e-5)

    return near(np.asarray(xsi)) | near(np.asarray(eta))


def assert_search_matches(j, t):
    """Same cells/sentinels except tolerance-edge lanes (counted, <= 0.1 %)."""
    jy, jeta, jx, jxsi = (np.asarray(v) for v in j)
    ty, teta, tx, txsi = (v.numpy() for v in t)
    n = jy.shape[0]
    edge = tolerance_edge(jxsi, jeta)
    assert edge.sum() <= 1e-3 * n, f"{edge.sum()} tolerance-edge lanes of {n}"
    same = (jy == ty) & (jx == tx)
    assert np.all(same | edge), np.nonzero(~(same | edge))[0][:10]
    ok = same & (jy >= 0)
    np.testing.assert_allclose(txsi[ok], jxsi[ok], rtol=0, atol=BC_ATOL)
    np.testing.assert_allclose(teta[ok], jeta[ok], rtol=0, atol=BC_ATOL)
    return edge.sum()


@functools.cache
def _grids(kind):
    """(jax grid, port grid) of the same dataset (read-only in the tests)."""
    if kind == "moi":
        jfs, tfs = j_moi(xdim=120, ydim=80, zdim=2, seed=0), t_moi(xdim=120, ydim=80, zdim=2,
                                                                  seed=0, device="cpu")
    elif kind == "rotated":
        jfs = jp.FieldSet.from_sgrid_conventions(j_rotated(xdim=50, ydim=40), mesh="flat")
        tfs = tp.FieldSet.from_sgrid_conventions(t_rotated(xdim=50, ydim=40), mesh="flat",
                                                 device="cpu")
    else:
        jfs = jp.FieldSet.from_sgrid_conventions(_lonlat_dataset("jax", kind))
        tfs = tp.FieldSet.from_sgrid_conventions(_lonlat_dataset("torch", kind), device="cpu")
    return jfs.gridset[0], tfs.gridset[0]


def _lonlat_dataset(pkg, kind):
    """The antimeridian and 89.9N grids of tests/test_curvilinear.py."""
    xr, wrap = (jxr, j_wrap) if pkg == "jax" else (txr, t_wrap)
    if kind == "antimeridian":
        xdim, ydim, sp = 20, 10, 0.4
        xg, yg = np.meshgrid(np.arange(xdim) * sp, np.arange(ydim) * sp)
        lon2d = 176.0 + xg
        lon2d = np.where(lon2d > 180.0, lon2d - 360.0, lon2d)
        lat2d = 45.0 + yg
    else:
        xdim, ydim = 36, 8
        lon2d, lat2d = np.meshgrid(np.linspace(-180, 170, xdim), np.linspace(89.0, 89.9, ydim))
    U = np.ones((2, 1, ydim, xdim), np.float32)
    time = np.array([np.timedelta64(0, "s"), np.timedelta64(10, "D")])
    ds = xr.Dataset(
        {"U": (["time", "depth", "YG", "XG"], U), "V": (["time", "depth", "YG", "XG"], 0 * U)},
        coords={
            "time": (["time"], time, {"axis": "T"}),
            "depth": (["depth"], np.array([0.0]), {"axis": "Z"}),
            "YC": (["YC"], np.arange(ydim) + 0.5, {"axis": "Y"}),
            "YG": (["YG"], np.arange(ydim, dtype=np.float64), {"axis": "Y"}),
            "XC": (["XC"], np.arange(xdim) + 0.5, {"axis": "X"}),
            "XG": (["XG"], np.arange(xdim, dtype=np.float64), {"axis": "X"}),
            "lat": (["YG", "XG"], lat2d, {"axis": "Y", "units": "degrees_north"}),
            "lon": (["YG", "XG"], lon2d, {"axis": "X", "units": "degrees_east"}),
        },
    )
    return wrap(ds, xdim, ydim)


@pytest.mark.parametrize("kind", ["moi", "rotated", "antimeridian", "pole"])
def test_host_tables_bit_identical(kind):
    jg, tg = _grids(kind)
    assert tg.spec.curvilinear and tg.spec == jgrid_spec_as_port(jg.spec)
    np.testing.assert_array_equal(tg.pic_table(), jg.pic_table())
    for sph in (True, False):
        np.testing.assert_array_equal(
            tgrid.cgrid_geometry_from_coords(tg.lon, tg.lat, sph),
            jgrid.cgrid_geometry_from_coords(jg.lon, jg.lat, sph),
        )
    jl, tl = jgrid._build_curvilinear_lookup(jg.lon, jg.lat), tgrid._build_curvilinear_lookup(
        tg.lon, tg.lat)
    assert (tl["origin"], tl["step"]) == (jl["origin"], jl["step"])
    np.testing.assert_array_equal(tl["yi"], jl["yi"])
    np.testing.assert_array_equal(tl["xi"], jl["xi"])


def jgrid_spec_as_port(spec):
    """The JAX GridSpec's fields that the port's GridSpec has."""
    import dataclasses

    fields = {f.name for f in dataclasses.fields(tgrid.GridSpec)}
    return tgrid.GridSpec(**{k: v for k, v in dataclasses.asdict(spec).items() if k in fields})


def _queries(kind, jg, rng, n):
    """(y, x, yi_guess, xi_guess) for one search case."""
    lon, lat = jg.lon, jg.lat
    ny, nx = lon.shape
    zero = np.zeros(n, np.int32)
    if kind in ("antimeridian", "pole"):
        yi, xi = rng.integers(0, ny - 1, n), rng.integers(0, nx - 1, n)
        a, b = rng.uniform(0.02, 0.98, n), rng.uniform(0.02, 0.98, n)
        if kind == "antimeridian":
            lon = np.where(lon < 0, lon + 360.0, lon)  # unwrap to interpolate inside cells
        x = ((1 - a) * (1 - b) * lon[yi, xi] + a * (1 - b) * lon[yi, xi + 1]
             + a * b * lon[yi + 1, xi + 1] + (1 - a) * b * lon[yi + 1, xi])
        y = ((1 - a) * (1 - b) * lat[yi, xi] + a * (1 - b) * lat[yi, xi + 1]
             + a * b * lat[yi + 1, xi + 1] + (1 - a) * b * lat[yi + 1, xi])
        x = np.where(x > 180.0, x - 360.0, x)
        return y, x, zero, zero
    if kind == "edge":
        # the MOi lane that oscillated between two cells under a smaller
        # margin, and points exactly on node lines
        xs = [-106.19034] + [lon[60, i] for i in (1, 50, 119)] + list(lon[40, 3:40:3])
        ys = [29.881557] + [lat[60, i] for i in (1, 50, 119)] + list(lat[40, 3:40:3])
        return np.array(ys), np.array(xs), np.zeros(len(xs), np.int32), np.zeros(len(xs), np.int32)
    if kind == "outside":
        # the flat rotated grid: lanes beyond its raster are hopeless but walk
        x = rng.uniform(lon.min() - 8000, lon.max() + 8000, n)
        y = rng.uniform(lat.min() - 8000, lat.max() + 8000, n)
        return y, x, zero, zero
    # inside the MOi grid's lon/lat span (its last column is at 177 E)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-65, 75, n)
    if kind == "nan":
        x[::7] = np.nan
        y[::11] = np.nan
        y[::13] = np.inf
    if kind == "warm":
        # a guess at most one cell off the JAX cold-start answer
        yi, _, xi, _ = jis.curvilinear_search(
            jnp.asarray(lon, jnp.float32), jnp.asarray(lat, jnp.float32),
            jnp.asarray(y, jnp.float32), jnp.asarray(x, jnp.float32),
            jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32), spherical=True,
            lookup={**jg.lookup_meta(), "yi": jnp.asarray(jg._lookup["yi"]),
                    "xi": jnp.asarray(jg._lookup["xi"])},
        )
        return (y, x, np.asarray(yi) + rng.integers(-1, 2, n),
                np.asarray(xi) + rng.integers(-1, 2, n))
    return y, x, zero, zero


@pytest.mark.parametrize(
    "kind, grid, table, lookup",
    [
        ("cold", "moi", True, True),
        ("warm", "moi", True, True),
        ("walk_only", "moi", True, False),
        ("direct", "moi", False, True),
        ("antimeridian", "antimeridian", True, True),
        ("pole", "pole", True, True),
        ("edge", "moi", True, True),
        ("outside", "rotated", True, True),
        ("nan", "moi", True, True),
    ],
)
def test_curvilinear_search_matches_reference(kind, grid, table, lookup):
    jg, tg = _grids(grid)
    jga = jg.device_arrays(np.float32)
    tga = tg.device_arrays("cpu")
    rng = np.random.default_rng(4)
    y, x, yi_g, xi_g = _queries(kind, jg, rng, 2000)
    y, x = y.astype(np.float32), x.astype(np.float32)
    spherical = tg.spec.spherical
    jlk = {**jg.lookup_meta(), "yi": jga["lookup_yi"], "xi": jga["lookup_xi"]} if lookup else None
    tlk = {**tg.lookup_meta(), "yi": tga["lookup_yi"], "xi": tga["lookup_xi"]} if lookup else None
    j = jis.curvilinear_search(
        jga["lon"], jga["lat"], jnp.asarray(y), jnp.asarray(x), jnp.asarray(yi_g, jnp.int32),
        jnp.asarray(xi_g, jnp.int32), spherical=spherical, lookup=jlk,
        pic_table=jga["pic_table"] if table else None,
    )
    t = tis.curvilinear_search(
        tga["lon"], tga["lat"], torch.as_tensor(y), torch.as_tensor(x),
        torch.as_tensor(yi_g, dtype=torch.int32), torch.as_tensor(xi_g, dtype=torch.int32),
        spherical=spherical, lookup=tlk, pic_table=tga["pic_table"] if table else None,
    )
    assert_search_matches(j, t)
    yi = t[0].numpy()
    if kind in ("cold", "warm", "direct", "antimeridian", "pole", "edge"):
        assert (yi >= 0).all()
    if kind == "outside":
        assert (yi == tis.RIGHT_OUT_OF_BOUNDS).any() and (yi >= 0).any()
    if kind == "walk_only":
        assert (yi == tis.GRID_SEARCH_ERROR).any() and (yi >= 0).any()
    if kind == "nan":
        bad = ~(np.isfinite(x) & np.isfinite(y))
        assert (yi[bad] == tis.GRID_SEARCH_ERROR).all() and (yi[~bad] >= 0).all()


def _moi_pair(**kw):
    return j_moi(xdim=96, ydim=64, zdim=3, seed=2, **kw), t_moi(xdim=96, ydim=64, zdim=3, seed=2,
                                                              device="cpu", **kw)


@pytest.mark.parametrize("path", ["geom_table", "corner_gather"])
def test_cgrid_velocity_eval_matches_reference(path):
    """CGrid_Velocity through fieldset.eval, on the geometry-table path (its
    face fluxes through the K1 plain version here) and on the corner-gather
    path (no geometry table on the grid)."""
    jfs, tfs = _moi_pair(with_w=True)
    assert isinstance(tfs.UV.interp_method, tp.CGrid_Velocity)
    if path == "corner_gather":
        for fs in (jfs, tfs):
            fs.gridset[0]._needs_cgrid_geom = False
    assert ("cgrid_geom" in tfs.device_arrays()["grids"][0]) == (path == "geom_table")
    rng = np.random.default_rng(5)
    n = 1500
    t = rng.uniform(0, 86400, n)
    z = rng.uniform(0.5, 2000.0, n)
    y = rng.uniform(-70, 80, n)
    x = rng.uniform(-175, 178, n)
    for name in ("UV", "UVW"):
        jv = jfs.eval(name, t, z, y, x)
        tv = tfs.eval(name, t, z, y, x)
        for a, b in zip(tv, jv):
            # f32 sums in another order: relative to each component's scale
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4 * np.abs(b).max())


def test_cgrid_tracer_and_corner_stack_match_reference():
    from parcels_tpu.interpolators import xinterp as jxi
    from parcels_tpu_torch.interpolators import xinterp as txi

    jfs = jp.FieldSet.from_sgrid_conventions(j_peninsula(grid_type="C"), mesh="flat")
    tfs = tp.FieldSet.from_sgrid_conventions(t_peninsula(grid_type="C"), mesh="flat",
                                             device="cpu")
    jfs.P.interp_method = jp.CGrid_Tracer()
    tfs.P.interp_method = tp.CGrid_Tracer()
    rng = np.random.default_rng(6)
    n = 500
    y = rng.uniform(0, 5e4, n)
    x = rng.uniform(0, 1e5, n)
    np.testing.assert_allclose(tfs.eval("P", 0.0, 0.0, y, x), jfs.eval("P", 0.0, 0.0, y, x),
                               rtol=1e-6)
    data = rng.uniform(-1, 1, (3, 4, 10, 12)).astype(np.float32)
    ti, zi, yi, xi = (rng.integers(-1, d, n) for d in data.shape)
    tau = rng.uniform(0, 1, n).astype(np.float32)
    for blend_z in (True, False):
        j = jxi._corner_stack(jnp.asarray(data), *(jnp.asarray(v) for v in (ti, tau, zi, yi, xi)),
                              blend_z)
        t = txi._corner_stack(torch.as_tensor(data),
                              *(torch.as_tensor(v) for v in (ti, tau, zi, yi, xi)), blend_z)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def _run(mod, fs, x, y, dt_s, runtime_s, kernel="AdvectionRK4", **kw):
    pset = mod.ParticleSet(fs, x=np.asarray(x, float), y=np.asarray(y, float),
                           t=np.zeros(len(x)), **kw)
    pset.execute(getattr(mod, kernel), dt=np.timedelta64(dt_s, "s"),
                 runtime=np.timedelta64(runtime_s, "s"))
    return pset


def test_peninsula_cgrid_trajectories_match_reference():
    """The rectilinear C-grid peninsula through ParticleSet.execute: the port
    (K1 plain version for the face fluxes) against JAX, and the conserved
    streamfunction P along trajectories."""
    jfs = jp.FieldSet.from_sgrid_conventions(j_peninsula(grid_type="C"), mesh="flat")
    ds = t_peninsula(grid_type="C")
    tfs = tp.FieldSet.from_sgrid_conventions(ds, mesh="flat", device="cpu")
    assert isinstance(tfs.UV.interp_method, tp.CGrid_Velocity)
    ys = np.linspace(12.5e3, 40e3, 12)
    xs = np.full(12, 3e3)
    j = _run(jp, jfs, xs, ys, 300, 3 * 3600)
    t = _run(tp, tfs, xs, ys, 300, 3 * 3600)
    np.testing.assert_allclose(t.x, j.x, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(t.y, j.y, rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(t.state, j.state)
    p0 = tfs.eval("P", 0.0, 0.0, ys, xs)
    p1 = tfs.eval("P", 0.0, 0.0, t.y, t.x)
    np.testing.assert_allclose(p1, p0, rtol=5e-3)


def test_rotated_grid_uniform_flow_closed_form_and_reference():
    """Uniform eastward A-grid flow through the rotated curvilinear grid:
    straight lines crossing many cells (warm start + walk), against the
    closed form and JAX."""
    th = np.deg2rad(30.0)
    gx, gy = np.array([5000.0, 20000.0, 33000.0]), np.array([10000.0, 25000.0, 8000.0])
    x0 = np.cos(th) * gx - np.sin(th) * gy
    y0 = np.sin(th) * gx + np.cos(th) * gy
    jfs = jp.FieldSet.from_sgrid_conventions(j_rotated(), mesh="flat")
    tfs = tp.FieldSet.from_sgrid_conventions(t_rotated(), mesh="flat", device="cpu")
    assert tfs.gridset[0].spec.curvilinear
    j = _run(jp, jfs, x0, y0, 300, 4 * 3600)
    t = _run(tp, tfs, x0, y0, 300, 4 * 3600)
    np.testing.assert_allclose(t.x, x0 + 4 * 3600.0, rtol=1e-5)
    np.testing.assert_allclose(t.y, y0, atol=0.5)
    np.testing.assert_allclose(t.x, j.x, rtol=1e-6, atol=1e-2)
    np.testing.assert_allclose(t.y, j.y, rtol=1e-6, atol=1e-2)


def test_antimeridian_advection_closed_form():
    """Eastward across the 180-degree seam: the search and the advection are
    seam-transparent (tests/test_curvilinear.py's closed form)."""
    from parcels_tpu_torch import EARTH_RADIUS

    tfs = tp.FieldSet.from_sgrid_conventions(_lonlat_dataset("torch", "antimeridian"),
                                             device="cpu")
    t = _run(tp, tfs, [179.8], [45.2], 1800, 86400)
    deg_per_day = 86400.0 / (EARTH_RADIUS * np.pi / 180.0 * np.cos(np.deg2rad(45.2)))
    expected = 179.8 + deg_per_day - 360.0
    x_end = float(t.x[0])
    np.testing.assert_allclose(x_end if x_end <= 180 else x_end - 360.0, expected, atol=5e-3)
    assert float(t.y[0]) == pytest.approx(45.2, abs=1e-3)


def test_curvilinear_out_of_grid_raises_like_reference():
    th = np.deg2rad(30.0)
    x0 = [np.cos(th) * 58000 - np.sin(th) * 20000]
    y0 = [np.sin(th) * 58000 + np.cos(th) * 20000]
    tfs = tp.FieldSet.from_sgrid_conventions(t_rotated(), mesh="flat", device="cpu")
    with pytest.raises((tp.FieldOutOfBoundError, tp.GridSearchingError)):
        _run(tp, tfs, x0, y0, 1800, 86400, kernel="AdvectionEE")


def test_point_in_cell_helpers_match_reference():
    """The public point-in-cell helper and the lat/lon tangent-plane
    projection, on the MOi grid's cells."""
    jg, tg = _grids("moi")
    jga, tga = jg.device_arrays(np.float32), tg.device_arrays("cpu")
    rng = np.random.default_rng(9)
    n = 500
    yi, xi = rng.integers(0, 79, n).astype(np.int32), rng.integers(0, 119, n).astype(np.int32)
    # points in and around (up to half a cell out of) each lane's cell
    a, b = rng.uniform(-0.5, 1.5, n), rng.uniform(-0.5, 1.5, n)

    def bilinear(arr):
        return ((1 - a) * (1 - b) * arr[yi, xi] + a * (1 - b) * arr[yi, xi + 1]
                + a * b * arr[yi + 1, xi + 1] + (1 - a) * b * arr[yi + 1, xi]).astype(np.float32)

    x, y = bilinear(jg.lon), bilinear(jg.lat)
    j = jis.curvilinear_point_in_cell(jga["lon"], jga["lat"], jnp.asarray(y), jnp.asarray(x),
                                      jnp.asarray(yi), jnp.asarray(xi), spherical=True)
    t = tis.curvilinear_point_in_cell(tga["lon"], tga["lat"], torch.as_tensor(y),
                                      torch.as_tensor(x), torch.as_tensor(yi),
                                      torch.as_tensor(xi), spherical=True)
    edge = tolerance_edge(np.asarray(j[1]), np.asarray(j[2]))
    assert not ((t[0].numpy() != np.asarray(j[0])) & ~edge).any()
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-4, atol=1e-5)
    jc = jis._gather_cell_corners(jga["lon"], jga["lat"], jnp.asarray(yi), jnp.asarray(xi))
    tc = tis._gather_cell_corners(tga["lon"], tga["lat"], torch.as_tensor(yi),
                                  torch.as_tensor(xi))
    jp_ = jis._project_cell_and_query(*jc, jnp.asarray(x), jnp.asarray(y))
    tp_ = tis._project_cell_and_query(*tc, torch.as_tensor(x), torch.as_tensor(y))
    # unit-sphere coordinates: differences of O(1) terms, f32 trig in another
    # implementation
    for a, b in zip(tp_, jp_):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stagecache", ["off", "force"])
def test_quickstart_04_through_the_port(monkeypatch, stagecache):
    """docs/quickstarts/04_nemo_cgrid_3d.md (3-D NEMO C-grid through the
    convert layer, uniform-flow closed form) with the port in place of the
    JAX package, on the CPU, with and without the stage cache."""
    import re

    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", stagecache)
    doc = pathlib.Path(__file__).resolve().parents[1] / "docs/quickstarts/04_nemo_cgrid_3d.md"
    blocks = re.findall(r"```python\n(.*?)```", doc.read_text(), flags=re.S)
    assert len(blocks) == 3
    ns: dict = {}
    for i, block in enumerate(blocks):
        code = re.sub(r"\bparcels_tpu\b", "parcels_tpu_torch", block)
        code = code.replace("FieldSet.from_sgrid_conventions(ds)",
                            'FieldSet.from_sgrid_conventions(ds, device="cpu")')
        exec(compile(code, f"{doc.name}[block {i}]", "exec"), ns)  # noqa: S102
    assert type(ns["pset"]).__module__.startswith("parcels_tpu_torch")

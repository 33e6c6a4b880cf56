"""The port's X-Y tile domain over 4 gloo ranks on the CPU.

Mirrors tests/test_tiles.py with the JAX test's (2, 4) and (4, 2) grids as
(2, 2) over the pool's 4 ranks: against the JAX package's (2, 2) run at the
JAX test's tolerances (rtol 1e-6, atol 1e-3 m) and the port's one-rank run
(rtol 1e-5, atol 1 m on the shear flow), diagonal movers routed to their
corner neighbour in one exchange. Then three differences from the JAX
package, each a test: a 1-wide tile grid runs (the JAX package crashes
building its empty edge arrays, ``parallel/tiles.py:239``); the tile views
mark the persistent-cache owner (the JAX package drops it, :276); and the
host places each lane on the same f32 edges the migration routes it by
(the JAX package judges the host's placement on f64 edges, :359).
"""

import numpy as np
import pytest

import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool
from torch_scaleout import assert_same, banded, jax_run

DAY = so.DAY


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def diagonal(n=96):
    rng = np.random.default_rng(0)
    return rng.uniform(-9e5, 1.5e5, n), rng.uniform(-9e5, 0.5e5, n)


def test_tiles_2x2_matches_single_device_diagonal_flow(ranks):
    """Diagonal flow: every mover crosses tile corners, and the direct
    exchange routes it in one step."""
    u, v = 7.0, 10.0
    x0, y0 = diagonal()
    case = dict(build="uniform", build_kw=dict(u=u, v=v, dims=(2, 2, 16, 32)), x=x0, y=y0)
    got = banded(ranks, dom=dict(kind="tiles", tiles=(2, 2), halo=2), **case)
    ref = jax_run("tiles_diag", dom=dict(kind="tiles", tiles=(2, 2), halo=2), **case)
    assert got["migration_mode"] == "all2all" and got["n"] == x0.size
    assert_same(got, ref, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got["x"], x0 + u * DAY, rtol=1e-5)
    np.testing.assert_allclose(got["y"], y0 + v * DAY, rtol=1e-5)
    assert got["stats"]["migrated_lanes"] > 0


@pytest.mark.parametrize("tiles", [(1, 4), (4, 1)])
def test_one_wide_tile_grid_runs(ranks, tiles):
    """A 1-wide tile grid has no interior edge on one axis: the port runs it
    (empty edge array) and holds the one-rank run and the closed form."""
    u, v = 7.0, 10.0
    x0, y0 = diagonal(64)
    case = dict(build="uniform", build_kw=dict(u=u, v=v, dims=(2, 2, 16, 32)), x=x0, y=y0)
    got = banded(ranks, dom=dict(kind="tiles", tiles=tiles, halo=2), **case)
    one = so.run("torch", **case)
    assert "error" not in got, got.get("message")
    assert_same(got, one, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got["y"], y0 + v * DAY, rtol=1e-5)


def test_tiles_rotation_matches_single_device(ranks):
    """Solid-body-like shear flow, migration in every direction."""
    rng = np.random.default_rng(1)
    n = 64
    x0, y0 = rng.uniform(-4e5, 4e5, n), rng.uniform(-4e5, 4e5, n)
    case = dict(build="shear", x=x0, y=y0, dt_s=450, runtime_s=DAY // 4)
    got = banded(ranks, dom=dict(kind="tiles", tiles=(2, 2), halo=3), **case)
    one = so.run("torch", **case)
    assert_same(got, one, rtol=1e-5, atol=1.0)


def test_tiles_halo_violation_raises(ranks):
    """A lane out-running its tile's halo in one step raises the
    increase-halo (or overflow) message on every rank, never clamps."""
    outs = ranks.run("torch_scaleout", "run", name="torch", build="uniform",
                     build_kw=dict(u=2000.0, v=0.0, dims=(2, 2, 16, 32)), x=np.full(8, -9e5),
                     y=np.linspace(-9e5, 9e5, 8), dom=dict(kind="tiles", tiles=(2, 2), halo=1))
    for o in outs:
        assert o.get("error") == "RuntimeError"
        assert "alo" in o["message"] or "overflow" in o["message"]


def cache_owner_views():
    import os

    from parcels_tpu_torch.parallel import XYTileDomain

    os.environ["PARCELS_TPU_STAGECACHE"] = "force"
    try:
        fs = so.fieldset("torch", "mixed", kind="curv")
        dom = XYTileDomain(fs, tiles=(2, 2), halo=2)
        tiled = dom.build_views(dom.stacked_farrays())
        whole = fs.build_views(fs.device_arrays())
        return ({n: v._sc_owner for n, v in tiled.fields.items() if hasattr(v, "_sc_owner")},
                {n: v._sc_owner for n, v in whole.fields.items() if hasattr(v, "_sc_owner")},
                [p["tiled"] for p in dom._grid_plans])
    finally:
        del os.environ["PARCELS_TPU_STAGECACHE"]


def test_tile_views_keep_the_cache_owner(ranks):
    """With a curvilinear C-grid (replicated) beside a tiled rectilinear grid,
    the tile views mark the same persistent-cache owner as the fieldset's
    own views, so that the owner loads and flushes the ``_sc_*`` columns."""
    for tiled, whole, plans in ranks.run(__name__, "cache_owner_views"):
        assert plans == [False, True]
        assert tiled == whole and tiled["UV"]


def edge_routing():
    import torch

    from parcels_tpu_torch.parallel import XYTileDomain

    fs = so.fieldset("torch", "uniform", u=0.0, v=0.0, dims=(2, 2, 22, 31))
    dom = XYTileDomain(fs, tiles=(2, 2), halo=2)
    band = dom.stacked_farrays()["band"]
    e64 = dom._main["ey"][1]
    e32 = np.float32(e64)
    ys = np.array([np.nextafter(e32, -np.inf), e32, np.nextafter(e32, np.inf)], np.float32)
    xs = np.zeros_like(ys)
    host = dom.tile_of(ys, xs)
    yt, xt = torch.from_numpy(ys), torch.from_numpy(xs)
    dev = (torch.searchsorted(band["edges_y"], yt, right=True) * dom.tx
           + torch.searchsorted(band["edges_x"], xt, right=True)).numpy()
    f64 = (np.searchsorted(dom._main["ey"][1:-1], ys.astype(np.float64), side="right") * dom.tx
           + np.searchsorted(dom._main["ex"][1:-1], xs.astype(np.float64), side="right"))
    return host, dev, f64, float(e64) != float(e32)


def test_host_and_migration_share_the_f32_edges(ranks):
    """Lanes on and beside a tile edge that f32 cannot hold exactly: the
    host's placement equals the migration's routing (on f64 edges the host
    would place the lane on the edge in the other tile)."""
    for host, dev, f64, inexact in ranks.run(__name__, "edge_routing"):
        assert inexact
        np.testing.assert_array_equal(host, dev)
        assert not np.array_equal(f64, dev)


def test_tiled_cgrid_uses_each_tiles_geometry(ranks):
    """A spherical rectilinear C-grid of unevenly spaced nodes under (2, 2)
    tiles: each tile's per-cell geometry table (its cells' corner latitudes
    set the metric) is built from its own coordinates (the JAX package's
    tiles keep the whole grid's table under tile-local cell indices), so
    the run holds the one-rank run."""
    rng = np.random.default_rng(7)
    n = 128
    x, y = rng.uniform(3.0, 36.0, n), rng.uniform(-50.0, 50.0, n)
    case = dict(build="cgrid_uniform", build_kw=dict(stretch=1.3, shear=1.0, mesh="spherical"),
                x=x, y=y, runtime_s=4 * DAY, dt_s=3600)
    got = banded(ranks, dom=dict(kind="tiles", tiles=(2, 2), halo=2), **case)
    one = so.run("torch", **case)
    assert_same(got, one, rtol=1e-6, atol=1e-4)
    assert got["stats"]["migrated_lanes"] > 0

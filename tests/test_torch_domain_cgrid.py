"""The port's Y-band domain over 4 gloo ranks on the CPU: C-grids.

Mirrors the C-grid cases of tests/test_domain.py (the flat C-grid with its
per-band geometry table, the NEMO-style curvilinear C-grid, the MOi-shaped
config-5 grid) and the mixed curvilinear + rectilinear case of
tests/test_domain_mixed.py, with the JAX tests' 8 bands as the pool's 4
ranks: against the JAX package's 4-band run and the port's one-rank run at
the JAX tests' tolerances (rtol 1e-6; atol 0.5 m flat, 1e-4 deg
spherical), and the closed forms.
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


def geometry_tables(build, build_kw):
    from parcels_tpu_torch.parallel import YBandDomain

    dom = YBandDomain(so.fieldset("torch", build, **build_kw), halo=3)
    grids = dom.stacked_farrays()["grids"]
    plan = dom._grid_plans[dom._main_igrid]
    return ([tuple(g["cgrid_geom"].shape) for g in grids if "cgrid_geom" in g],
            plan["spec"].ydim * plan["spec"].xdim)


def test_cgrid_banded_matches_single_device_with_geom_table(ranks):
    """A banded C-grid keeps the one-row geometry-table path (each band's
    table rebuilt from its halo-extended coordinates) and equals the JAX
    package's 4-band run across band crossings."""
    rng = np.random.default_rng(7)
    n = 32
    x, y = rng.uniform(2e5, 1.7e6, n), rng.uniform(2e5, 1.0e6, n)
    for shapes, cells in ranks.run(__name__, "geometry_tables", build="cgrid_uniform",
                                   build_kw={}):
        assert shapes == [(cells, 9)]
    case = dict(build="cgrid_uniform", x=x, y=y, runtime_s=8 * DAY, dt_s=3600)
    got = banded(ranks, dom=dict(kind="band", halo=3), **case)
    ref = jax_run("cgrid", dom=dict(kind="band", n=4, halo=3), **case)
    np.testing.assert_allclose(got["x"], x + 0.3 * 8 * DAY, rtol=1e-5, atol=1.0)
    np.testing.assert_allclose(got["y"], y + 0.5 * 8 * DAY, rtol=1e-5, atol=1.0)
    assert_same(got, ref, rtol=1e-6, atol=0.5)
    assert got["stats"]["migrated_lanes"] > 0


def test_curvilinear_cgrid_banded_matches_single_device(ranks):
    """NEMO-style curvilinear spherical C-grid (the config-5 grid's kind)."""
    rng = np.random.default_rng(11)
    n = 24
    x, y = rng.uniform(1.0, 6.0, n), rng.uniform(41.0, 44.0, n)
    case = dict(build="nemo", build_kw=dict(nx=48, ny=64, u=0.25, v=0.12), x=x, y=y,
                dt_s=1800)
    for shapes, cells in ranks.run(__name__, "geometry_tables", build="nemo",
                                   build_kw=case["build_kw"]):
        assert shapes == [(cells, 9)]
    got = banded(ranks, dom=dict(kind="band", halo=3), **case)
    one = so.run("torch", **case)
    assert_same(got, one, rtol=1e-6, atol=1e-4)


def test_moi_shaped_banded_matches_single_device(ranks):
    """The MOi-like global curvilinear C-grid over 4 bands with migration
    equals the one-rank run, and uniform flow its spherical closed form."""
    rng = np.random.default_rng(5)
    n = 32
    x, y = rng.uniform(-150.0, 150.0, n), rng.uniform(-60.0, 70.0, n)
    case = dict(build="moi", build_kw=dict(xdim=96, ydim=64, zdim=3, u=0.25, v=0.05), x=x, y=y,
                dt_s=1800)
    got = banded(ranks, dom=dict(kind="band", halo=3), **case)
    one = so.run("torch", **case)
    deg2m = so.pkg("torch").EARTH_RADIUS * np.pi / 180.0
    south = y < 0.0
    np.testing.assert_allclose(got["y"][south], (y + 0.05 * DAY / deg2m)[south], atol=2e-3)
    assert_same(got, one, rtol=1e-6, atol=1e-4)


def mixed_plans():
    from parcels_tpu_torch.parallel import YBandDomain

    dom = YBandDomain(so.fieldset("torch", "mixed", kind="curv"), halo=2)
    return dom.curvilinear, {bool(p.get("curvilinear", False)) for p in dom._grid_plans
                             if p["banded"]}


def test_mixed_banded_matches_single_device(ranks):
    """A curvilinear C-grid ocean UV (the main grid: index-space bands) plus a
    rectilinear A-grid Stokes UV banded by coverage, in one kernel."""
    for curvilinear, kinds in ranks.run(__name__, "mixed_plans"):
        assert curvilinear and kinds == {True, False}  # both grids banded
    rng = np.random.default_rng(3)
    n = 64
    x0, y0 = rng.uniform(1.5, 5.5, n), rng.uniform(40.8, 44.2, n)
    case = dict(build="mixed", build_kw=dict(kind="curv"), x=x0, y=y0,
                kernel_name="RK4_PlusStokes", dt_s=1800, runtime_s=6 * 3600)
    got = banded(ranks, dom=dict(kind="band", halo=2), **case)
    one = so.run("torch", **case)
    assert got["n"] == n
    assert_same(got, one, rtol=1e-6, atol=1e-4)
    deg2m = so.pkg("torch").EARTH_RADIUS * np.pi / 180.0
    np.testing.assert_allclose(got["y"], y0 + (0.08 + 0.04) * 6 * 3600 / deg2m, atol=2e-3)


@pytest.mark.parametrize("stagecache", ["off", "force"])
def test_band_search_starts_from_the_lanes_cell(ranks, stagecache):
    """Lanes near longitude 0 on the first band of a global curvilinear grid:
    a search that starts from cell (0, 0), at longitude -180 in the band's
    degenerate edge rows, takes them for inside it (the JAX package's band
    executor then fails their walk and raises its halo message on this
    release). The port starts each lane's search, and the repair of each
    invalidated stage-cache entry, from the lane's own cell: the banded run
    equals the one-rank run (phase 10's rule, rtol 1e-6 and atol 1e-4 deg
    here)."""
    rng = np.random.default_rng(5)
    n = 4096
    x, y = rng.uniform(-170.0, 170.0, n), rng.uniform(-60.0, 70.0, n)
    x[:2], y[:2] = [0.5151502, 0.36553185], [-52.20600002, -35.14880396]
    case = dict(build="moi", build_kw=dict(xdim=400, ydim=300, zdim=2, tdim=2), x=x, y=y,
                z=np.full(n, 1.0), dt_s=600, runtime_s=1800,
                env={"PARCELS_TPU_STAGECACHE": stagecache})
    got = banded(ranks, dom=dict(kind="band", halo=3), **case)
    one = so.run("torch", **case)
    assert "error" not in got, got.get("message")
    assert_same(got, one, rtol=1e-6, atol=1e-4)

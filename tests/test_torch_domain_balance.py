"""The port's Y-band domain over 4 gloo ranks on the CPU: balanced and
rebalanced bands, all2all migration, the band-edge checks and two banded
grids.

Mirrors tests/test_domain.py's load-balancing and all2all cases,
tests/test_domain_advice.py and the two-extent case of
tests/test_domain_mixed.py, with the JAX tests' 8 bands as the pool's 4
ranks (the edges are scaled to 4 bands): against the port's one-rank run
at rtol 1e-6, atol 0.2 m, and the closed forms.
"""

import warnings

import numpy as np
import pytest

import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool
from torch_scaleout import assert_same, banded

DAY = so.DAY


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def _domain(build_kw, **kw):
    from parcels_tpu_torch.parallel import YBandDomain

    return YBandDomain(so.fieldset("torch", "uniform", **build_kw), **kw)


def skew_counts(x, y):
    uni = _domain(dict(u=0.0, v=10.0), halo=2)
    bal = _domain(dict(u=0.0, v=10.0), halo=2, row_edges=uni.balanced_row_edges(y, x))
    pdata = {"y": y, "x": x, "_active": np.ones(y.size, bool)}
    return (np.bincount(uni.band_of(y, x), minlength=4),
            np.bincount(bal.band_of(y, x), minlength=4),
            uni.lane_capacity(pdata), bal.lane_capacity(pdata))


def test_balanced_bands_skewed_seeding(ranks):
    """A release in one strip of a uniform band: balanced edges spread it
    over the ranks, shrink the lane capacity, and keep the closed form. The
    strip is the JAX test's, widened with its band (500 km, 4 bands) to 6.5
    grid rows, so that halving the worst band stays possible; the capacities
    are compared at one headroom (4 bands of whole rows cannot reach the
    third of the worst band that the JAX test's headroom of 6 needs)."""
    rng = np.random.default_rng(11)
    n = 256
    x, y = rng.uniform(-9e5, 9e5, n), rng.uniform(-4.6e5, -0.4e5, n)
    for uni, bal, cap_uni, cap_bal in ranks.run(__name__, "skew_counts", x=x, y=y):
        assert uni.max() >= 0.8 * n
        assert bal.max() <= uni.max() // 2, bal
        assert cap_bal < cap_uni
    case = dict(build="uniform", build_kw=dict(u=0.0, v=10.0), x=x, y=y)
    got = banded(ranks, dom=dict(kind="band", halo=2, balanced={}, headroom=6.0,
                                 migration_capacity=256), **case)
    one = so.run("torch", **case)
    np.testing.assert_allclose(one["y"], y + 10.0 * DAY, rtol=1e-5, atol=0.1)
    assert_same(got, one, rtol=1e-6, atol=0.1)
    assert got["migration_mode"] == "all2all"


def test_rebalance_midrun_preserves_closed_form(ranks):
    """``rebalance`` between two executes: the edges follow the drifted
    cluster, and the trajectories stay on the closed form."""
    rng = np.random.default_rng(13)
    n = 128
    x, y = rng.uniform(-9e5, 9e5, n), rng.uniform(-8e5, -6e5, n)
    got = banded(ranks, build="uniform", build_kw=dict(u=0.0, v=10.0), x=x, y=y,
                 runtime_s=DAY // 2, runs=2,
                 dom=dict(kind="band", halo=2, balanced={"max_rows": 10}, headroom=6.0,
                          migration_capacity=256, rebalance=True))
    assert "error" not in got, got.get("message")
    np.testing.assert_allclose(got["y"], y + 10.0 * DAY, rtol=1e-5, atol=0.2)
    np.testing.assert_allclose(got["x"], x, rtol=1e-6, atol=0.2)
    before, after = got["edges"]
    assert not np.array_equal(before, after)  # the cluster moved 432 km north


def test_all2all_delivers_multiband_crossers(ranks):
    """A step that spans more than one (narrow) band: all2all delivers each
    lane to its owner at once and holds the one-rank run."""
    edges = np.array([0, 12, 13, 14, 31])
    n = 24
    rng = np.random.default_rng(29)
    x, y = rng.uniform(-8e5, 8e5, n), rng.uniform(-3.1e5, -2.7e5, n)
    case = dict(build="uniform", build_kw=dict(u=0.0, v=10.0), x=x, y=y, dt_s=14400,
                runtime_s=8 * 14400)
    got = banded(ranks, dom=dict(kind="band", halo=3, row_edges=edges, migration="all2all",
                                 headroom=8.0, migration_capacity=64), **case)
    one = so.run("torch", **case)
    assert got["migration_mode"] == "all2all"
    assert_same(got, one, rtol=1e-6, atol=0.2)


def bad_row_edges():
    raised = []
    for edges in (np.arange(5) * 6, [0, 16, 31], [0, 8, 4, 12, 31]):
        try:
            _domain(dict(u=0.0, v=10.0, dims=(2, 2, 32, 8)), halo=2, row_edges=edges)
        except ValueError as e:
            raised.append("row_edges" in str(e))
    return raised


def test_bad_row_edges_raise(ranks):
    """Mis-sized, short or non-monotone edges raise, never fall back."""
    for raised in ranks.run(__name__, "bad_row_edges"):
        assert raised == [True, True, True]


def locked_rebalance(slab_headroom):
    dom = _domain(dict(u=0.0, v=10.0, dims=(2, 2, 33, 8)), halo=2, slab_headroom=slab_headroom)
    dom.stacked_farrays()
    rng = np.random.default_rng(0)
    y, x = rng.uniform(-9.5e5, -6e5, 256), rng.uniform(-5e5, 5e5, 256)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        edges = dom.rebalance(y, x)
    return edges, [str(w.message) for w in seen]


@pytest.mark.parametrize("slab_headroom", [0, 4])
def test_rebalance_under_the_slab_lock(ranks, slab_headroom):
    """Uniform edges that divide ydim lock the slab: rebalance warns; with
    ``slab_headroom`` it moves the edges."""
    for edges, seen in ranks.run(__name__, "locked_rebalance", slab_headroom=slab_headroom):
        if slab_headroom:
            assert np.any(np.diff(edges) != np.diff(edges)[0]), edges
        else:
            assert any("slab_headroom" in m for m in seen), seen


def transport_flip():
    import parcels_tpu_torch as tp
    from parcels_tpu_torch.parallel import shard_particleset

    dom = _domain(dict(u=0.0, v=10.0, dims=(2, 2, 33, 8)), halo=2, headroom=8.0,
                  migration_capacity=64, slab_headroom=3)
    n = 32
    pset = tp.ParticleSet(dom.fieldset, x=np.linspace(-6e5, 6e5, n), y=np.full(n, -9e5),
                          t=np.zeros(n))
    shard_particleset(pset, dom)
    modes = [dom.migration_mode]
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(600, "s"), runtime=np.timedelta64(14400, "s"))
    dom.set_row_edges(np.array([0, 7, 14, 21, 32]))
    modes.append(dom.migration_mode)
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(600, "s"), runtime=np.timedelta64(72000, "s"))
    o = np.argsort(pset.particle_id)
    return modes, pset.y[o], len(pset)


def test_set_row_edges_transport_flip(ranks):
    """Non-uniform edges set between executes switch the migration to all2all
    (the executor is built for its transport), and multi-band crossers land
    on the closed form."""
    for modes, y, n in ranks.run(__name__, "transport_flip"):
        assert modes == ["neighbor", "all2all"]
        np.testing.assert_allclose(y, -9e5 + 10.0 * DAY, rtol=1e-5)
        assert n == 32


def test_mixed_banded_rect_main_two_extents(ranks):
    """Two rectilinear banded grids of different ydim and extent: the second
    is banded by coverage of the first's bands; V from one, U from the other."""
    n = 32
    x0, y0 = np.linspace(-6e5, 6e5, n), np.full(n, -7e5)
    got = banded(ranks, build="mixed", build_kw=dict(kind="rect"), x=x0, y=y0,
                 kernel_name="RK4_PlusStokes", dom=dict(kind="band", halo=2))
    np.testing.assert_allclose(got["y"], y0 + 5.0 * DAY, rtol=1e-5)
    np.testing.assert_allclose(got["x"], x0 + 3.0 * DAY, rtol=1e-5, atol=1.0)

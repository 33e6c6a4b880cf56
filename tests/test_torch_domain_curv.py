"""The port's Y-band domain over 4 gloo ranks on the CPU: curvilinear bands.

Mirrors the curvilinear cases of tests/test_domain.py on the rotated grid
(index-space bands: ownership and migration judged on the cached cell row,
migrated rows rebased into the receiver's frame), with the JAX tests' 8
bands as the pool's 4 ranks: against the JAX package's 4-band run and the
port's one-rank run at rtol 1e-6, atol 0.5 m (1e-3 m between the two
transports), states equal.
"""

import numpy as np
import pytest

import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool
from torch_scaleout import assert_same, banded, jax_run

DAY = so.DAY
TOL = dict(rtol=1e-6, atol=0.5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def rotated_seeds(seed, n):
    """Seeds in the rotated frame's interior, with room for a day of 1 m/s
    zonal drift (which moves them across the grid's rows)."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(30.0)
    sx, sy = rng.uniform(5e3, 5e4, n), rng.uniform(45e3, 58e3, n)
    return np.cos(th) * sx - np.sin(th) * sy, np.sin(th) * sx + np.cos(th) * sy


CURV = dict(build="curv_rot", build_kw=dict(xdim=200, ydim=64))


def test_curvilinear_banded_matches_single_device(ranks):
    """Zonal flow on a rotated grid drives particles across row bands: the
    banded port equals the JAX package's 4-band run and the one-rank run."""
    x, y = rotated_seeds(3, 48)
    got = banded(ranks, x=x, y=y, dom=dict(kind="band", halo=3), **CURV)
    ref = jax_run("curv", x=x, y=y, dom=dict(kind="band", n=4, halo=3), **CURV)
    one = so.run("torch", x=x, y=y, **CURV)
    np.testing.assert_allclose(one["x"], x + DAY, rtol=1e-5, atol=0.5)
    assert_same(got, ref, **TOL)
    assert_same(got, one, **TOL)
    assert got["stats"]["migrated_lanes"] > 0


def test_curvilinear_banded_off_grid_errors(ranks):
    """A particle advected off the global curvilinear grid errors on every
    rank, as on one card (the replicated edge rows make the walk fail)."""
    th = np.deg2rad(30.0)
    sx, sy = 94e3, 30e3
    outs = ranks.run("torch_scaleout", "run", name="torch", build="curv_rot",
                     build_kw=dict(xdim=96, ydim=64), x=[np.cos(th) * sx - np.sin(th) * sy],
                     y=[np.sin(th) * sx + np.cos(th) * sy], dom=dict(kind="band", halo=3))
    assert all(o.get("error") in ("GridSearchingError", "FieldOutOfBoundError") for o in outs)


def test_curvilinear_halo_violation_raises(ranks):
    """A lane that out-runs its band's slab raises the increase-halo message,
    not a bare GridSearchingError: its position is still on the global grid."""
    th = np.deg2rad(30.0)
    sx, sy = 2e4, 50e3
    outs = ranks.run("torch_scaleout", "run", name="torch", x=[np.cos(th) * sx - np.sin(th) * sy],
                     y=[np.sin(th) * sx + np.cos(th) * sy], dt_s=7200,
                     dom=dict(kind="band", halo=1), **CURV)
    assert all(o.get("error") == "RuntimeError" and "alo" in o["message"] for o in outs)


def test_balanced_curvilinear_bands(ranks):
    """Non-uniform row edges on curvilinear bands: the rows rebased across
    unequal bands keep the trajectories."""
    x, y = rotated_seeds(5, 48)
    got = banded(ranks, x=x, y=y, dom=dict(kind="band", halo=3, balanced={"max_rows": 24}),
                 **CURV)
    one = so.run("torch", x=x, y=y, **CURV)
    assert np.any(np.diff(got["edges"][0]) != np.diff(got["edges"][0])[0])
    assert got["migration_mode"] == "all2all"
    assert_same(got, one, **TOL)


def test_all2all_curvilinear_matches_neighbor(ranks):
    """Curvilinear bands: the all2all rebase equals the neighbor rebase."""
    x, y = rotated_seeds(23, 32)
    a = banded(ranks, x=x, y=y, dom=dict(kind="band", halo=3, migration="neighbor"), **CURV)
    b = banded(ranks, x=x, y=y, dom=dict(kind="band", halo=3, migration="all2all"), **CURV)
    assert_same(b, a, rtol=1e-6, atol=1e-3)

"""The port's Y-band domain over 4 gloo ranks on the CPU: rectilinear bands.

Mirrors tests/test_domain.py (its 8 bands become the pool's 4 ranks): the
banded port against the JAX package's banded run with the same band count
and against the port's one-rank run, at the JAX tests' tolerances (rtol
1e-6, atol 0.1 m on the 2000 km box; 1e-5/1e-4 on the rotation), and the
closed forms. States are equal and particle ids kept. The ranks live in one
pool for the file (``parcels_tpu_torch.parallel._ranks.RankPool``); each returns the SoA it
gathered, and every rank must hold the same one.
"""

import numpy as np
import pytest

import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool
from torch_scaleout import assert_same, banded, jax_run

DAY = so.DAY
TOL = dict(rtol=1e-6, atol=0.1)
_BANDED: dict = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def crossing_seeds(seed=42, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-9e5, 9e5, n), rng.uniform(-9e5, -5e5, n)


def crossing(ranks, migration):
    """The crossing case over the ranks with ``migration`` (once per file)."""
    key = ("crossing", migration)
    if key not in _BANDED:
        x, y = crossing_seeds()
        _BANDED[key] = banded(ranks, build="uniform", build_kw=dict(u=0.0, v=10.0), x=x, y=y,
                              dom=dict(kind="band", halo=2, migration=migration))
    return _BANDED[key]


@pytest.mark.parametrize("migration", ["neighbor", "all2all"])
def test_meridional_flow_crosses_bands(ranks, migration):
    """Northward flow pushes every particle across band edges: the banded
    port equals the JAX package's 4-band run and the port's one-rank run."""
    x, y = crossing_seeds()
    case = dict(build="uniform", build_kw=dict(u=0.0, v=10.0), x=x, y=y)
    got = crossing(ranks, migration)
    ref = jax_run("crossing", dom=dict(kind="band", n=4, halo=2), **case)
    one = so.run("torch", **case)
    np.testing.assert_allclose(got["y"], y + 10.0 * DAY, rtol=1e-5, atol=0.1)
    assert_same(got, ref, **TOL)
    assert_same(got, one, **TOL)
    assert got["stats"]["migrated_lanes"] > 64 and got["stats"]["ranks"] == 4
    assert got["stats"]["gather_s"] >= 0.0
    assert got["migration_mode"] == migration


def test_all2all_matches_neighbor_uniform_bands(ranks):
    """Forced all2all on uniform bands reproduces the neighbor hops bit for bit."""
    a, b = crossing(ranks, "neighbor"), crossing(ranks, "all2all")
    for v in ("x", "y", "particle_id", "state"):
        np.testing.assert_array_equal(b[v], a[v])




def test_migration_preserves_particle_identity(ranks):
    """Cross-band particles keep their id; none lost or duplicated."""
    n = 40
    got = banded(ranks, build="uniform", build_kw=dict(u=0.0, v=10.0),
                 x=np.linspace(-8e5, 8e5, n), y=np.full(n, -8e5), kernel_name="AdvectionEE",
                 dom=dict(kind="band", halo=2))
    np.testing.assert_array_equal(got["particle_id"], np.arange(n))
    np.testing.assert_allclose(np.sort(got["y"]), np.full(n, -8e5 + 10.0 * DAY), rtol=1e-5)


def test_global_oob_still_raised_on_banded_grid(ranks):
    """A particle leaving the global domain errors on every rank, as on one card."""
    outs = ranks.run("torch_scaleout", "run", name="torch", build="uniform",
                     build_kw=dict(u=0.0, v=50.0), x=[0.0], y=[8e5], kernel_name="AdvectionEE",
                     dom=dict(kind="band", halo=2))
    assert [o.get("error") for o in outs] == ["FieldOutOfBoundError"] * 4


def band_assignment():
    fs = so.fieldset("torch", "uniform", u=1.0, v=0.0)
    from parcels_tpu_torch.parallel import YBandDomain

    dom = YBandDomain(fs, halo=2)
    return dom.band_of(np.array([-9.9e5, -1e4, 1e4, 9.9e5])), dom._interior_edges


def test_band_assignment(ranks):
    for bands, edges in ranks.run(__name__, "band_assignment"):
        assert bands[0] == 0 and bands[-1] == 3
        assert np.all(np.diff(bands) >= 0)
        assert np.all(np.diff(edges) > 0)


@pytest.mark.parametrize("halo, raises", [(1, True), (3, False)])
def test_halo_violation(ranks, halo, raises):
    """dt * v beyond the halo raises the increase-halo message on every rank
    instead of clamping at the slab edge; an adequate halo runs to the closed
    form."""
    outs = ranks.run("torch_scaleout", "run", name="torch", build="uniform",
                     build_kw=dict(u=0.0, v=20.0), x=[0.0], y=[-9e5], kernel_name="AdvectionEE",
                     dt_s=7200, runtime_s=2 * DAY if raises else DAY,
                     dom=dict(kind="band", halo=halo))
    if raises:
        assert all(o.get("error") == "RuntimeError" and "alo" in o["message"] for o in outs)
    else:
        assert all("error" not in o for o in outs)
        np.testing.assert_allclose(outs[0]["y"], -9e5 + 20.0 * DAY, rtol=1e-6)


def test_a_rank_that_raises_stops_every_rank(ranks):
    """A kernel that raises on the ranks holding lanes north of y = 0 does not
    leave the others waiting in a collective: that step's collectives end,
    and every rank raises (the failing ranks their own error)."""
    outs = ranks.run("torch_scaleout", "run", timeout=60, name="torch", build="uniform",
                     build_kw=dict(u=0.0, v=10.0), x=[0.0, 0.0], y=[-9e5, 1e5],
                     kernel_name="RaiseNorthOfZero", dom=dict(kind="band", halo=2))
    errors = [o.get("error") for o in outs]
    assert errors.count("ValueError") == 1 and errors.count("RuntimeError") == 3, errors


def test_overflow_halts_the_chunk_on_every_rank(ranks):
    """A migration-buffer overflow ends the chunk on every rank at the next
    step and raises there (the JAX package runs on to the chunk's end and
    one more chunk before its host raises): every particle stopped after
    the overflowing step, none was lost."""
    n = 64
    outs = ranks.run("torch_scaleout", "run", name="torch", build="uniform",
                     build_kw=dict(u=0.0, v=10.0), x=np.linspace(-8e5, 8e5, n),
                     y=np.full(n, -4.87e5), kernel_name="AdvectionEE",
                     dom=dict(kind="band", halo=2, migration_capacity=1))
    for o in outs:
        assert o.get("error") == "RuntimeError" and "overflow" in o["message"]
        np.testing.assert_array_equal(o["particle_id"], np.arange(n))
        assert o["t"].max() == 600.0

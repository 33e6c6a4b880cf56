"""The JAX package's banded cases at their full size: 8 ranks, full lengths.

``tests/test_torch_domain.py`` and ``test_torch_domain_window.py`` cut
``tests/test_domain.py``'s cases to fit the CPU budget of the default run
(4 ranks for its 8 bands, 2 h of the RK45 day, 3 h of the rotation's 6).
These cases run them as the JAX tests do, over 8 gloo ranks on the CPU, and
hold the banded port to the JAX package's 8-band run and to the port's
one-rank run at the JAX tests' tolerances, with their closed forms. They
are marked ``slow`` (minutes each); run them with
``python -m pytest tests/test_torch_domain_full.py -m slow``.
"""

import numpy as np
import pytest

import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool
from torch_scaleout import assert_same, banded, jax_run

pytestmark = pytest.mark.slow

DAY = so.DAY
BANDS = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(BANDS, str(tmp_path_factory.mktemp("ranks")), threads=1)
    yield pool
    pool.close()


def test_meridional_flow_crosses_eight_bands(ranks):
    """``test_domain.py:45``: 10 m/s northward for a day over 8 bands."""
    rng = np.random.default_rng(42)
    x, y = rng.uniform(-9e5, 9e5, 64), rng.uniform(-9e5, -5e5, 64)
    case = dict(build="uniform", build_kw=dict(u=0.0, v=10.0), x=x, y=y)
    got = banded(ranks, timeout=900, dom=dict(kind="band", n=BANDS, halo=2), **case)
    ref = jax_run("crossing8", dom=dict(kind="band", n=BANDS, halo=2), **case)
    one = so.run("torch", **case)
    np.testing.assert_allclose(got["y"], y + 10.0 * DAY, rtol=1e-5, atol=0.1)
    assert_same(got, ref, rtol=1e-6, atol=0.1)
    assert_same(got, one, rtol=1e-6, atol=0.1)
    assert got["stats"]["ranks"] == BANDS and got["stats"]["migrated_lanes"] > 64


def test_migration_preserves_particle_identity_eight_bands(ranks):
    """``test_domain.py:82``: ids kept, none lost or duplicated."""
    n = 40
    got = banded(ranks, timeout=900, build="uniform", build_kw=dict(u=0.0, v=10.0),
                 x=np.linspace(-8e5, 8e5, n), y=np.full(n, -8e5), kernel_name="AdvectionEE",
                 dom=dict(kind="band", n=BANDS, halo=2))
    np.testing.assert_array_equal(got["particle_id"], np.arange(n))
    np.testing.assert_allclose(np.sort(got["y"]), np.full(n, -8e5 + 10.0 * DAY), rtol=1e-5)


def test_rotation_full_six_hours(ranks):
    """``test_domain.py:65``: solid-body rotation for its 6 h at dt 60 s."""
    rng = np.random.default_rng(7)
    x, y = rng.uniform(25.0, 55.0, 32), rng.uniform(25.0, 55.0, 32)
    case = dict(build="rotation", x=x, y=y, runtime_s=3600 * 6, dt_s=60)
    got = banded(ranks, timeout=1800, dom=dict(kind="band", n=BANDS, halo=3), **case)
    ref = jax_run("rotation8", dom=dict(kind="band", n=BANDS, halo=3), **case)
    one = so.run("torch", **case)
    assert_same(got, one, rtol=1e-5, atol=1e-4)
    assert_same(got, ref, rtol=1e-5, atol=1e-4)
    assert got["stats"]["migrated_lanes"] > 0


def test_rk45_banded_full_day(ranks):
    """``test_domain.py:318``: RK45 for its full day from its own seeds, at
    its tolerance. Every lane of the port's runs lands on the day; the JAX
    package's may end past it by less than RK45_min_dt, in Evaluate, with
    its position right (``ROADMAP.md`` §3), so the JAX runs are held to ids
    and positions and the port's runs to each other's states as well."""
    from parcels_tpu_torch import StatusCode

    rng = np.random.default_rng(21)
    n = 48
    x, y = rng.uniform(-9e5, 6e5, n), rng.uniform(-9e5, -5e5, n)
    ctx = {"RK45_tol": 1e-4, "RK45_min_dt": 10, "RK45_max_dt": 3600}
    case = dict(build="uniform", build_kw=dict(u=2.0, v=10.0, context=ctx), x=x, y=y,
                kernel_name="AdvectionRK45", rk45=True)
    got = banded(ranks, timeout=3600, dom=dict(kind="band", n=BANDS, halo=3), **case)
    ref = jax_run("rk45_8", dom=dict(kind="band", n=BANDS, halo=3), **case)
    one = so.run("torch", **case)
    np.testing.assert_allclose(got["y"], y + 10.0 * DAY, rtol=1e-4, atol=1.0)
    for out in (got, one):
        assert (out["t"] == DAY).all() and (out["state"] == StatusCode.EndofLoop).all()
    assert (ref["t"] < DAY + ctx["RK45_min_dt"]).all()
    assert_same(got, one, rtol=1e-6, atol=0.5)
    np.testing.assert_array_equal(got["particle_id"], ref["particle_id"])
    for v in ("x", "y"):
        np.testing.assert_allclose(got[v], ref[v], rtol=1e-6, atol=0.5, err_msg=v)
    assert got["stats"]["migrated_lanes"] > 0

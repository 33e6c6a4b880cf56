"""The port's Y-band domain over 4 gloo ranks on the CPU: rotation, RK45
and streamed windows.

Mirrors the rotation, RK45 and windowed cases of tests/test_domain.py (its 8
bands become the pool's 4 ranks): the banded port against the port's
one-rank run and the JAX package's streamed 4-band run, at the JAX tests'
tolerances. The RK45 case runs 2 h of the JAX test's day, from seeds
astride a band edge: under the f32 rounding of its 1e-4 m tolerance the
adaptive step stays near a minute, and the port steps eagerly on the CPU.
"""

import numpy as np
import pytest

import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool
from torch_scaleout import assert_same, banded, jax_run

DAY = so.DAY
TOL = dict(rtol=1e-6, atol=0.1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def test_rotation_trajectories_match_single_device(ranks):
    """Solid-body rotation on a banded grid: decomposed == one rank (3 h of
    the JAX test's 6 h at dt 60 s: the port steps eagerly on the CPU)."""
    rng = np.random.default_rng(7)
    x, y = rng.uniform(25.0, 55.0, 32), rng.uniform(25.0, 55.0, 32)
    case = dict(build="rotation", x=x, y=y, runtime_s=3600 * 3, dt_s=60)
    got = banded(ranks, dom=dict(kind="band", halo=3), **case)
    one = so.run("torch", **case)
    assert_same(got, one, rtol=1e-5, atol=1e-4)
    assert got["stats"]["migrated_lanes"] > 0


def test_windowed_domain_matches_resident(ranks):
    """Streamed windows on the bands: the trajectories match the resident
    banded run and the JAX package's streamed 4-band run, and only
    window-sized levels are read."""
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-9e5, 6e5, 48), rng.uniform(-9e5, -5e5, 48)
    case = dict(build="uniform", x=x, y=y)
    dom = dict(kind="band", halo=2)
    res = banded(ranks, build_kw=dict(u=3.0, v=10.0, dims=(40, 2, 32, 32)), dom=dom, **case)
    win_kw = dict(u=3.0, v=10.0, dims=(40, 2, 32, 32), window=6)
    outs = ranks.run(__name__, "windowed_run", build_kw=win_kw, x=x, y=y)
    win = outs[0]
    ref = jax_run("windowed", build_kw=win_kw, dom=dict(kind="band", n=4, halo=2), **case)
    assert_same(win, res, **TOL)
    assert_same(win, ref, **TOL)
    for stats in (o["window_stats"] for o in outs):
        assert stats["loads"] >= 2
        assert stats["bytes_read"] <= stats["loads"] * 6 * 2 * 32 * 32 * 4


def windowed_run(build_kw, x, y):
    fs = so.fieldset("torch", "uniform", **dict(build_kw))
    import parcels_tpu_torch as tp
    from parcels_tpu_torch.parallel import YBandDomain, shard_particleset

    pset = tp.ParticleSet(fs, x=x, y=y, t=np.zeros(len(x)))
    shard_particleset(pset, YBandDomain(fs, halo=2))
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(600, "s"), runtime=np.timedelta64(DAY, "s"))
    o = np.argsort(pset.particle_id)
    return {"x": pset.x[o], "y": pset.y[o], "particle_id": pset.particle_id[o],
            "state": pset.state[o], "window_stats": dict(fs.window_stats)}


def test_windowed_pmesh_matches_resident(ranks):
    """Streamed windows under a particle mesh of 4 ranks match the resident
    one-rank run."""
    rng = np.random.default_rng(10)
    x, y = rng.uniform(-9e5, 6e5, 48), rng.uniform(-9e5, -5e5, 48)
    case = dict(build="uniform", x=x, y=y)
    got = banded(ranks, build_kw=dict(u=3.0, v=10.0, dims=(40, 2, 32, 32), window=6),
                 dom=dict(kind="mesh"), **case)
    one = so.run("torch", build_kw=dict(u=3.0, v=10.0, dims=(40, 2, 32, 32)), **case)
    assert_same(got, one, **TOL)


def test_rk45_banded_matches_single_device(ranks):
    """RK45 per-lane adaptive dt and Repeat resubmission across band-crossing
    migration."""
    rng = np.random.default_rng(21)
    n = 48
    x, y = rng.uniform(-9e5, 6e5, n), rng.uniform(-5.2e5, -4.4e5, n)
    ctx = {"RK45_tol": 1e-4, "RK45_min_dt": 10, "RK45_max_dt": 3600}
    case = dict(build="uniform", build_kw=dict(u=2.0, v=10.0, context=ctx), x=x, y=y,
                kernel_name="AdvectionRK45", rk45=True, runtime_s=7200)
    got = banded(ranks, dom=dict(kind="band", halo=3), **case)
    one = so.run("torch", **case)
    np.testing.assert_allclose(got["y"], y + 10.0 * 7200, rtol=1e-4, atol=1.0)
    assert_same(got, one, rtol=1e-6, atol=0.5)
    assert got["stats"]["migrated_lanes"] > 0

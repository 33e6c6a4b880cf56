"""The port's particle mesh and its collectives over 4 gloo ranks on the CPU.

Mirrors tests/test_ux_parallel.py (the UGRID mesh replicated, the SoA with
its per-face cache columns sharded, 111 particles so that the padding
runs) and the analytical case of tests/test_domain.py under a 4-rank
ParticleMesh: against the JAX package's ParticleMesh(4) run and the port's
one-rank run, at the JAX tests' tolerances (rtol 1e-6; atol 1e-4 m on the
mesh, 1 m on the gyre), states equal. Then the collectives of
``parallel/_comm.py`` and ``ParticleMesh.shard_soa`` on their own.
"""

import numpy as np
import pytest
import torch

import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool
from torch_scaleout import assert_same, banded, jax_run

DAY = so.DAY


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def test_analytical_under_particle_mesh(ranks):
    """AdvectionAnalytical (per-lane cell-transit dt) under a 4-rank
    ParticleMesh equals the one-rank run at the JAX test's tolerance, and
    the JAX package's ParticleMesh(4) at the port's own tolerance for this
    scheme against the JAX package (tests/test_torch_analytical.py: 1e-4 of
    the extent; f32 transits differ in their last bits)."""
    x0 = np.array([3e6, 4e6, 5e6, 2.5e6, 4.5e6, 3.5e6, 2e6, 5.5e6])
    y0 = np.array([3e6, 5e6, 7e6, 4e6, 3e6, 6e6, 5e6, 4.5e6])
    case = dict(build="stommel", x=x0, y=y0, kernel_name="AdvectionAnalytical", dt_s=6 * 3600,
                runtime_s=2 * DAY)
    got = banded(ranks, dom=dict(kind="mesh"), **case)
    ref = jax_run("analytical_mesh", dom=dict(kind="mesh", n=4), **case)
    one = so.run("torch", **case)
    assert not np.allclose(got["x"], x0, atol=1.0)
    assert_same(got, one, rtol=1e-6, atol=1.0)
    extent = max(np.abs(ref["x"]).max(), np.abs(ref["y"]).max())
    assert_same(got, ref, rtol=0, atol=1e-4 * extent)


def _ux_seeds(seed, n, lo, hi, zlo, zhi):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, n), rng.uniform(lo, hi, n), rng.uniform(zlo, zhi, n)


def test_ux_particlemesh_matches_single_device(ranks):
    x, y, z = _ux_seeds(0, 111, 2.5e4, 7.5e4, 10.0, 90.0)
    case = dict(build="ux", build_kw=dict(flow="rotation"), x=x, y=y, z=z, runtime_s=6 * 3600)
    got = banded(ranks, dom=dict(kind="mesh"), **case)
    one = so.run("torch", **case)
    assert_same(got, one, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["z"], one["z"], rtol=1e-6, atol=1e-4)


def test_ux_particlemesh_3d_helix_with_cache_columns(ranks):
    """3-D UVW on the mesh with the per-face cache columns and the fused
    face-row tier forced on: the cache columns shard, pad and gather."""
    x, y, z = _ux_seeds(1, 64, 3e4, 7e4, 20.0, 60.0)
    env = {"PARCELS_TPU_UXCACHE": "force", "PARCELS_TPU_UXCOL": "force"}
    case = dict(build="ux", build_kw=dict(flow="helix", with_w=True), x=x, y=y, z=z,
                kernel_name="AdvectionRK4_3D", dt_s=450, runtime_s=2 * 3600, env=env)
    got = banded(ranks, dom=dict(kind="mesh"), **case)
    one = so.run("torch", **case)
    assert_same(got, one, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["z"], one["z"], rtol=1e-6, atol=1e-4)


def test_ux_particlemesh_rotation_closed_form(ranks):
    rng = np.random.default_rng(2)
    n, c = 96, 5e4
    th, r = rng.uniform(0, 2 * np.pi, n), rng.uniform(5e3, 3e4, n)
    got = banded(ranks, build="ux", build_kw=dict(flow="rotation"), x=c + r * np.cos(th),
                 y=c + r * np.sin(th), z=np.full(n, 40.0), runtime_s=6 * 3600,
                 dom=dict(kind="mesh"))
    np.testing.assert_allclose(np.hypot(got["x"] - c, got["y"] - c), r, rtol=5e-3)


def collectives():
    import torch.distributed as dist

    from parcels_tpu_torch.parallel import _comm

    rank, world = dist.get_rank(), dist.get_world_size()
    counts = [(rank + d) % 3 for d in range(world)]
    n = sum(counts)
    cols = {"f": torch.arange(2 * n, dtype=torch.float32).reshape(n, 2) + 100 * rank,
            "b": torch.arange(n) % 2 == 0,
            "i": torch.full((n,), rank, dtype=torch.int64)}
    recv, rcounts = _comm.all_to_all_rows(cols, counts, "cpu")
    gathered = _comm.allgather_rows({"r": torch.full((rank + 1, 3), rank, dtype=torch.int32)},
                                    "cpu")["r"]
    top = _comm.allreduce_max(torch.tensor([rank, -rank, 7]))
    return rcounts, recv["i"].numpy(), recv["f"].numpy(), recv["b"].numpy(), \
        gathered.numpy(), top.numpy(), _comm.comm_stats()


def test_collectives(ranks):
    """Ragged all-to-all of mixed columns, an uneven allgather and the max
    reduction, each counted in ``comm_stats``."""
    outs = ranks.run(__name__, "collectives")
    world = len(outs)
    for r, (rcounts, src, f, b, gathered, top, stats) in enumerate(outs):
        assert rcounts == [(s + r) % 3 for s in range(world)]
        np.testing.assert_array_equal(src, np.repeat(np.arange(world), rcounts))
        for s in range(world):
            sent = [(s + d) % 3 for d in range(world)]
            lo = int(np.sum(sent[:r]))
            rows = slice(int(np.sum(rcounts[:s])), int(np.sum(rcounts[:s + 1])))
            want = np.arange(2 * sum(sent), dtype=np.float32).reshape(-1, 2)[lo:lo + sent[r]]
            np.testing.assert_array_equal(f[rows], want + 100 * s)
            np.testing.assert_array_equal(b[rows], np.arange(lo, lo + sent[r]) % 2 == 0)
        np.testing.assert_array_equal(gathered[:, 0], np.repeat(np.arange(world),
                                                                np.arange(1, world + 1)))
        np.testing.assert_array_equal(top, [world - 1, 0, 7])
        assert stats["calls"] >= 3 and stats["transport"] == "gloo" and stats["staged_calls"] == 0


def mesh_shards():
    import parcels_tpu_torch as tp
    from parcels_tpu_torch.ops import stagecache
    from parcels_tpu_torch.parallel import ParticleMesh

    fs = so.fieldset("torch", "uniform", u=0.0, v=0.0)
    pset = tp.ParticleSet(fs, x=np.linspace(-5e5, 5e5, 10), y=np.zeros(10), t=np.zeros(10))
    pset._data.update(stagecache.make_soa_cache(10, False, "cpu"))
    local = ParticleMesh(devices="cpu").shard_soa(pset._data)
    return {k: v.numpy() for k, v in local.items()}


def test_particle_mesh_shards_with_sentinels(ranks):
    """10 lanes over 4 ranks: 3 a rank in rank order, padded to the engine's
    lane count with inactive lanes whose ids and cache keys are -1; each
    rank's RNG key differs."""
    outs = ranks.run(__name__, "mesh_shards")
    for r, local in enumerate(outs):
        live = local["_active"]
        ids = local["particle_id"]
        mine = np.arange(3 * r, min(3 * r + 3, 10))
        np.testing.assert_array_equal(ids[live], mine)
        assert live.size == 8 and not live[mine.size:].any()
        assert (ids[~live] == -1).all() and (local["_sc_key"][~live] == -1).all()
    keys = {tuple(o["_rng"]) for o in outs}
    assert len(keys) == 4


def test_one_process_world():
    """Without a process group the world is one rank: ``init_distributed``
    is a no-op that returns 0, a mesh of any other size raises."""
    from parcels_tpu_torch.parallel import ParticleMesh, init_distributed

    assert init_distributed() == 0
    with pytest.raises(ValueError, match="world"):
        ParticleMesh(n_devices=2, devices="cpu")
    assert ParticleMesh(devices="cpu").n == 1

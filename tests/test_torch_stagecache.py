"""The port's C-grid RK-stage cell cache (ops/stagecache.py) against the
port without it and against parcels_tpu, on MOi-shaped curvilinear grids.

The cache must be semantically invisible: the port with the cache forced
equals the port with it off at the JAX package's own tolerance (rtol 1e-6,
atol 1e-5, tests/test_stagecache.py), and trajectories through the cache
agree with JAX's within 1e-4 deg with identical final states.
``PARCELS_TPU_STAGECACHE`` is set for both packages by monkeypatch.
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu.datasets import moi_like_fieldset as j_moi
from parcels_tpu_torch.datasets import moi_like_fieldset as t_moi
from parcels_tpu_torch.ops import stagecache

DAY = 86400
CACHE_TOL = dict(rtol=1e-6, atol=1e-5)
REF_ATOL = 1e-4  # deg


def _run(mod, fs, kernel, x, y, z=None, dt_s=1800, runtime_s=DAY, options=None):
    kw = {} if z is None else {"z": z.copy()}
    pset = mod.ParticleSet(fs, x=x.copy(), y=y.copy(), t=np.zeros(x.size), **kw)
    kernel = kernel if callable(kernel) else getattr(mod, kernel)
    pset.execute(kernel, dt=np.timedelta64(dt_s, "s"),
                 runtime=np.timedelta64(runtime_s, "s"), options=options)
    order = np.argsort(pset.particle_id)
    return pset.x[order], pset.y[order], pset.z[order], pset.state[order]


def _seeds(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(-150, 150, n), rng.uniform(-55, 60, n), rng


def _port(mode, monkeypatch, kernel, x, y, z=None, build=None, **kw):
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", mode)
    fs = (build or (lambda: t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")))()
    return _run(tp, fs, kernel, x, y, z, **kw)


@pytest.mark.parametrize("dt_s", [1800, 21600])  # small dt: hits; 6 h: cell-crossing misses
def test_stagecache_matches_plain_2d(monkeypatch, dt_s):
    x, y, _ = _seeds(0, 512)
    runtime_s = DAY if dt_s == 21600 else DAY // 2
    ref = _port("off", monkeypatch, "AdvectionRK4", x, y, dt_s=dt_s, runtime_s=runtime_s)
    checked = stagecache.cgrid_cached_eval.checked_lanes
    got = _port("force", monkeypatch, "AdvectionRK4", x, y, dt_s=dt_s, runtime_s=runtime_s)
    assert stagecache.cgrid_cached_eval.checked_lanes > checked, "the stage cache did not run"
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, **CACHE_TOL)
    np.testing.assert_array_equal(got[3], ref[3])
    if dt_s == 21600:
        # JAX through its own stage cache, on the same inputs
        monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
        jref = _run(jp, j_moi(xdim=96, ydim=64, zdim=3, seed=2), "AdvectionRK4", x, y,
                    dt_s=dt_s, runtime_s=runtime_s)
        for g, r in zip(got[:3], jref[:3]):
            np.testing.assert_allclose(g, r, rtol=0, atol=REF_ATOL)
        np.testing.assert_array_equal(got[3], jref[3])


def test_stagecache_matches_plain_3d(monkeypatch):
    x, y, rng = _seeds(1, 256)
    z = rng.uniform(5.0, 800.0, 256)

    def build():
        return t_moi(xdim=96, ydim=64, zdim=6, seed=3, with_w=True, device="cpu")

    ref = _port("off", monkeypatch, "AdvectionRK4_3D", x, y, z, build=build)
    got = _port("force", monkeypatch, "AdvectionRK4_3D", x, y, z, build=build)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, **CACHE_TOL)
    np.testing.assert_array_equal(got[3], ref[3])


def test_stagecache_closed_form_uniform_flow(monkeypatch):
    u = 0.25
    x, y, _ = _seeds(2, 64)
    y = np.clip(y, -50, 40)
    xs, ys, _, _ = _port("force", monkeypatch, "AdvectionRK4", x, y,
                         build=lambda: t_moi(xdim=96, ydim=64, zdim=3, u=u, v=0.0, device="cpu"))
    deg2m = tp.EARTH_RADIUS * np.pi / 180.0
    np.testing.assert_allclose(xs, x + u * DAY / (deg2m * np.cos(np.deg2rad(y))), atol=2e-3)
    np.testing.assert_allclose(ys, y, atol=2e-3)


def _add_stokes(fs, uscale=-0.5, vscale=0.25):
    """A second curvilinear C-grid vector field on the same grid."""
    from parcels_tpu_torch._core.field import Field, VectorField

    us = Field("Ustokes", np.asarray(fs.U.data) * uscale, fs.U.grid)
    vs = Field("Vstokes", np.asarray(fs.V.data) * vscale, fs.V.grid)
    fs.add_field(us)
    fs.add_field(vs)
    fs.add_field(VectorField("UVstokes", us, vs, interp_method=tp.CGrid_Velocity()))
    return fs


def AdvectionEE_TwoFields(particles, fieldset):
    u1, v1 = fieldset.UV[particles]
    u2, v2 = fieldset.UVstokes[particles]
    particles.dx = particles.dx + (u1 + u2) * particles.dt
    particles.dy = particles.dy + (v1 + v2) * particles.dt


def test_stagecache_two_vector_fields_no_crosstalk(monkeypatch):
    """Two C-grid vector fields on one grid never blend each other's cached
    face values: only the owner (the first) persists into the SoA."""
    x, y, _ = _seeds(7, 256)

    def build():
        return _add_stokes(t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu"))

    assert stagecache.soa_cache_owner(build())[0] is None  # auto on the CPU: no persistence
    ref = _port("off", monkeypatch, AdvectionEE_TwoFields, x, y, build=build, runtime_s=6 * 3600)
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    assert stagecache.soa_cache_owner(build()) == ("UV", False)
    got = _port("force", monkeypatch, AdvectionEE_TwoFields, x, y, build=build,
                runtime_s=6 * 3600)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, **CACHE_TOL)


def test_stagecache_oob_error_preserved(monkeypatch):
    """A particle leaving the grid raises the same typed error with the cache
    forced as without it."""

    def run(mode):
        monkeypatch.setenv("PARCELS_TPU_STAGECACHE", mode)
        fs = t_moi(xdim=96, ydim=64, zdim=3, u=0.0, v=20.0, device="cpu")
        pset = tp.ParticleSet(fs, x=[0.0], y=[78.0], t=[0.0])
        # a spherical grid has no outside: the lane fails the search
        with pytest.raises((tp.FieldOutOfBoundError, tp.GridSearchingError)) as e:
            pset.execute(tp.AdvectionRK4, dt=np.timedelta64(1, "h"),
                         runtime=np.timedelta64(1, "D"))
        return type(e.value)

    assert run("force") is run("off")


def test_engine_options_force_and_cache_columns(monkeypatch, tmp_path):
    """EngineOptions(stagecache="force") runs the cache through execute; its
    SoA columns are injected (invalid on padded lanes) but are neither
    particle variables nor ParticleFile output."""
    monkeypatch.delenv("PARCELS_TPU_STAGECACHE", raising=False)
    x, y, _ = _seeds(3, 5)
    fs = t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")
    files = {}
    for mode in ("off", "force"):
        pset = tp.ParticleSet(fs, x=x, y=y, t=np.zeros(5))
        pf = tp.ParticleFile(tmp_path / f"{mode}.parquet", outputdt=np.timedelta64(3600, "s"))
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(1800, "s"),
                     runtime=np.timedelta64(7200, "s"), output_file=pf,
                     options=tp.EngineOptions(stagecache=mode))
        pf.close()
        files[mode] = tp.read_particlefile(tmp_path / f"{mode}.parquet")
        if mode == "force":
            key = pset._data["_sc_key"]
            assert key.shape == (8, 4) and (key[:5, 0] >= 0).all()
            with pytest.raises(AttributeError):
                pset._sc_key  # noqa: B018
            inv = stagecache.invalidate_soa_cache(pset._data)
            assert (inv["_sc_key"][:, 0] == -1).all() and (key[:5, 0] >= 0).all()
            assert torch.equal(inv["_sc_key"][:, 1:], key[:, 1:])
            # padding gives the columns invalid keys
            fresh = tp.ParticleSet(fs, x=x, y=y, t=np.zeros(5))
            fresh._data.update(stagecache.make_soa_cache(5, False, "cpu"))
            fresh._data["_sc_key"][:, 0] = 3
            fresh._pad_capacity(8)
            assert (fresh._data["_sc_key"][5:] == -1).all()
            assert (fresh._data["_sc_u4"][5:] == 0).all()
    assert list(files["force"].columns) == list(files["off"].columns)
    assert not any(c.startswith("_sc_") for c in files["force"].columns)
    np.testing.assert_allclose(files["force"]["x"].to_numpy(), files["off"]["x"].to_numpy(),
                               **CACHE_TOL)


@pytest.mark.parametrize("last_lane_misses", [True, False])
def test_miss_repair_rounds_and_last_lane(monkeypatch, last_lane_misses):
    """A cached eval after lanes moved to other cells equals a fresh full
    eval bit for bit, over two repair rounds whose last is padded with lane
    n - 1 (itself a miss or not)."""
    from parcels_tpu_torch._core.particles_view import Particles

    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    fs = t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")
    n = 2048
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.uniform(-150, 150, n), dtype=torch.float32)
    y = torch.as_tensor(rng.uniform(-55, 60, n), dtype=torch.float32)
    moved = torch.zeros(n, dtype=torch.bool)
    moved[::2] = True  # 1025 misses: two rounds of K = 1024
    moved[-1] = last_lane_misses
    moved[1] = not last_lane_misses
    x2 = torch.where(moved, x + 7.5, x)  # two cells east
    t = torch.full((n,), 3600.0)
    z = torch.full((n,), 1.0)

    def pdata():
        return {"state": torch.zeros(n, dtype=torch.int32),
                "ei": torch.zeros((n, 1), dtype=torch.int32),
                "_active": torch.ones(n, dtype=torch.bool)}

    vf = fs.build_views(fs.device_arrays()).UV
    pd = pdata()
    vf.eval(t, z, y, x, Particles(pd, pd["_active"]))
    rounds = stagecache.cgrid_cached_eval.miss_rounds
    u, v = vf.eval(t, z, y, x2, Particles(pd, pd["_active"]))
    assert stagecache.cgrid_cached_eval.miss_rounds - rounds == 2
    vf2 = fs.build_views(fs.device_arrays()).UV
    pd2 = pdata()
    u2, v2 = vf2.eval(t, z, y, x2, Particles(pd2, pd2["_active"]))
    assert torch.equal(u, u2) and torch.equal(v, v2)
    assert torch.equal(pd["ei"], pd2["ei"]) and torch.equal(pd["state"], pd2["state"])
    for k in ("cell", "u4", "v4", "row"):
        assert torch.equal(vf._stage_cache[k], vf2._stage_cache[k]), k

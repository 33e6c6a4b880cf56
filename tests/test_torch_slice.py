"""The port's first slice end to end: ParticleSet.execute on rectilinear
A-grid fieldsets, against parcels_tpu on the same inputs.

Each package ingests the dataset its own builder makes (the builders are
the same code), runs the same kernel and returns trajectories. Tolerances
are those of tests/test_advection.py (RK4: rtol 1e-5 on x/y, 1e-4 on z;
RK45: its RK45_tol-driven 1e-5 on the moving eddy), plus an absolute floor
of 1e-2 m where positions pass through zero velocity differences of
f32 summation order (K1/K2 vs. the JAX gather path).
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import xrlite as jxr
from parcels_tpu.datasets.structured import _coords_2d as j_coords, _wrap_sgrid as j_wrap
from parcels_tpu_torch import xrlite as txr
from parcels_tpu_torch.datasets.structured import _coords_2d as t_coords, _wrap_sgrid as t_wrap

RK4_TOL = dict(rtol=1e-5, atol=1e-2)


def _field_dataset(pkg, shape, seed=0, w=False, smooth=True):
    """A flat rectilinear (T, Z, Y, X) U/V(/W) dataset built by ``pkg``'s helpers."""
    xr, coords, wrap = (jxr, j_coords, j_wrap) if pkg == "jax" else (txr, t_coords, t_wrap)
    T, Z, Y, X = shape
    lon = np.linspace(0.0, 1000.0 * (X - 1), X)
    lat = np.linspace(0.0, 1000.0 * (Y - 1), Y)
    depth = np.linspace(0.0, 10.0 * max(Z - 1, 1), Z)
    taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s") for i in range(T)])
    rng = np.random.default_rng(seed)
    if smooth:
        t4, z4, y4, x4 = np.meshgrid(np.arange(T), depth, lat, lon, indexing="ij")
        u = 0.1 + 0.05 * np.sin(x4 / 3e4) + 2e-6 * y4 + 1e-5 * z4 + 0.01 * t4
        v = 0.05 - 5e-7 * x4 + 0.02 * np.sin(y4 / 5e3)
    else:
        u = rng.uniform(-0.3, 0.3, shape)
        v = rng.uniform(-0.3, 0.3, shape)
    data = {
        "U": (["time", "depth", "YG", "XG"], u.astype(np.float32)),
        "V": (["time", "depth", "YG", "XG"], v.astype(np.float32)),
    }
    if w:
        data["W"] = (["time", "depth", "YG", "XG"], (2e-4 * np.cos(u * 10)).astype(np.float32))
    ds = xr.Dataset(data, coords=coords(lon, lat, time=taxis, depth=depth, mesh="flat"))
    return wrap(ds, X, Y)


def _fieldsets(shape, **kw):
    jfs = jp.FieldSet.from_sgrid_conventions(_field_dataset("jax", shape, **kw), mesh="flat")
    tfs = tp.FieldSet.from_sgrid_conventions(
        _field_dataset("torch", shape, **kw), mesh="flat", device="cpu"
    )
    return jfs, tfs


def _seeds(n, shape, seed=1, z=False):
    rng = np.random.default_rng(seed)
    T, Z, Y, X = shape
    out = dict(
        x=rng.uniform(2000.0, 1000.0 * (X - 3), n),
        y=rng.uniform(2000.0, 1000.0 * (Y - 3), n),
        t=np.zeros(n),
    )
    if z:
        out["z"] = rng.uniform(3.0, 10.0 * (Z - 1) - 3.0, n)
    return out


def _run(pkg_fs, pkg, kernel, seeds, dt=300, runtime=3600, pclass=None, options=None, **kw):
    mod = jp if pkg == "jax" else tp
    pset = mod.ParticleSet(pkg_fs, pclass=pclass or mod.Particle, **seeds)
    pset.execute(kernel, dt=np.timedelta64(dt, "s"), runtime=np.timedelta64(runtime, "s"),
                 options=options, **kw)
    return pset


@pytest.mark.parametrize("method", ["EE", "RK2", "RK4"])
def test_k1_path_matches_reference(method):
    """(4, 8, 64, 32) takes K1 in the port (its plain version on the CPU)."""
    from parcels_tpu_torch.ops.interp_kernels import fits_fast_path

    shape = (4, 8, 64, 32)
    assert fits_fast_path(shape)
    jfs, tfs = _fieldsets(shape)
    seeds = _seeds(128, shape, z=True)
    jset = _run(jfs, "jax", getattr(jp, f"Advection{method}"), seeds)
    tset = _run(tfs, "torch", getattr(tp, f"Advection{method}"), seeds)
    np.testing.assert_allclose(tset.x, jset.x, **RK4_TOL)
    np.testing.assert_allclose(tset.y, jset.y, **RK4_TOL)
    np.testing.assert_array_equal(tset.state, jset.state)
    np.testing.assert_allclose(tset.t, jset.t, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["RK2_3D", "RK4_3D"])
def test_3d_binned_path_matches_reference(method, monkeypatch):
    """An HBM-style 3-D field (beyond the K1 budget) through the port's
    sorted engine and K2 (forced), against the JAX gather path."""
    from parcels_tpu_torch.ops import binned_sample as tbs
    from parcels_tpu_torch.ops.interp_kernels import fits_fast_path

    shape = (2, 6, 40, 1100)
    assert not fits_fast_path(shape)
    jfs, tfs = _fieldsets(shape, w=True)
    seeds = _seeds(600, shape, z=True)
    calls = []
    plain = tbs.slab_sample_plain
    monkeypatch.setattr(tbs, "slab_sample_plain", lambda *a: calls.append(1) or plain(*a))
    jset = _run(jfs, "jax", getattr(jp, f"Advection{method}"), seeds)
    tset = _run(tfs, "torch", getattr(tp, f"Advection{method}"), seeds,
                options=tp.EngineOptions(sampler="binned"))
    assert calls, "the binned path did not run"
    np.testing.assert_allclose(tset.x, jset.x, **RK4_TOL)
    np.testing.assert_allclose(tset.y, jset.y, **RK4_TOL)
    np.testing.assert_allclose(tset.z, jset.z, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tset.particle_id, jset.particle_id)


def test_sorted_mode_matches_unsorted():
    """Sorted + binned forced == plain gather run; unsort restores lane order."""
    shape = (3, 1, 64, 2048)
    _, tfs = _fieldsets(shape, smooth=False, seed=4)
    seeds = _seeds(700, shape, seed=11)
    off = _run(tfs, "torch", tp.AdvectionRK4, seeds, dt=600, options=tp.EngineOptions(sampler="gather"))
    on = _run(tfs, "torch", tp.AdvectionRK4, seeds, dt=600, options=tp.EngineOptions(sampler="binned"))
    np.testing.assert_array_equal(on.particle_id, off.particle_id)
    np.testing.assert_allclose(on.x, off.x, rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(on.y, off.y, rtol=2e-5, atol=1e-2)


def _eddy(pkg, method, rtol=None):
    mod = jp if pkg == "jax" else tp
    kw = {} if pkg == "jax" else {"device": "cpu"}
    ds = mod.datasets.moving_eddy_dataset() if pkg == "jax" else tp_datasets().moving_eddy_dataset()
    fs = mod.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw)
    pclass = mod.Particle
    if method == "RK45":
        fs.add_context("RK45_tol", rtol)
        fs.add_context("RK45_min_dt", 1)
        fs.add_context("RK45_max_dt", 3600)
        pclass = pclass.add_variable(mod.Variable("next_dt", dtype=np.float32, initial=300.0))
    kernel = getattr(mod, f"Advection{method}")
    seeds = dict(x=[12000.0, 8000.0], y=[12500.0, 9000.0], t=[0.0, 0.0])
    pset = _run(fs, pkg, kernel, seeds, dt=300, runtime=3600 * 6, pclass=pclass)
    return pset, ds


def tp_datasets():
    import parcels_tpu_torch.datasets

    return parcels_tpu_torch.datasets


@pytest.mark.parametrize("method, rtol", [("RK4", 1e-5), ("RK45", 1e-5)])
def test_moving_eddy_closed_form_and_reference(method, rtol):
    tset, ds = _eddy("torch", method, rtol)
    jset, _ = _eddy("jax", method, rtol)
    u0, ug, f = ds.attrs["u_0"], ds.attrs["u_g"], ds.attrs["f"]
    t = 3600 * 6
    x0, y0 = np.array([12000.0, 8000.0]), np.array([12500.0, 9000.0])
    exp_x = x0 + ug * t + (u0 - ug) / f * np.sin(f * t)
    exp_y = y0 - (u0 - ug) / f * (1 - np.cos(f * t))
    np.testing.assert_allclose(tset.x, exp_x, rtol=rtol)
    np.testing.assert_allclose(tset.y, exp_y, rtol=rtol)
    np.testing.assert_allclose(tset.x, jset.x, rtol=rtol)
    np.testing.assert_allclose(tset.y, jset.y, rtol=rtol)


def test_particlefile_matches_reference(tmp_path):
    shape = (4, 1, 32, 32)
    jfs, tfs = _fieldsets(shape)
    seeds = _seeds(20, shape)
    out = {}
    for pkg, fs in (("jax", jfs), ("torch", tfs)):
        mod = jp if pkg == "jax" else tp
        pf = mod.ParticleFile(tmp_path / f"{pkg}.parquet", outputdt=np.timedelta64(1200, "s"))
        _run(fs, pkg, mod.AdvectionRK4, seeds, output_file=pf)
        pf.close()
        out[pkg] = mod.read_particlefile(tmp_path / f"{pkg}.parquet")
    j, t = out["jax"], out["torch"]
    assert list(t.columns) == list(j.columns)
    assert len(t) == len(j) == 20 * 4
    np.testing.assert_array_equal(t["particle_id"].to_numpy(), j["particle_id"].to_numpy())
    np.testing.assert_array_equal(t["t"].to_numpy(), j["t"].to_numpy())
    for c in ("x", "y", "z"):
        np.testing.assert_allclose(t[c].to_numpy(), j[c].to_numpy(), **RK4_TOL)


def test_state_from_numpy_carries_the_reference_state():
    shape = (3, 2, 12, 20)
    jfs, tfs = _fieldsets(shape)
    seeds = _seeds(50, shape, z=True)
    jset = jp.ParticleSet(jfs, **seeds)
    tset = tp.ParticleSet(tfs, **seeds)
    jarr = jfs.device_arrays()
    farrays, soa = tp.state_from_numpy(
        {"fields": {k: np.asarray(v) for k, v in jarr["fields"].items()},
         "grids": [{k: np.asarray(v) for k, v in g.items()} for g in jarr["grids"]]},
        jset._data, "cpu",
    )
    own = tfs.device_arrays()
    for name, v in own["fields"].items():
        assert torch.equal(farrays["fields"][name], v)
    for k in ("lon", "lat", "depth", "time"):
        assert torch.equal(farrays["grids"][0][k], own["grids"][0][k])
    assert set(soa) == set(tset._data)
    for k, v in tset._data.items():
        assert soa[k].dtype == v.dtype, k
        assert torch.equal(soa[k], v), k
    assert soa["x"].dtype == torch.float32 and soa["_tc"].dtype == torch.float32
    assert soa["state"].dtype == torch.int32 and soa["ei"].dtype == torch.int32
    assert soa["_active"].dtype == torch.bool


def test_out_of_bounds_raises_like_reference():
    shape = (2, 1, 10, 10)
    jfs, tfs = _fieldsets(shape)
    seeds = dict(x=[8800.0], y=[5000.0], t=[0.0])
    with pytest.raises(jp.FieldOutOfBoundError):
        _run(jfs, "jax", jp.AdvectionEE, seeds, dt=600, runtime=3600)
    with pytest.raises(tp.FieldOutOfBoundError):
        _run(tfs, "torch", tp.AdvectionEE, seeds, dt=600, runtime=3600)


def test_default_device_is_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.FieldSet.from_sgrid_conventions(_field_dataset("torch", (2, 1, 8, 8)), mesh="flat")


@pytest.mark.parametrize("case", ["window", "particle_mesh", "domain"])
def test_later_slice_features_raise(case):
    """Features of later slices raised until their slice landed; all three
    have landed. Time windows stream and match the resident run (rtol 1e-6,
    atol 1e-3 m, the tolerance of tests/test_windowing.py); a particle mesh
    and a Y-band domain over the one rank of a process without a process
    group run and equal the unsharded run bit for bit (their multi-rank
    runs: tests/test_torch_parallel.py and tests/test_torch_domain*.py)."""
    from parcels_tpu_torch.parallel import ParticleMesh, YBandDomain, shard_particleset

    if case == "window":
        _, resident = _fieldsets((4, 1, 8, 8))
        _, windowed = _fieldsets((4, 1, 8, 8))
        assert windowed.set_time_window(2) is windowed
        seeds = _seeds(16, (4, 1, 8, 8))
        a = _run(windowed, "torch", tp.AdvectionRK4, seeds)
        b = _run(resident, "torch", tp.AdvectionRK4, seeds)
        for v in ("x", "y"):
            np.testing.assert_allclose(getattr(a, v), getattr(b, v), rtol=1e-6, atol=1e-3)
        assert windowed.window_stats["loads"] > 0
        return
    shape = (2, 1, 8, 8)
    _, tfs = _fieldsets(shape)
    seeds = _seeds(16, shape)
    sharded = tp.ParticleSet(tfs, **seeds)
    shard_particleset(sharded, ParticleMesh(devices="cpu") if case == "particle_mesh"
                      else YBandDomain(tfs, halo=2))
    sharded.execute(tp.AdvectionRK4, dt=np.timedelta64(300, "s"),
                    runtime=np.timedelta64(3600, "s"))
    plain = _run(tfs, "torch", tp.AdvectionRK4, seeds)
    order = np.argsort(sharded.particle_id)
    for v in ("x", "y", "particle_id", "state"):
        np.testing.assert_array_equal(getattr(sharded, v)[order], getattr(plain, v))
    assert sharded.last_run_stats["ranks"] == 1


def test_blocked_engine_matches_one_block(monkeypatch):
    """Lane counts above the block size run as sequential blocks with the
    same result as one block (blocks are independent)."""
    from parcels_tpu_torch._core import engine, particleset

    shape = (4, 8, 64, 32)
    _, tfs = _fieldsets(shape)
    seeds = _seeds(20, shape, z=True)
    one = _run(tfs, "torch", tp.AdvectionRK4, seeds)
    monkeypatch.setattr(engine, "DEFAULT_BLOCK_SIZE", 8)
    monkeypatch.setattr(particleset, "DEFAULT_BLOCK_SIZE", 8)
    blocked = _run(tfs, "torch", tp.AdvectionRK4, seeds)
    assert blocked._data["x"].shape[0] == 32  # padded to a multiple of the block
    for v in ("x", "y", "z", "t"):
        np.testing.assert_array_equal(getattr(blocked, v), getattr(one, v))


def test_eval_and_constant_field_match_reference():
    shape = (3, 4, 20, 30)
    jfs, tfs = _fieldsets(shape)
    jfs.add_constant_field("K", 2.5, mesh="flat")
    tfs.add_constant_field("K", 2.5, mesh="flat")
    rng = np.random.default_rng(9)
    t = rng.uniform(0, 7200, 64)
    z = rng.uniform(0, 30, 64)
    y = rng.uniform(0, 19000, 64)
    x = rng.uniform(0, 29000, 64)
    for name in ("U", "V", "K"):
        np.testing.assert_allclose(tfs.eval(name, t, z, y, x), jfs.eval(name, t, z, y, x),
                                   rtol=2e-4, atol=2e-5)
    ju, jv = jfs.eval("UV", t, z, y, x)
    tu, tv = tfs.eval("UV", t, z, y, x)
    np.testing.assert_allclose(tu, ju, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tv, jv, rtol=2e-4, atol=2e-5)


def test_backward_in_time_matches_reference():
    """Two back-to-back executes, the second with dt < 0, in both packages."""
    shape = (4, 1, 32, 32)
    jfs, tfs = _fieldsets(shape)
    seeds = _seeds(30, shape)
    out = {}
    for pkg, fs in (("jax", jfs), ("torch", tfs)):
        mod = jp if pkg == "jax" else tp
        pset = mod.ParticleSet(fs, **seeds)
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(300, "s"), runtime=np.timedelta64(3600, "s"))
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(-300, "s"), runtime=np.timedelta64(3600, "s"))
        out[pkg] = pset
    np.testing.assert_allclose(out["torch"].x, out["jax"].x, **RK4_TOL)
    np.testing.assert_allclose(out["torch"].y, out["jax"].y, **RK4_TOL)
    np.testing.assert_allclose(out["torch"].t, out["jax"].t, rtol=0, atol=0)
    # RK4 forward then backward over a smooth field returns near the start
    np.testing.assert_allclose(out["torch"].x, seeds["x"], rtol=1e-4)

"""UGRID trajectories through ParticleSet.execute: the port against parcels_tpu,
with the per-face stage cache (ops/uxcache.py) off and forced.

The inputs are those of tests/test_ux.py (uniform translation, solid-body
rotation, the 3-D helix with AdvectionRK4_3D, a lane leaving the mesh) and
tests/test_uxcache.py. Each case runs in both packages with ``uxcache`` off
(the gather tier) or with ``uxcache`` and ``uxcol`` forced (the cached tier
on its fused face rows), through ``EngineOptions``. Positions are held at
the tolerance of tests/test_uxcache.py (rtol 1e-6, atol 1e-4 m) and final
states must be equal.
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu.datasets.unstructured import delaunay_flow_dataset as j_dataset
from parcels_tpu_torch.datasets.unstructured import delaunay_flow_dataset as t_dataset
from parcels_tpu_torch.ops import uxcache

DAY = 86400
TOL = dict(rtol=1e-6, atol=1e-4)
MODES = {
    "off": dict(uxcache="off"),
    "force": dict(uxcache="force", uxcol="force"),
}


def _fieldsets(**kw):
    return (jp.FieldSet.from_ugrid_conventions(j_dataset(**kw), mesh="flat"),
            tp.FieldSet.from_ugrid_conventions(t_dataset(**kw), mesh="flat", device="cpu"))


def _run(mod, fs, kernel, x, y, z, dt_s, runtime_s, mode):
    pset = mod.ParticleSet(fs, x=x.copy(), y=y.copy(), z=z.copy(), t=np.zeros(x.size))
    pset.execute(getattr(mod, kernel), dt=np.timedelta64(dt_s, "s"),
                 runtime=np.timedelta64(runtime_s, "s"), options=mod.EngineOptions(**MODES[mode]))
    order = np.argsort(pset.particle_id)
    return pset, [np.asarray(getattr(pset, v))[order] for v in ("x", "y", "z", "state")]


def _both(mode, kw, kernel, x, y, z, dt_s, runtime_s):
    jfs, tfs = _fieldsets(**kw)
    checked = uxcache.ux_cached_eval.checked_lanes
    tset, got = _run(tp, tfs, kernel, x, y, z, dt_s, runtime_s, mode)
    assert (uxcache.ux_cached_eval.checked_lanes > checked) == (mode == "force")
    assert (uxcache.UXC_KEY in tset._data) == (mode == "force")
    _, ref = _run(jp, jfs, kernel, x, y, z, dt_s, runtime_s, mode)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_array_equal(got[3], ref[3])
    return got


@pytest.mark.parametrize("mode", ["off", "force"])
@pytest.mark.parametrize("placement,vertical", [("node", "zf"), ("face", "zc")])
def test_uniform_translation(mode, placement, vertical):
    rng = np.random.default_rng(3)
    x0, y0 = rng.uniform(2e4, 4e4, 16), rng.uniform(2e4, 4e4, 16)
    got = _both(mode, dict(flow="uniform", placement=placement, vertical=vertical),
                "AdvectionRK4", x0, y0, np.full(16, 10.0), 1800, 6 * 3600)
    np.testing.assert_allclose(got[0], x0 + 6 * 3600.0, rtol=1e-5)
    np.testing.assert_allclose(got[1], y0 + 0.5 * 6 * 3600.0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["off", "force"])
def test_rotation(mode):
    rng = np.random.default_rng(5)
    c = 5e4
    x0, y0 = rng.uniform(2e4, 8e4, 64), rng.uniform(2e4, 8e4, 64)
    x0[:3], y0[:3] = [c + 1e4, c, c - 2e4], [c, c + 1.5e4, c]
    got = _both(mode, dict(flow="rotation", placement="node", vertical="zc", nx=30, ny=30),
                "AdvectionRK4", x0, y0, np.full(64, 10.0), 600, 3 * 3600)
    r0, r1 = np.hypot(x0 - c, y0 - c), np.hypot(got[0] - c, got[1] - c)
    np.testing.assert_allclose(r1[:3], r0[:3], rtol=2e-3)


@pytest.mark.parametrize("mode", ["off", "force"])
def test_helix_3d(mode):
    rng = np.random.default_rng(1)
    n = 32
    x0, y0, z0 = rng.uniform(3e4, 7e4, n), rng.uniform(3e4, 7e4, n), rng.uniform(20.0, 60.0, n)
    got = _both(mode, dict(flow="helix", placement="node", vertical="zf", nx=24, ny=24,
                           w0=0.001, with_w=True),
                "AdvectionRK4_3D", x0, y0, z0, 600, DAY // 8)
    np.testing.assert_allclose(got[2], z0 + 0.001 * (DAY // 8), rtol=1e-4)


@pytest.mark.parametrize("mode", ["off", "force"])
def test_out_of_mesh_raises(mode):
    jfs, tfs = _fieldsets(flow="uniform", placement="node", vertical="zc", u0=10.0, v0=0.0)
    for mod, fs, err in ((jp, jfs, jp.FieldOutOfBoundError), (tp, tfs, tp.FieldOutOfBoundError)):
        pset = mod.ParticleSet(fs, x=[9.9e4], y=[5e4], z=[10.0], t=[0.0])
        with pytest.raises(err):
            pset.execute(mod.AdvectionRK4, dt=np.timedelta64(30, "m"),
                         runtime=np.timedelta64(1, "D"), options=mod.EngineOptions(**MODES[mode]))


@pytest.mark.parametrize("placement,vertical", [
    ("node", "zf"), ("node", "zc"), ("face", "zf"), ("face", "zc"),
])
def test_port_cache_matches_port_plain(placement, vertical):
    """The cache is invisible within the port: forced equals off on the
    inputs of tests/test_uxcache.py, through hits and repairs."""
    rng = np.random.default_rng(0)
    n = 256
    x, y, z = rng.uniform(2e4, 8e4, n), rng.uniform(2e4, 8e4, n), rng.uniform(10.0, 90.0, n)
    kw = dict(flow="rotation", placement=placement, vertical=vertical, nx=24, ny=24,
              extent=1e5, maxdepth=100.0, nz=5)
    runs = {}
    for mode in ("off", "force"):
        fs = tp.FieldSet.from_ugrid_conventions(t_dataset(**kw), mesh="flat", device="cpu")
        misses = uxcache.ux_cached_eval.misses
        _, runs[mode] = _run(tp, fs, "AdvectionRK4", x, y, z, 900, DAY // 4, mode)
    assert uxcache.ux_cached_eval.misses > misses, "no lane missed its cached face"
    for g, r in zip(runs["force"][:3], runs["off"][:3]):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_array_equal(runs["force"][3], runs["off"][3])


def test_port_continues_from_the_reference_state():
    """The port takes the JAX package's fields, mesh tables and SoA (cache
    columns included) after one cached step and advances the next step as
    the JAX package does."""
    kw = dict(flow="rotation", placement="node", vertical="zf", nx=24, ny=24)
    jfs, tfs = _fieldsets(**kw)
    rng = np.random.default_rng(9)
    n = 100
    seeds = dict(x=rng.uniform(2e4, 8e4, n), y=rng.uniform(2e4, 8e4, n),
                 z=rng.uniform(10.0, 90.0, n), t=np.zeros(n))
    opts = dict(uxcache="force", uxcol="force")
    jset = jp.ParticleSet(jfs, **seeds)
    step = dict(dt=np.timedelta64(1800, "s"), runtime=np.timedelta64(1800, "s"))
    jset.execute(jp.AdvectionRK4, options=jp.EngineOptions(**opts), **step)
    with jp.EngineOptions(**opts).applied():
        jarr = jfs.device_arrays()
    farrays, soa = tp.state_from_numpy(
        {"fields": {k: np.asarray(v) for k, v in jarr["fields"].items()},
         "grids": [{k: np.asarray(v) for k, v in g.items()} for g in jarr["grids"]]},
        jset._data, "cpu",
    )
    with tp.EngineOptions(**opts).applied():
        own = tfs.device_arrays()
    for name, v in own["fields"].items():
        assert torch.equal(farrays["fields"][name], v), name
    for k, v in own["grids"][0].items():
        assert farrays["grids"][0][k].dtype == v.dtype, k
        assert torch.equal(farrays["grids"][0][k].view(torch.int32) if k == "face_table"
                           else farrays["grids"][0][k], v.view(torch.int32)
                           if k == "face_table" else v), k
    assert {k for k in soa if k.startswith("_uxc_")} == {"_uxc_key", "_uxc_u", "_uxc_v"}
    assert (soa["_uxc_key"][:n, 0] >= 0).all()
    tset = tp.ParticleSet(tfs, **seeds)
    tset._data = soa
    tset.execute(tp.AdvectionRK4, options=tp.EngineOptions(**opts), **step)
    jset.execute(jp.AdvectionRK4, options=jp.EngineOptions(**opts), **step)
    for v in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(tset, v), np.asarray(getattr(jset, v)), **TOL)
    np.testing.assert_array_equal(tset.state, np.asarray(jset.state))
    # the cached faces and brackets of the live lanes (the JAX package's
    # fixed-size repair round also rewrites its last, padding lane)
    np.testing.assert_array_equal(tset._data["_uxc_key"][:n].numpy(),
                                  np.asarray(jset._data["_uxc_key"])[:n])


def test_invalidated_cache_repairs_every_lane():
    """``stagecache.invalidate_soa_cache`` marks every lane's UGRID cache
    invalid (the C-grid key too, where present); the next step repairs every
    live lane and lands where an uninterrupted run does."""
    from parcels_tpu_torch.ops import stagecache

    kw = dict(flow="rotation", placement="face", vertical="zc", nx=20, ny=20)
    rng = np.random.default_rng(4)
    n = 64
    seeds = dict(x=rng.uniform(2e4, 8e4, n), y=rng.uniform(2e4, 8e4, n), z=np.full(n, 10.0),
                 t=np.zeros(n))
    step = dict(dt=np.timedelta64(900, "s"), runtime=np.timedelta64(900, "s"),
                options=tp.EngineOptions(**MODES["force"]))
    psets = []
    for invalidate in (False, True):
        fs = tp.FieldSet.from_ugrid_conventions(t_dataset(**kw), mesh="flat", device="cpu")
        pset = tp.ParticleSet(fs, **seeds)
        pset.execute(tp.AdvectionRK4, **step)
        if invalidate:
            before = pset._data[uxcache.UXC_KEY]
            pset._data = stagecache.invalidate_soa_cache(pset._data)
            key = pset._data[uxcache.UXC_KEY]
            assert (key[:, 0] == -1).all() and torch.equal(key[:, 1:], before[:, 1:])
            assert (before[:n, 0] >= 0).all(), "the invalidation changed a copy, not the SoA"
            misses = uxcache.ux_cached_eval.misses
        pset.execute(tp.AdvectionRK4, **step)
        psets.append(pset)
    assert uxcache.ux_cached_eval.misses - misses >= n
    for v in ("x", "y", "z", "state"):
        np.testing.assert_array_equal(getattr(psets[1], v), getattr(psets[0], v))
    np.testing.assert_array_equal(psets[1]._data[uxcache.UXC_KEY].numpy(),
                                  psets[0]._data[uxcache.UXC_KEY].numpy())


@pytest.mark.parametrize("mode", ["off", "force"])
def test_edge_riding_particle_survives(mode):
    """A particle advected exactly along a mesh edge (an unjittered row of
    the Delaunay mesh) does not error: the f32 in-face margin of
    tests/test_ux.py::test_edge_riding_particle_survives, in both tiers."""
    ds = t_dataset(flow="uniform", placement="node", vertical="zc", u0=1.0, v0=0.0)
    fs = tp.FieldSet.from_ugrid_conventions(ds, mesh="flat", device="cpu")
    ys = np.unique(np.round(fs.gridset[0].node_lat, 6))
    pset = tp.ParticleSet(fs, x=[5e3], y=[float(ys[len(ys) // 2])], z=[10.0], t=[0.0])
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(10, "m"), runtime=np.timedelta64(12, "h"),
                 options=tp.EngineOptions(**MODES[mode]))
    np.testing.assert_allclose(pset.x, 5e3 + 12 * 3600.0, rtol=1e-5)
    assert (pset.state == tp.StatusCode.EndofLoop).all()

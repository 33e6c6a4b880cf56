"""Rolling time-window streaming in the port against parcels_tpu.

Mirrors tests/test_windowing.py through ``parcels_tpu_torch`` on the CPU,
then holds the port's windowed runs against the JAX package's windowed runs
on the same inputs: trajectories at rtol 1e-6 (atol 1e-3 m, the tolerance
of tests/test_windowing.py) and ``window_stats`` equal; a backward-in-time
run; a curvilinear C-grid run with the stage cache forced, where the port's
invalidation at window rollover only equals invalidating every chunk (the
JAX package's rule) bit for bit; and a small UGRID run with the per-face
cache forced (rtol 1e-6, atol 1e-4 m, the tolerance of
tests/test_uxcache.py).
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import xrlite as jxr
from parcels_tpu.convert import nemo_to_sgrid as j_nemo
from parcels_tpu.datasets import moi_like_inputs as j_moi_inputs
from parcels_tpu.datasets import moving_eddy_dataset as j_eddy
from parcels_tpu.datasets.unstructured import delaunay_flow_dataset as j_delaunay
from parcels_tpu_torch import xrlite as txr
from parcels_tpu_torch._core import particleset as tparticleset
from parcels_tpu_torch.convert import nemo_to_sgrid as t_nemo
from parcels_tpu_torch.datasets import moi_like_inputs as t_moi_inputs
from parcels_tpu_torch.datasets import moving_eddy_dataset
from parcels_tpu_torch.datasets import simple_UV_dataset
from parcels_tpu_torch.datasets.unstructured import delaunay_flow_dataset as t_delaunay
from parcels_tpu_torch.ops import stagecache, uxcache

TOL = dict(rtol=1e-6, atol=1e-3)


def _eddy(device="cpu"):
    return tp.FieldSet.from_sgrid_conventions(moving_eddy_dataset(), mesh="flat", device=device)


def _run(fs, runtime_h=6):
    pset = tp.ParticleSet(fs, x=[12000.0, 15000.0], y=[12500.0, 9000.0], t=[0.0, 0.0])
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(runtime_h, "h"))
    return np.stack([pset.x, pset.y])


# -- the tests of tests/test_windowing.py, through the port -------------------


def test_windowed_matches_resident():
    fs_win = _eddy()
    fs_win.set_time_window(16)
    np.testing.assert_allclose(_run(fs_win), _run(_eddy()), **TOL)
    stats = fs_win.window_stats
    assert stats["loads"] >= 2  # window advanced at least once
    # each load is a (L, Z, Y, X) f32 slab, far below the full 420-level array
    assert stats["bytes_read"] < 2 * 420 * 2 * 2 * 4 * 10


def test_window_advances_with_output_chunks(tmp_path):
    fs = _eddy()
    fs.set_time_window(16)  # 16 minutes of 1-min levels
    pset = tp.ParticleSet(fs, x=[12000.0], y=[12500.0], t=[0.0])
    pf = tp.ParticleFile(tmp_path / "w.parquet", outputdt=np.timedelta64(10, "m"), mode="w")
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(3, "h"),
                 output_file=pf)
    pf.close()
    assert pset.t[0] == 3 * 3600
    assert fs.window_stats["loads"] > 5


def test_tiny_window_subchunks_automatically():
    """Even a minimal window works: execute sub-chunks to window capacity."""
    fs = _eddy()
    fs.set_time_window(4)  # only 4 minutes of levels resident at a time
    pset = tp.ParticleSet(fs, x=[12000.0], y=[12500.0], t=[0.0])
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(1, "m"), runtime=np.timedelta64(1, "h"))
    p_full = tp.ParticleSet(_eddy(), x=[12000.0], y=[12500.0], t=[0.0])
    p_full.execute(tp.AdvectionRK4, dt=np.timedelta64(1, "m"), runtime=np.timedelta64(1, "h"))
    assert pset.t[0] == 3600.0
    np.testing.assert_allclose(pset.x, p_full.x, **TOL)
    np.testing.assert_allclose(pset.y, p_full.y, **TOL)
    assert fs.window_stats["loads"] >= 2 * 15  # ~20 window advances x2 fields


def test_set_time_window_validates():
    with pytest.raises(ValueError):
        _eddy().set_time_window(1)


def test_prefetch_window_stages_next_and_is_consumed():
    """prefetch_window builds the next window on a thread; windowed_arrays
    consumes the staged result instead of re-loading."""
    fs = _eddy()
    fs.set_time_window(8)
    fs.windowed_arrays(0.0, 300.0)
    fs.prefetch_window(8 * 60.0)  # next window anchor
    futs = fs._window.futures
    assert len(futs) == 1
    next(iter(futs.values())).result(timeout=60)  # wait for the background build
    loads_before = fs.window_stats["loads"]
    a1 = fs.windowed_arrays(8 * 60.0, 10 * 60.0)
    assert fs.window_stats["loads"] == loads_before  # consumed, not re-built
    assert not fs._window.futures
    # staged window content identical to a fresh synchronous load
    fs2 = _eddy()
    fs2.set_time_window(8)
    b1 = fs2.windowed_arrays(8 * 60.0, 10 * 60.0)
    np.testing.assert_array_equal(a1["fields"]["U"].numpy(), b1["fields"]["U"].numpy())


def test_prefetch_mispredict_harmless():
    fs = _eddy()
    fs.set_time_window(8)
    fs.prefetch_window(100 * 60.0)  # way off
    out = fs.windowed_arrays(0.0, 300.0)  # sync load still correct
    assert out["fields"]["U"].shape[0] == 8


def test_execute_holds_at_most_two_windows(monkeypatch):
    """While a chunk runs, the execute loop holds the window it reads and the
    successor being staged, and no other: the window before them is gone."""
    import gc
    import weakref

    from parcels_tpu_torch._core import windowing

    fs = _eddy()
    fs.set_time_window(8)
    windows, live = [], []
    stage, chunk = windowing.Stager.stage, tparticleset.run_chunk

    def recorded(self, parts):
        window = stage(self, parts)
        windows.append([weakref.ref(t) for t in window.tensors.values()])
        return window

    def counted_chunk(*a, **kw):
        for fut in list(fs._window.futures.values()):
            fut.result(timeout=60)  # the successor has landed
        gc.collect()
        live.append(sum(any(r() is not None for r in refs) for refs in windows))
        return chunk(*a, **kw)

    monkeypatch.setattr(windowing.Stager, "stage", recorded)
    monkeypatch.setattr(tparticleset, "run_chunk", counted_chunk)
    _run(fs, runtime_h=1)
    assert len(windows) >= 4
    assert max(live) == 2


def test_to_windowed_arrays_reference_alias():
    """Reference API name (fieldset.py:165): chaining, idempotence, no-op on
    fieldsets already smaller than the window."""
    fs = _eddy()
    assert fs.to_windowed_arrays(max_levels=4) is fs
    assert fs._time_window == 4
    assert fs.to_windowed_arrays(max_levels=4) is fs  # idempotent
    p1 = tp.ParticleSet(fs, x=[12000.0], y=[12500.0], t=[np.timedelta64(0, "s")])
    p2 = tp.ParticleSet(_eddy(), x=[12000.0], y=[12500.0], t=[np.timedelta64(0, "s")])
    for p in (p1, p2):
        p.execute(tp.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(30, "m"))
    np.testing.assert_allclose(p1.x, p2.x, rtol=1e-6)
    # a 2-level fieldset is already <= the default window: no-op
    fs3 = tp.FieldSet.from_sgrid_conventions(
        simple_UV_dataset(dims=(2, 2, 8, 8), mesh="flat"), mesh="flat", device="cpu")
    assert fs3.to_windowed_arrays() is fs3
    assert fs3._time_window is None


# -- the port's window machinery ----------------------------------------------


def test_window_tensors_match_levels_and_time_search_is_searched():
    fs = _eddy()
    u = np.asarray(moving_eddy_dataset()["U"].values, dtype=np.float32)
    assert fs.gridset[0].spec.time_uniform is not None
    fs.set_time_window(3)
    assert fs.gridset[0].spec.time_uniform is None  # the window's axis is bracketed
    a = fs.windowed_arrays(125.0, 130.0)
    np.testing.assert_array_equal(a["fields"]["U"].numpy(), u[2:5])
    np.testing.assert_array_equal(a["grids"][0]["time"].numpy(), [120.0, 180.0, 240.0])
    assert fs._device_shape(fs.fields["U"]) == (3,) + u.shape[1:]
    b = fs.windowed_arrays(185.0, 190.0)
    # each window is a fresh block: the first one's tensors are unchanged
    assert a["fields"]["U"].data_ptr() != b["fields"]["U"].data_ptr()
    np.testing.assert_array_equal(a["fields"]["U"].numpy(), u[2:5])
    assert fs.window_stats == {"loads": 4, "bytes_read": 4 * 3 * 2 * 2 * 4}


def test_worker_exception_reaches_the_caller(monkeypatch):
    fs = _eddy()
    fs.set_time_window(8)

    def broken(offsets):
        raise OSError("disk gone")

    monkeypatch.setattr(fs, "_build_window", broken)
    fs.prefetch_window(8 * 60.0)
    with pytest.raises(OSError, match="disk gone"):
        fs.windowed_arrays(8 * 60.0, 10 * 60.0)


# -- the port's windowed runs against the JAX package's ------------------------


def _jax_run(fs, x, y, t0, dt_min, runtime_h):
    pset = jp.ParticleSet(fs, x=x, y=y, t=[t0] * len(x))
    pset.execute(jp.AdvectionRK4, dt=np.timedelta64(dt_min, "m"),
                 runtime=np.timedelta64(runtime_h, "h"))
    return np.stack([pset.x, pset.y])


def _port_run(fs, x, y, t0, dt_min, runtime_h):
    pset = tp.ParticleSet(fs, x=x, y=y, t=[t0] * len(x))
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(dt_min, "m"),
                 runtime=np.timedelta64(runtime_h, "h"))
    return np.stack([pset.x, pset.y])


def test_port_windowed_matches_jax_windowed():
    x, y = [12000.0, 15000.0, 9000.0], [12500.0, 9000.0, 14000.0]
    jfs = jp.FieldSet.from_sgrid_conventions(j_eddy(), mesh="flat")
    jfs.set_time_window(16)
    tfs = _eddy()
    tfs.set_time_window(16)
    ref = _jax_run(jfs, x, y, 0.0, 5, 4)
    got = _port_run(tfs, x, y, 0.0, 5, 4)
    np.testing.assert_allclose(got, ref, **TOL)
    assert tfs.window_stats == jfs.window_stats


def test_backward_windowed_matches_jax_and_resident():
    """dt < 0: windows end at the anchor, the prefetch anchors at an estimate."""
    x, y = [12000.0, 15000.0], [12500.0, 9000.0]
    jfs = jp.FieldSet.from_sgrid_conventions(j_eddy(), mesh="flat")
    jfs.set_time_window(16)
    tfs = _eddy()
    tfs.set_time_window(16)
    ref = _jax_run(jfs, x, y, 5 * 3600.0, -5, 3)
    got = _port_run(tfs, x, y, 5 * 3600.0, -5, 3)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, _port_run(_eddy(), x, y, 5 * 3600.0, -5, 3), **TOL)
    assert tfs.window_stats["loads"] >= 2 * 10  # 3 h of 1-min levels, 16 a window
    assert tfs.max_window_endtime(5 * 3600.0, -1) == 5 * 3600.0 - 15 * 60.0


def _moi(mod_inputs, nemo, tdim=5):
    fields, coords = mod_inputs(xdim=60, ydim=40, zdim=3, tdim=tdim, seed=2)
    return nemo(fields=fields, coords=coords)


def test_cgrid_windowed_stage_cache_rollover_invalidation(monkeypatch):
    """The port invalidates the persistent cell cache only when the window's
    offsets change; the JAX package at every windowed chunk. Both give the
    same trajectories, bit for bit, and those of the JAX windowed run."""
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-150.0, 150.0, 64), rng.uniform(-60.0, 60.0, 64)
    opts = dict(stagecache="force")

    def port(every_chunk):
        fs = tp.FieldSet.from_sgrid_conventions(_moi(t_moi_inputs, t_nemo), device="cpu")
        fs.set_time_window(2)
        calls = {"invalidate": 0, "chunks": 0}
        inv, chunk = stagecache.invalidate_soa_cache, tparticleset.run_chunk

        def counted_inv(dev):
            calls["invalidate"] += 1
            return inv(dev)

        def counted_chunk(fs_, kernels, farrays, dev, *a, **kw):
            calls["chunks"] += 1
            return chunk(fs_, kernels, farrays, counted_inv(dev) if every_chunk else dev, *a, **kw)

        monkeypatch.setattr(stagecache, "invalidate_soa_cache", counted_inv)
        monkeypatch.setattr(tparticleset, "run_chunk", counted_chunk)
        checked = stagecache.cgrid_cached_eval.checked_lanes
        pset = tp.ParticleSet(fs, x=x, y=y, z=np.full(64, 1.0), t=np.zeros(64))
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(3, "h"), runtime=np.timedelta64(3, "D"),
                     options=tp.EngineOptions(**opts))
        monkeypatch.undo()
        assert stagecache.cgrid_cached_eval.checked_lanes > checked, "the stage cache did not run"
        assert stagecache.SC_KEY in pset._data
        return pset, calls

    rollover, c_roll = port(every_chunk=False)
    every, c_every = port(every_chunk=True)
    assert c_roll["invalidate"] == 3  # one per daily window of the 3-day run
    assert c_roll["chunks"] > c_roll["invalidate"]
    assert c_every["invalidate"] >= c_every["chunks"]
    for v in ("x", "y", "z", "state"):
        np.testing.assert_array_equal(getattr(rollover, v), getattr(every, v))

    jfs = jp.FieldSet.from_sgrid_conventions(_moi(j_moi_inputs, j_nemo))
    jfs.set_time_window(2)
    jset = jp.ParticleSet(jfs, x=x, y=y, z=np.full(64, 1.0), t=np.zeros(64))
    jset.execute(jp.AdvectionRK4, dt=np.timedelta64(3, "h"), runtime=np.timedelta64(3, "D"),
                 options=jp.EngineOptions(**opts))
    # the curvilinear search in another f32 order (tests/test_torch_stagecache.py)
    np.testing.assert_allclose(rollover.x, jset.x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rollover.y, jset.y, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(rollover.state, jset.state)


def _ux_timevarying(xr_mod, dataset):
    """The rotation dataset over 4 six-hourly levels, flow scaled per level."""
    base = dataset(flow="rotation", placement="node", vertical="zf", nx=12, ny=12)
    time = np.datetime64("2000-01-01") + np.arange(4) * np.timedelta64(6, "h")
    scale = np.array([1.0, 1.2, 0.8, 1.1], np.float32)[:, None, None]
    data_vars = {c: (("time", "zf", "n_node"), np.repeat(np.asarray(base[c].values[:1]), 4, 0)
                     * scale) for c in ("U", "V")}
    coords = {k: (base[k].dims, np.asarray(base[k].values), dict(base[k].attrs))
              for k in ("zf", "zc", "node_lon", "node_lat")}
    coords["time"] = (("time",), time)
    ds = xr_mod.Dataset(data_vars, coords=coords, attrs=dict(base.attrs))
    ds["face_node_connectivity"] = base["face_node_connectivity"]
    return ds


def test_ugrid_windowed_with_uxcache_matches_jax():
    rng = np.random.default_rng(5)
    n = 32
    x, y = rng.uniform(3e4, 7e4, n), rng.uniform(3e4, 7e4, n)
    z = np.full(n, 10.0)
    opts = dict(uxcache="force", uxcol="force")
    runs = {}
    for mod, xr_mod, dataset, kw in ((tp, txr, t_delaunay, dict(device="cpu")),
                                     (jp, jxr, j_delaunay, {})):
        fs = mod.FieldSet.from_ugrid_conventions(_ux_timevarying(xr_mod, dataset), mesh="flat",
                                                 **kw)
        fs.set_time_window(2)
        pset = mod.ParticleSet(fs, x=x, y=y, z=z, t=np.zeros(n))
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(10, "m"), runtime=np.timedelta64(15, "h"),
                     options=mod.EngineOptions(**opts))
        runs[mod.__name__] = (pset, fs.window_stats)
    (tset, tstats), (jset, jstats) = runs["parcels_tpu_torch"], runs["parcels_tpu"]
    assert uxcache.UXC_KEY in tset._data
    for v in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(tset, v), getattr(jset, v), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(tset.state, jset.state)
    assert tstats == jstats and tstats["loads"] == 2 * 3


def test_window_time_bracket_matches_jax_and_differs_from_the_uniform_one():
    """A window brackets t by searching its f32 time values; the resident
    uniform axis by the O(1) formula. The port equals the JAX package bit for
    bit in each, and the two differ in tau's last bits (which a long run on a
    random field grows: ``scripts/window_time_spread.py``)."""
    import jax.numpy as jnp

    from parcels_tpu._core import index_search as jis
    from parcels_tpu_torch._core import index_search as tis

    taxis = np.arange(13) * 3600.0
    t = np.arange(0.0, 12 * 3600.0 + 1, 120.0, dtype=np.float32)
    uniform = (0.0, 3600.0, 12 * 3600.0)
    t_u = tis.search_time(torch.from_numpy(taxis.astype(np.float32)), torch.from_numpy(t), uniform)
    j_u = jis.search_time(jnp.asarray(taxis.astype(np.float32)), jnp.asarray(t), uniform)
    for a, b in zip(t_u, j_u):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    differ = 0
    for i0 in range(12):  # the 2-level windows of a forward run
        win = taxis[i0:i0 + 2].astype(np.float32)
        sel = (t >= win[0]) & (t <= win[1])
        t_w = tis.search_time(torch.from_numpy(win), torch.from_numpy(t[sel]))
        j_w = jis.search_time(jnp.asarray(win), jnp.asarray(t[sel]))
        for a, b in zip(t_w, j_w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pos_w = i0 + t_w[0].numpy() + t_w[1].numpy()
        pos_u = t_u[0].numpy()[sel] + t_u[1].numpy()[sel]
        np.testing.assert_allclose(pos_w, pos_u, rtol=0, atol=2e-6)
        differ += int((t_w[1].numpy() != (pos_u - i0 - t_w[0].numpy())).sum())
    assert differ > 0

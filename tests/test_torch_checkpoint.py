"""Checkpoint and restart in the port, against parcels_tpu.

Mirrors tests/test_engine.py::test_checkpoint_roundtrip and
::test_restart_from_particlefile through ``parcels_tpu_torch`` (rtol 1e-6,
their tolerance). Then: a checkpoint taken halfway through a windowed run
(zarr store, C-grid with the stage cache's columns) restarts to the
uninterrupted run's state bit for bit; and a checkpoint written by the JAX
package loads in the port with the same SoA (every column, dtype and
shape: the two packages share the column set) and continues to the JAX
package's continuation (rtol 1e-6 on the moving eddy; on the curvilinear
C-grid rtol/atol 1e-5, the tolerance of tests/test_torch_stagecache.py,
since the search runs the same f32 operations in another order).
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu.convert import nemo_to_sgrid as j_nemo
from parcels_tpu.datasets import moi_like_inputs as j_moi_inputs
from parcels_tpu.datasets import moving_eddy_dataset as j_eddy
from parcels_tpu_torch.convert import nemo_to_sgrid as t_nemo
from parcels_tpu_torch.datasets import moi_like_inputs as t_moi_inputs
from parcels_tpu_torch.datasets import moving_eddy_dataset
from parcels_tpu_torch.io import open_zarr_dataset, write_zarr_dataset
from parcels_tpu_torch.ops import stagecache

X0, Y0 = [12000.0, 15000.0], [12500.0, 9000.0]
STEP = np.timedelta64(5, "m")


def _eddy_fs():
    return tp.FieldSet.from_sgrid_conventions(moving_eddy_dataset(), mesh="flat", device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    pset = tp.ParticleSet(_eddy_fs(), x=X0, y=Y0, t=[0.0, 0.0])
    pset.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(1, "h"))
    path = str(tmp_path / "ckpt.npz")
    pset.checkpoint(path)

    restored = tp.ParticleSet.from_checkpoint(_eddy_fs(), path)
    np.testing.assert_array_equal(restored.x, pset.x)
    np.testing.assert_array_equal(restored.particle_id, pset.particle_id)
    restored.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(1, "h"))

    straight = tp.ParticleSet(_eddy_fs(), x=X0, y=Y0, t=[0.0, 0.0])
    straight.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(2, "h"))
    np.testing.assert_allclose(restored.x, straight.x, rtol=1e-6)


def test_restart_from_particlefile(tmp_path):
    pset = tp.ParticleSet(_eddy_fs(), x=X0, y=Y0, t=[0.0, 0.0])
    path = str(tmp_path / "traj.parquet")
    pf = tp.ParticleFile(path, outputdt=np.timedelta64(30, "m"), mode="w")
    pset.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(1, "h"), output_file=pf)
    pf.close()

    restarted = tp.ParticleSet.from_particlefile(_eddy_fs(), tp.Particle, path, restart=True)
    np.testing.assert_array_equal(np.sort(restarted.particle_id), [0, 1])
    np.testing.assert_allclose(np.sort(restarted.x), np.sort(pset.x), rtol=1e-6)
    np.testing.assert_array_equal(restarted.t, [3600.0, 3600.0])


def test_checkpoint_keeps_the_device_and_every_column(tmp_path):
    pset = tp.ParticleSet(_eddy_fs(), x=X0, y=Y0, t=[0.0, 0.0], seed=3)
    pset.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(30, "m"))
    path = str(tmp_path / "ckpt.npz")
    pset.checkpoint(path)
    restored = tp.ParticleSet.from_checkpoint(_eddy_fs(), path)
    assert set(restored._data) == set(pset._data)
    for k, v in pset._data.items():
        w = restored._data[k]
        assert w.dtype == v.dtype and w.device == (torch.device("cpu") if k == "_rng" else v.device)
        torch.testing.assert_close(w, v, rtol=0, atol=0)
    assert restored._data["_rng"].dtype == torch.uint32 and restored._data["_rng"].shape == (2,)


def test_windowed_restart_from_the_store_equals_the_uninterrupted_run(tmp_path):
    store = str(tmp_path / "eddy.zarr")
    write_zarr_dataset(moving_eddy_dataset(), store)

    def streamed():
        fs = tp.FieldSet.from_sgrid_conventions(open_zarr_dataset(store), mesh="flat", device="cpu")
        return fs.set_time_window(16)

    x0, y0 = [12000.0, 15000.0, 9000.0], [12500.0, 9000.0, 14000.0]
    straight = tp.ParticleSet(streamed(), x=x0, y=y0, t=[0.0] * 3)
    straight.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(4, "h"))

    half = tp.ParticleSet(streamed(), x=x0, y=y0, t=[0.0] * 3)
    half.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(2, "h"))
    path = str(tmp_path / "half.npz")
    half.checkpoint(path)
    resumed = tp.ParticleSet.from_checkpoint(streamed(), path)
    resumed.execute(tp.AdvectionRK4, dt=STEP, runtime=np.timedelta64(2, "h"))
    for v in ("x", "y", "t", "state", "particle_id"):
        np.testing.assert_array_equal(getattr(resumed, v), getattr(straight, v))


def _moi(inputs, nemo):
    fields, coords = inputs(xdim=60, ydim=40, zdim=3, tdim=4, seed=2)
    return nemo(fields=fields, coords=coords)


def test_cgrid_windowed_restart_keeps_the_stage_cache_columns(tmp_path):
    rng = np.random.default_rng(4)
    n = 48
    seeds = dict(x=rng.uniform(-150.0, 150.0, n), y=rng.uniform(-60.0, 60.0, n),
                 z=np.full(n, 1.0), t=np.zeros(n))
    opts = tp.EngineOptions(stagecache="force")

    def windowed():
        fs = tp.FieldSet.from_sgrid_conventions(_moi(t_moi_inputs, t_nemo), device="cpu")
        return fs.set_time_window(2)

    dt = np.timedelta64(4, "h")
    straight = tp.ParticleSet(windowed(), **seeds)
    straight.execute(tp.AdvectionRK4, dt=dt, runtime=np.timedelta64(2, "D"), options=opts)
    half = tp.ParticleSet(windowed(), **seeds)
    # 28 h: inside the second daily window, where the uninterrupted run keeps
    # its cache entries and the resumed one starts from invalidated ones
    half.execute(tp.AdvectionRK4, dt=dt, runtime=np.timedelta64(28, "h"), options=opts)
    path = str(tmp_path / "cgrid.npz")
    half.checkpoint(path)
    resumed = tp.ParticleSet.from_checkpoint(windowed(), path)
    cache_cols = {k for k in resumed._data if k.startswith("_sc_")}
    assert cache_cols == {stagecache.SC_KEY, "_sc_u4", "_sc_v4"}
    resumed.execute(tp.AdvectionRK4, dt=dt, runtime=np.timedelta64(20, "h"), options=opts)
    for v in ("x", "y", "z", "state"):
        np.testing.assert_array_equal(getattr(resumed, v), getattr(straight, v))


@pytest.mark.parametrize("case", ["eddy", "cgrid"])
def test_jax_checkpoint_continues_in_the_port(tmp_path, case):
    if case == "eddy":
        jfs = lambda: jp.FieldSet.from_sgrid_conventions(j_eddy(), mesh="flat")  # noqa: E731
        tfs = _eddy_fs
        seeds = dict(x=X0, y=Y0, t=[0.0, 0.0])
        dt, half, opts, tol = STEP, np.timedelta64(1, "h"), {}, dict(rtol=1e-6)
    else:
        jfs = lambda: jp.FieldSet.from_sgrid_conventions(_moi(j_moi_inputs, j_nemo))  # noqa: E731
        tfs = lambda: tp.FieldSet.from_sgrid_conventions(  # noqa: E731
            _moi(t_moi_inputs, t_nemo), device="cpu")
        rng = np.random.default_rng(6)
        seeds = dict(x=rng.uniform(-150.0, 150.0, 32), y=rng.uniform(-60.0, 60.0, 32),
                     z=np.full(32, 1.0), t=np.zeros(32))
        dt, half = np.timedelta64(4, "h"), np.timedelta64(1, "D")
        opts, tol = dict(stagecache="force"), dict(rtol=1e-5, atol=1e-5)

    jset = jp.ParticleSet(jfs(), **seeds)
    jset.execute(jp.AdvectionRK4, dt=dt, runtime=half, options=jp.EngineOptions(**opts))
    path = str(tmp_path / "jax.npz")
    jset.checkpoint(path)

    restored = tp.ParticleSet.from_checkpoint(tfs(), path)
    assert set(restored._data) == set(jset._data)
    for k, v in jset._data.items():
        got = restored._data[k].cpu().numpy()
        assert got.dtype == np.asarray(v).dtype and got.shape == np.asarray(v).shape, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    if case == "cgrid":
        assert stagecache.SC_KEY in restored._data

    jset.execute(jp.AdvectionRK4, dt=dt, runtime=half, options=jp.EngineOptions(**opts))
    restored.execute(tp.AdvectionRK4, dt=dt, runtime=half, options=tp.EngineOptions(**opts))
    for v in ("x", "y"):
        np.testing.assert_allclose(getattr(restored, v), getattr(jset, v), **tol)
    np.testing.assert_array_equal(restored.state, jset.state)
    np.testing.assert_array_equal(restored.particle_id, jset.particle_id)

"""One run, whatever its chunks: ``ParticleSet.execute`` on the sorted K2
path gives the same bits however the run is cut.

A random (4, 6, 40, 1100) U/V/W field is past K1's fold, so with the binned
sampler forced the engine sorts the SoA at every chunk start and every
``RESORT_EVERY`` steps and K2 (its plain version here) samples it. The same
4000 lanes run 3 h at dt 300 s, with ``AdvectionRK4_3D`` alone and with
``DiffusionUniformKh`` (10 m^2/s) after it, and an age variable. Every case
is held bit for bit to the run in chunks of 64 steps (``chunk_target_seconds=0``
keeps the wall clock out of the chunk lengths): chunks of 7 and of 1 step,
blocks of 1024 lanes, two ``execute`` calls of 1.5 h, and a checkpoint
restart at 1.5 h.
"""

import functools

import numpy as np
import pytest
import torch

import parcels_tpu_torch as tp
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch.datasets.structured import _coords_2d, _wrap_sgrid

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

SHAPE = (4, 6, 40, 1100)
N = 4000
DT = np.timedelta64(300, "s")
HOURS = 3
KH = 10.0
VARS = ("x", "y", "z", "t", "dt", "state", "particle_id", "age")


@functools.lru_cache(maxsize=None)
def _dataset():
    T, Z, Y, X = SHAPE
    rng = np.random.default_rng(0)
    dims = ["time", "depth", "YG", "XG"]
    data = {c: (dims, rng.uniform(-0.3, 0.3, SHAPE).astype(np.float32)) for c in ("U", "V")}
    data["W"] = (dims, rng.uniform(-3e-4, 3e-4, SHAPE).astype(np.float32))
    taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s")
                      for i in range(T)])
    coords = _coords_2d(np.linspace(0.0, 1000.0 * (X - 1), X), np.linspace(0.0, 1000.0 * (Y - 1), Y),
                        time=taxis, depth=np.linspace(0.0, 50.0, Z), mesh="flat")
    return _wrap_sgrid(xr.Dataset(data, coords=coords), X, Y)


def _fieldset():
    fs = tp.FieldSet.from_sgrid_conventions(_dataset(), mesh="flat", device="cpu")
    fs.add_constant_field("Kh_zonal", KH, mesh="flat")
    fs.add_constant_field("Kh_meridional", KH, mesh="flat")
    return fs


def Age(particles, fieldset):  # noqa: N802
    particles.age = particles.age + particles.dt


KERNELS = {
    "rk4_3d": [tp.AdvectionRK4_3D, Age],
    "rk4_3d_kh": [tp.AdvectionRK4_3D, tp.DiffusionUniformKh, Age],
}


def _pset(fs):
    rng = np.random.default_rng(1)
    pclass = tp.Particle.add_variable(tp.Variable("age", dtype=np.float32))
    return tp.ParticleSet(fs, pclass=pclass, x=rng.uniform(5e3, 1.09e6, N),
                          y=rng.uniform(8e3, 31e3, N), z=rng.uniform(5.0, 45.0, N),
                          t=np.zeros(N), seed=3)


def _execute(pset, kernels, hours, chunk_steps):
    pset.execute(KERNELS[kernels], dt=DT, runtime=np.timedelta64(int(hours * 3600), "s"),
                 options=tp.EngineOptions(sampler="binned", max_chunk_steps=chunk_steps,
                                          chunk_target_seconds=0))
    return pset


@functools.lru_cache(maxsize=None)
def _reference(kernels):
    return _execute(_pset(_fieldset()), kernels, HOURS, 64)


def _run(case, kernels, monkeypatch, tmp_path):
    fs = _fieldset()
    if case == "chunks_7":
        return _execute(_pset(fs), kernels, HOURS, 7)
    if case == "chunks_1":
        return _execute(_pset(fs), kernels, HOURS, 1)
    if case == "blocks":
        from parcels_tpu_torch._core import engine, particleset

        monkeypatch.setattr(engine, "DEFAULT_BLOCK_SIZE", 1024)
        monkeypatch.setattr(particleset, "DEFAULT_BLOCK_SIZE", 1024)
        pset = _execute(_pset(fs), kernels, HOURS, 7)
        assert pset._data["x"].shape[0] == 4096  # four blocks
        return pset
    first = _execute(_pset(fs), kernels, HOURS / 2, 64)
    if case == "restart":
        first.checkpoint(tmp_path / "half.npz")
        first = tp.ParticleSet.from_checkpoint(_fieldset(), tmp_path / "half.npz",
                                               pclass=first._pclass)
    return _execute(first, kernels, HOURS / 2, 64)


@pytest.mark.parametrize("kernels", sorted(KERNELS))
@pytest.mark.parametrize("case", ["chunks_7", "chunks_1", "blocks", "split_execute", "restart"])
def test_sorted_k2_run_is_independent_of_its_chunks(case, kernels, monkeypatch, tmp_path):
    ref = _reference(kernels)
    got = _run(case, kernels, monkeypatch, tmp_path)
    for v in VARS:
        np.testing.assert_array_equal(getattr(got, v), getattr(ref, v), err_msg=f"{case}: {v}")
    assert len(ref) == N and np.all(ref.state == tp.StatusCode.EndofLoop)
    assert np.abs(ref.y - _pset(_fieldset()).y).min() > 0  # every particle moved

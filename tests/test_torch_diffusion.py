"""The advection-diffusion kernels and the engine RNG of the port.

The port's draws come from torch generators (mt19937 on the CPU, Philox on
the card), not from the JAX package's threefry, so its runs are held to
``tests/test_diffusion.py``'s moment statistics at that file's tolerances,
and, with identical draws handed to both packages, to ``parcels_tpu``'s
trajectories at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu._core import particles_view as j_view
from parcels_tpu.datasets import simple_UV_dataset as j_simple_uv
from parcels_tpu_torch._core import engine as t_engine
from parcels_tpu_torch._core import particles_view as t_view
from parcels_tpu_torch._core import particleset as t_particleset
from parcels_tpu_torch.datasets import simple_UV_dataset as t_simple_uv

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

KH = 100.0  # m^2/s
N = 4000
HOURS = 6
T = HOURS * 3600.0


def _flow_fs(pkg, u=0.0, v=0.0, kh=KH, dres=None):
    if pkg is tp:
        ds = t_simple_uv(dims=(2, 2, 32, 32), mesh="flat")
        kw = {"device": "cpu"}
    else:
        ds = j_simple_uv(dims=(2, 2, 32, 32), mesh="flat")
        kw = {}
    ds["U"].values[:] = u
    ds["V"].values[:] = v
    fs = pkg.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw)
    fs.add_constant_field("Kh_zonal", kh, mesh="flat")
    fs.add_constant_field("Kh_meridional", kh, mesh="flat")
    if dres is not None:
        fs.add_context("dres", dres)
    return fs


def _run(fs, kernel, pkg=tp, seed=1, n=N, hours=HOURS, x=0.0):
    pset = pkg.ParticleSet(fs, x=np.full(n, x), y=np.zeros(n), t=np.zeros(n), seed=seed)
    pset.execute(kernel, dt=np.timedelta64(10, "m"), runtime=np.timedelta64(hours, "h"))
    return pset


def test_uniform_kh_variance():
    """Pure diffusion: Var[x] = 2 Kh t; mean stays at the origin."""
    pset = _run(_flow_fs(tp), tp.DiffusionUniformKh)
    for arr in (pset.x, pset.y):
        assert abs(arr.mean()) < 4 * np.sqrt(2 * KH * T / N)
        np.testing.assert_allclose(arr.var(), 2 * KH * T, rtol=0.1)


@pytest.mark.parametrize("name", ["AdvectionDiffusionEM", "AdvectionDiffusionM1"])
def test_advection_diffusion_moments(name):
    """Uniform flow + constant Kh: mean = u t, variance = 2 Kh t."""
    u = 0.2
    pset = _run(_flow_fs(tp, u=u, dres=10000.0), getattr(tp, name))
    np.testing.assert_allclose(pset.x.mean(), u * T, rtol=0.05)
    np.testing.assert_allclose(pset.x.var(), 2 * KH * T, rtol=0.12)
    np.testing.assert_allclose(pset.y.var(), 2 * KH * T, rtol=0.12)


def test_rng_reproducible_and_seed_sensitive():
    a = _run(_flow_fs(tp), tp.DiffusionUniformKh, seed=7)
    b = _run(_flow_fs(tp), tp.DiffusionUniformKh, seed=7)
    c = _run(_flow_fs(tp), tp.DiffusionUniformKh, seed=8)
    np.testing.assert_array_equal(a.x, b.x)
    assert not np.allclose(a.x, c.x)


@pytest.mark.parametrize("name", ["DiffusionUniformKh", "AdvectionDiffusionEM",
                                  "AdvectionDiffusionM1"])
def test_zero_kh_matches_reference(name):
    """Kh = 0: DiffusionUniformKh does not move (the JAX test's closed
    form); EM and M1 are pure Euler advection. Each equals the JAX run to
    rtol 1e-5."""
    runs = {}
    for pkg in (tp, jp):
        fs = _flow_fs(pkg, u=1.0, v=0.25, kh=0.0, dres=10000.0)
        pset = pkg.ParticleSet(fs, x=np.linspace(-5e5, 5e5, 4), y=np.zeros(4), t=np.zeros(4))
        pset.execute(getattr(pkg, name), dt=np.timedelta64(10, "m"),
                     runtime=np.timedelta64(1, "h"))
        runs[pkg] = pset
    a, b = runs[tp], runs[jp]
    if name == "DiffusionUniformKh":
        np.testing.assert_allclose(a.x, np.linspace(-5e5, 5e5, 4), atol=1e-6)
    else:
        np.testing.assert_allclose(a.x, np.linspace(-5e5, 5e5, 4) + 3600.0, rtol=1e-5)
    for var in ("x", "y"):
        np.testing.assert_allclose(getattr(a, var), getattr(b, var), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(a.state, b.state)


def test_diffusion_spherical_moments():
    """Euler-Maruyama on a spherical mesh: displacement variance matches
    2*Kh*t after the m^2 -> deg^2 conversion (zonal variance scales by
    1/cos(lat)^2)."""
    kh, lat0, n = 50.0, 45.0, 4000
    ds = t_simple_uv(dims=(2, 2, 30, 30), mesh="spherical")
    fs = tp.FieldSet.from_sgrid_conventions(ds, mesh="spherical", device="cpu")
    fs.add_constant_field("Kh_zonal", kh)
    fs.add_constant_field("Kh_meridional", kh)
    fs.add_context("dres", 0.01)
    pset = tp.ParticleSet(fs, x=np.zeros(n), y=np.full(n, lat0), t=np.zeros(n))
    t = 12 * 3600.0
    pset.execute(tp.AdvectionDiffusionEM, dt=np.timedelta64(600, "s"),
                 runtime=np.timedelta64(12, "h"))
    deg2m = tp.EARTH_RADIUS * np.pi / 180.0
    var_x_m = np.var(pset.x * deg2m * np.cos(np.deg2rad(lat0)))
    var_y_m = np.var((pset.y - lat0) * deg2m)
    exp = 2 * kh * t
    assert abs(var_x_m - exp) / exp < 0.15, (var_x_m, exp)
    assert abs(var_y_m - exp) / exp < 0.15, (var_y_m, exp)


def test_blocks_draw_different_numbers(monkeypatch):
    """Two blocks of identical particles: each block's key is split from the
    SoA key, so their draws (and positions) differ. A key shared by every
    block would make the two halves equal."""
    block = 8192
    monkeypatch.setattr(t_engine, "DEFAULT_BLOCK_SIZE", block)
    monkeypatch.setattr(t_particleset, "DEFAULT_BLOCK_SIZE", block)
    pset = _run(_flow_fs(tp), tp.DiffusionUniformKh, n=2 * block, hours=1)
    x = pset.x
    assert not np.array_equal(x[:block], x[block:])
    assert np.isfinite(x).all() and x[:block].std() > 0 and x[block:].std() > 0


def test_key_splits_per_draw_and_carries():
    """Each draw of a call differs, the same key repeats, and the streams
    carry across execute calls: two 1 h runs equal one 2 h run (the draws
    are counter-based: key, place in the step, set position and clock)."""
    state = torch.zeros(6, dtype=torch.int32)
    key = torch.tensor([1, 2], dtype=torch.uint32)
    p = t_view.Particles({"state": state, "_rng": key}, torch.ones(6, dtype=torch.bool))
    a, b = p.random_normal(), p.random_normal()
    assert not torch.equal(a, b) and p._data["_rng"].dtype == torch.uint32
    q = t_view.Particles({"state": state, "_rng": key}, torch.ones(6, dtype=torch.bool))
    assert torch.equal(q.random_normal(), a)
    assert ((q.random_uniform() >= 0) & (q.random_uniform() < 1)).all()
    one = _run(_flow_fs(tp), tp.DiffusionUniformKh, n=64, hours=2)
    two = _run(_flow_fs(tp), tp.DiffusionUniformKh, n=64, hours=1)
    two.execute(tp.DiffusionUniformKh, dt=np.timedelta64(10, "m"),
                runtime=np.timedelta64(1, "h"))
    np.testing.assert_array_equal(one.x, two.x)
    assert one._data["_rng"].device.type == "cpu"


@pytest.mark.parametrize("name", ["AdvectionDiffusionEM", "AdvectionDiffusionM1"])
def test_identical_draws_match_reference(monkeypatch, name):
    """Both packages' ``random_normal`` return the same pre-drawn normals
    (the JAX engine calls it while tracing, so the k-th draw of a kernel
    call is the same array at every step, and the port is handed the same):
    the trajectories then agree to rtol 1e-5."""
    n = 256
    draws = np.random.default_rng(5).standard_normal((2, 8192)).astype(np.float32)

    def patched(make):
        calls = []

        def random_normal(self, dtype=None):
            k = len(calls) % 2
            calls.append(k)
            return make(draws[k][: self._data["state"].shape[0]])
        return random_normal

    monkeypatch.setattr(j_view.Particles, "random_normal", patched(jnp.asarray))
    monkeypatch.setattr(t_view.Particles, "random_normal", patched(torch.as_tensor))
    runs = {}
    for pkg in (tp, jp):
        fs = _flow_fs(pkg, u=0.1, v=-0.05, dres=10000.0)
        pset = pkg.ParticleSet(fs, x=np.linspace(-4e5, 4e5, n), y=np.linspace(-3e5, 3e5, n),
                               t=np.zeros(n))
        pset.execute(getattr(pkg, name), dt=np.timedelta64(10, "m"),
                     runtime=np.timedelta64(3, "h"))
        runs[pkg] = pset
    a, b = runs[tp], runs[jp]
    for var in ("x", "y"):
        np.testing.assert_allclose(getattr(a, var), getattr(b, var), rtol=1e-5)
    np.testing.assert_array_equal(a.state, b.state)
    # the draws moved the particles beyond pure advection
    assert np.abs(a.y - (np.linspace(-3e5, 3e5, n) - 0.05 * 3 * 3600.0)).max() > 100.0


def test_quickstart_03():
    """docs/quickstarts/03_advection_diffusion.md in port form (torch.where
    in the recovery kernel), on the CPU."""
    fieldset = _flow_fs(tp, dres=10000.0)

    def DeleteOOB(particles, fieldset):  # noqa: N802
        particles.state = torch.where(
            particles.state == tp.StatusCode.ErrorOutOfBounds,
            tp.StatusCode.Delete,
            particles.state,
        )

    n = 5_000
    pset = tp.ParticleSet(fieldset, x=np.full(n, 9.97e5), y=np.zeros(n), t=np.zeros(n), seed=7)
    pset.execute([tp.AdvectionDiffusionEM, DeleteOOB], dt=np.timedelta64(10, "m"),
                 runtime=np.timedelta64(24, "h"))
    assert 0.2 * n < len(pset) < 0.8 * n
    spread = pset.y.std()
    expected = np.sqrt(2 * KH * 86400.0)
    assert 0.7 * expected < spread < 1.3 * expected

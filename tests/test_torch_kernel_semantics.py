"""The JAX package's kernel-chain tier (``tests/test_kernel_semantics.py``)
through both packages.

Each case runs the same inputs through ``parcels_tpu`` and the port (on the
CPU): equal live-lane counts, ids and states, positions, the clock and the
sampled variables at the JAX test's own tolerance, the same exception type
where the JAX test expects one, and the JAX test's own assertions on both.
The kernel that calls ``jnp.where`` has a ``torch.where`` twin beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from torch_twins import PACKAGES, assert_same_sets, datasets, raised, sgrid

S1 = np.timedelta64(1, "s")


def _fieldset_gradient(m):
    """U varies linearly in x so sampling position differences are visible."""
    ds = datasets(m).simple_UV_dataset(dims=(2, 1, 4, 40), mesh="flat")
    X = np.linspace(-1e6, 1e6, 40, dtype=np.float32)
    ds["U"].values[:] = np.broadcast_to(X / 1e6, ds["U"].values.shape)
    return sgrid(m, ds)


@pytest.fixture(scope="module")
def gradients():
    return {m: _fieldset_gradient(m) for m in PACKAGES}


SHIFT = 2e5


def MoveDX(particles, fieldset):  # noqa: N802
    particles.dx += SHIFT


def MoveX(particles, fieldset):  # noqa: N802
    particles.x = particles.x + SHIFT


def SampleP(particles, fieldset):  # noqa: N802
    u, _ = fieldset.UV[particles]
    particles.p = u


def DoNothing(particles, fieldset):  # noqa: N802
    pass


@pytest.mark.parametrize("kernel_type", ["update_dlon", "update_lon"])
def test_execution_order(kernel_type, gradients):
    move = MoveDX if kernel_type == "update_dlon" else MoveX
    runs = {}
    for m in PACKAGES:
        pclass = m.Particle.add_variable(m.Variable("p", dtype=np.float32, initial=0.0))
        runs[m] = []
        for order in (1, -1):
            pset = m.ParticleSet(gradients[m], pclass=pclass, x=[0.0], y=[0.0], t=[0.0])
            pset.execute([move, SampleP][::order], dt=S1, runtime=S1)
            runs[m].append(pset)
        xs = [float(p.x[0]) for p in runs[m]]
        ps = [float(p.p[0]) for p in runs[m]]
        np.testing.assert_allclose(xs, SHIFT, rtol=1e-6)
        if kernel_type == "update_dlon":
            np.testing.assert_allclose(ps[0], ps[1], atol=1e-7)
        else:
            assert abs(ps[0] - ps[1]) > 1e-3, ps
            np.testing.assert_allclose(ps[0] - ps[1], SHIFT / 1e6, rtol=1e-4)
    for jset, tset in zip(runs[jp], runs[tp]):
        assert_same_sets(jset, tset, rtol=1e-6, atol=1e-7, names=("p",))


@pytest.mark.parametrize("dt", [1e-2, 1e-5, 1e-6])
def test_small_dt_exact_landing(dt, gradients):
    runs = {}
    for m in PACKAGES:
        pset = m.ParticleSet(gradients[m], x=[0.0], y=[0.0], t=[0.0])
        pset.execute(DoNothing, dt=dt, runtime=dt * 100)
        np.testing.assert_allclose(pset.t, dt * 100, rtol=1e-6)
        runs[m] = pset
    assert_same_sets(runs[jp], runs[tp], rtol=1e-6)


def test_context_constants_in_kernel():
    def UseCtx(particles, fieldset):  # noqa: N802
        particles.s += fieldset.coeff

    runs = {}
    for m in PACKAGES:
        fs = _fieldset_gradient(m)
        fs.add_context("coeff", 3.0)
        pclass = m.Particle.add_variable(m.Variable("s", dtype=np.float32, initial=0.0))
        pset = m.ParticleSet(fs, pclass=pclass, x=[0.0], y=[0.0], t=[0.0])
        pset.execute(UseCtx, dt=S1, runtime=np.timedelta64(3, "s"))
        np.testing.assert_allclose(pset.s, 9.0)
        runs[m] = pset
    assert_same_sets(runs[jp], runs[tp], rtol=0.0, names=("s",))


def Bad(particles, fieldset):  # noqa: N802
    particles.nope += 1.0


@pytest.mark.parametrize("case", ["unknown_variable", "noncallable_in_list"])
def test_errors_match_reference(case, gradients):
    kernels = Bad if case == "unknown_variable" else ["not a kernel"]
    allowed = (AttributeError, KeyError) if case == "unknown_variable" else (TypeError, ValueError)
    errs = {}
    for m in PACKAGES:
        pset = m.ParticleSet(gradients[m], x=[0.0], y=[0.0], t=[0.0])
        errs[m] = raised(lambda: pset.execute(kernels, dt=S1, runtime=S1))
    assert type(errs[tp]) is type(errs[jp]), errs
    assert isinstance(errs[tp], allowed), errs


def test_rk45_multichunk_no_dt_freeze():
    rng = np.random.default_rng(21)
    n = 16
    x = rng.uniform(-9e5, 6e5, n)
    y = rng.uniform(-9e5, -5e5, n)
    runs = {}
    for m in PACKAGES:
        ds = datasets(m).simple_UV_dataset(dims=(2, 2, 32, 32), mesh="flat")
        ds["U"].values[:] = 2.0
        ds["V"].values[:] = 10.0
        fs = sgrid(m, ds)
        fs.add_context("RK45_tol", 1e-4)
        fs.add_context("RK45_min_dt", 10)
        fs.add_context("RK45_max_dt", 3600)
        pclass = m.Particle.add_variable(
            m.Variable("next_dt", dtype=np.float64, initial=600.0, to_write=False)
        )
        pset = m.ParticleSet(fs, pclass=pclass, x=x.copy(), y=y.copy(), t=np.zeros(n))
        pset.execute(m.AdvectionRK45, dt=np.timedelta64(600, "s"),
                     runtime=np.timedelta64(86400, "s"))
        np.testing.assert_allclose(pset.t, 86400.0)
        np.testing.assert_allclose(pset.y, y + 10.0 * 86400, rtol=1e-5, atol=1.0)
        np.testing.assert_allclose(pset.x, x + 2.0 * 86400, rtol=1e-5, atol=1.0)
        runs[m] = pset
    # next_dt is not compared: at RK45_tol 1e-4 m against steps of up to 6 km,
    # kappa is the f32 rounding of the 4th- and 5th-order sums, so which steps
    # are accepted follows each package's order of operations
    assert_same_sets(runs[jp], runs[tp], rtol=1e-5, atol=1.0)


def A(particles, fieldset):  # noqa: N802
    particles.dx += 100.0


def B(particles, fieldset):  # noqa: N802
    particles.dy += 50.0


def C_jax(particles, fieldset):  # noqa: N802
    particles.dx += jnp.where(particles.dy > 0, 0.0, 0.0)  # no-op read


def C_torch(particles, fieldset):  # noqa: N802
    particles.dx += torch.where(particles.dy > 0, 0.0, 0.0)  # no-op read


def test_three_kernel_chain_accumulates(gradients):
    runs = {}
    for m, c in ((jp, C_jax), (tp, C_torch)):
        pset = m.ParticleSet(gradients[m], x=[0.0], y=[0.0], t=[0.0])
        pset.execute([A, B, c], dt=S1, runtime=np.timedelta64(4, "s"))
        np.testing.assert_allclose(pset.x, 400.0, rtol=1e-6)
        np.testing.assert_allclose(pset.y, 200.0, rtol=1e-6)
        runs[m] = pset
    assert_same_sets(runs[jp], runs[tp], rtol=1e-6)

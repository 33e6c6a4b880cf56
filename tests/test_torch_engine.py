"""The JAX package's engine tier (``tests/test_engine.py``) through both packages.

Every case runs the same inputs through ``parcels_tpu`` and the port (on the
CPU) and holds the port to the JAX package: the same exception type and
message pattern; equal live-lane counts, particle ids and states; the clock
and positions at the JAX test's own tolerance (rtol 1e-6, 1e-5 for the
backward run); and the JAX test's own closed-form assertion on both.

The two lockstep-window cases (``test_engine.py:274``, :302) have no
counterpart: the port leaves the lockstep window out by design
(``ROADMAP.md`` §1). The 180-day clock case (:338, about 900k steps) runs
here past the f32 clock cliff in 4994 steps; its full length is
``test_long_horizon_full_length``, marked ``slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from torch_twins import PACKAGES, assert_same_files, assert_same_sets, datasets, eddy, raised
from torch_twins import sgrid, twins, uniform_flow

DT5 = np.timedelta64(5, "m")
H1, H2 = np.timedelta64(1, "h"), np.timedelta64(2, "h")


@pytest.fixture(scope="module")
def eddies():
    """One moving-eddy fieldset a package, shared by the cases that add no
    context to it (each keeps its compiled or planned chunks)."""
    return {mod: eddy(mod) for mod in PACKAGES}


@pytest.fixture(scope="module")
def flows():
    return {mod: uniform_flow(mod, u=1.0, v=0.0) for mod in PACKAGES}


def _both(fn):
    return fn(jp), fn(tp)


# -- kernels written for both packages, side by side --------------------------


def StopAfterAnHour_jax(particles, fieldset):  # noqa: N802
    particles.state = jnp.where(
        particles.t >= 3600.0, jp.StatusCode.StopAllExecution, particles.state
    ).astype(particles.state.dtype)


def StopAfterAnHour_torch(particles, fieldset):  # noqa: N802
    particles.state = torch.where(
        particles.t >= 3600.0, tp.StatusCode.StopAllExecution, particles.state
    )


def DeleteOnOOB_jax(particles, fieldset):  # noqa: N802
    particles.state = jnp.where(
        particles.state == jp.StatusCode.ErrorOutOfBounds, jp.StatusCode.Delete, particles.state
    ).astype(particles.state.dtype)


def DeleteOnOOB_torch(particles, fieldset):  # noqa: N802
    particles.state = torch.where(
        particles.state == tp.StatusCode.ErrorOutOfBounds, tp.StatusCode.Delete, particles.state
    )


TWINS = twins(
    StopAfterAnHour=(StopAfterAnHour_jax, StopAfterAnHour_torch),
    DeleteOnOOB=(DeleteOnOOB_jax, DeleteOnOOB_torch),
)


# -- argument validation ----------------------------------------------------


def bad_kernel(particles):
    pass


ERRORS = {
    # test_engine.py:27-56 and :193 (kernel signature): the call, and the
    # JAX test's match= pattern (None where it has none)
    "dt_zero": (lambda m, ps: ps.execute(m.AdvectionEE, dt=np.timedelta64(0, "s"), runtime=H1),
                "dt"),
    "runtime_and_endtime": (
        lambda m, ps: ps.execute(m.AdvectionEE, dt=DT5, runtime=H1,
                                 endtime=np.datetime64("2000-01-01T06:00")),
        "mutually exclusive"),
    "kernel_not_callable": (lambda m, ps: ps.execute(["not-a-kernel"], dt=DT5, runtime=H1), None),
    "no_kernels": (lambda m, ps: ps.execute([], dt=DT5, runtime=H1), None),
    "rk45_without_next_dt": (lambda m, ps: ps.execute(m.AdvectionRK45, dt=DT5, runtime=H1),
                             "next_dt"),
    "kernel_signature": (lambda m, ps: ps.execute([bad_kernel], dt=DT5, runtime=H1), "signature"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_reference(case, eddies):
    call, match = ERRORS[case]
    errs = {m: raised(lambda m=m: call(m, m.ParticleSet(eddies[m], x=[12000.0], y=[12000.0])))
            for m in PACKAGES}
    assert type(errs[tp]) is type(errs[jp]), errs
    assert isinstance(errs[tp], (TypeError, ValueError)), errs
    if match is not None:
        for e in errs.values():
            assert match in str(e), e


# -- trajectories and state ---------------------------------------------------


def test_release_time_independence(eddies):
    def run(m):
        solo = m.ParticleSet(eddies[m], x=[12000.0], y=[12500.0], t=[0.0])
        solo.execute(m.AdvectionRK4, dt=DT5, runtime=H2)
        batch = m.ParticleSet(eddies[m], x=[12000.0, 13000.0], y=[12500.0, 14000.0],
                              t=[0.0, 3600.0])
        batch.execute(m.AdvectionRK4, dt=DT5, runtime=H2)
        np.testing.assert_allclose(batch.x[0], solo.x[0], rtol=1e-6)
        np.testing.assert_allclose(batch.y[0], solo.y[0], rtol=1e-6)
        return solo, batch

    (jsolo, jbatch), (tsolo, tbatch) = _both(run)
    assert_same_sets(jsolo, tsolo, rtol=1e-6)
    assert_same_sets(jbatch, tbatch, rtol=1e-6)


def test_back_to_back_executes_continue(eddies):
    def run(m):
        once = m.ParticleSet(eddies[m], x=[12000.0], y=[12500.0], t=[0.0])
        once.execute(m.AdvectionRK4, dt=DT5, runtime=H2)
        twice = m.ParticleSet(eddies[m], x=[12000.0], y=[12500.0], t=[0.0])
        twice.execute(m.AdvectionRK4, dt=DT5, runtime=H1)
        twice.execute(m.AdvectionRK4, dt=DT5, runtime=H1)
        assert twice.t[0] == 7200.0
        np.testing.assert_allclose(twice.x, once.x, rtol=1e-6)
        return twice

    assert_same_sets(*_both(run), rtol=1e-6)


def test_backward_in_time_recovers_start():
    x0, y0 = 1e5, 1e5

    def run(m):
        pset = m.ParticleSet(uniform_flow(m, u=1.0, v=0.5), x=[x0], y=[y0],
                             t=[np.timedelta64(2, "h")])
        pset.execute(m.AdvectionRK4, dt=np.timedelta64(-5, "m"), runtime=H2)
        assert pset.t[0] == 0.0
        np.testing.assert_allclose(pset.x, x0 - 7200.0, rtol=1e-5)
        np.testing.assert_allclose(pset.y, y0 - 3600.0, rtol=1e-5)
        return pset

    assert_same_sets(*_both(run), rtol=1e-5)


def test_stop_all_execution(flows):
    def run(m):
        pset = m.ParticleSet(flows[m], x=[1e5], y=[1e5], t=[0.0])
        pset.execute([m.AdvectionEE, TWINS["StopAfterAnHour"][m]], dt=np.timedelta64(30, "m"),
                     runtime=np.timedelta64(6, "h"))
        assert pset.t[0] <= 2 * 3600.0
        return pset

    jset, tset = _both(run)
    assert_same_sets(jset, tset, rtol=1e-6)
    assert tset.state[0] == tp.StatusCode.StopAllExecution == jset.state[0]


def test_delete_recovery_kernel():
    def run(m):
        pset = m.ParticleSet(uniform_flow(m, u=50.0, v=0.0), x=[9.9e5, 0.0], y=[0.0, 0.0],
                             t=[0.0, 0.0])
        pset.execute([m.AdvectionEE, TWINS["DeleteOnOOB"][m]], dt=np.timedelta64(30, "m"),
                     runtime=H2)
        assert len(pset) == 1
        assert pset.particle_id[0] == 1
        return pset

    assert_same_sets(*_both(run), rtol=1e-6)


def test_rk45_adaptive_runs_and_respects_bounds():
    def run(m):
        fs = eddy(m)
        fs.add_context("RK45_tol", 100.0)
        fs.add_context("RK45_min_dt", 10.0)
        fs.add_context("RK45_max_dt", 3600.0)
        pclass = m.Particle.add_variable(m.Variable("next_dt", dtype=np.float64, initial=300.0))
        pset = m.ParticleSet(fs, pclass=pclass, x=[12000.0], y=[12500.0], t=[0.0])
        pset.execute(m.AdvectionRK45, dt=DT5, runtime=H2)
        assert pset.t[0] == 7200.0
        assert 10.0 <= abs(pset.next_dt[0]) <= 3600.0
        return pset

    assert_same_sets(*_both(run), rtol=1e-6, names=("next_dt",))


def test_rk45_landing_below_min_dt():
    """A last step clamped to 5 s, under RK45_min_dt, is accepted in both
    packages and moves the particle by 5 s. The JAX package then adds the
    10 s that its AdvectionRK45 floors dt at to the clock, so its lane ends
    5 s past the horizon in Evaluate, its position behind its clock; the
    port adds the 5 s it moved by and lands on the horizon (a deliberate
    difference, ``ROADMAP.md`` §3)."""
    def run(m):
        fs = uniform_flow(m, u=2.0, v=10.0, dims=(2, 2, 32, 32))
        for k, v in (("RK45_tol", 100.0), ("RK45_min_dt", 10), ("RK45_max_dt", 3600)):
            fs.add_context(k, v)
        pclass = m.Particle.add_variable(m.Variable("next_dt", dtype=np.float64, initial=600.0))
        pset = m.ParticleSet(fs, pclass=pclass, x=[0.0], y=[0.0], t=[0.0])
        pset.execute(m.AdvectionRK45, dt=np.timedelta64(600, "s"), runtime=np.timedelta64(605, "s"))
        np.testing.assert_allclose(pset.y, 10.0 * 605, rtol=1e-6)
        return pset

    jset, tset = _both(run)
    assert jset.t[0] == 610.0 and jset.state[0] == jp.StatusCode.Evaluate
    assert tset.t[0] == 605.0 and tset.state[0] == tp.StatusCode.EndofLoop
    np.testing.assert_array_equal(tset.particle_id, jset.particle_id)
    for name in ("x", "y", "next_dt"):
        np.testing.assert_array_equal(getattr(tset, name), getattr(jset, name), err_msg=name)


def test_checkpoint_roundtrip(eddies, tmp_path):
    def run(m):
        x, y = [12000.0, 15000.0], [12500.0, 9000.0]
        pset = m.ParticleSet(eddies[m], x=x, y=y, t=[0.0, 0.0])
        pset.execute(m.AdvectionRK4, dt=DT5, runtime=H1)
        path = str(tmp_path / f"ckpt_{m.__name__}.npz")
        pset.checkpoint(path)
        restored = m.ParticleSet.from_checkpoint(eddy(m), path)
        np.testing.assert_array_equal(restored.x, pset.x)
        np.testing.assert_array_equal(restored.particle_id, pset.particle_id)
        restored.execute(m.AdvectionRK4, dt=DT5, runtime=H1)
        straight = m.ParticleSet(eddies[m], x=x, y=y, t=[0.0, 0.0])
        straight.execute(m.AdvectionRK4, dt=DT5, runtime=H2)
        np.testing.assert_allclose(restored.x, straight.x, rtol=1e-6)
        return restored, straight

    (jr, js), (tr, ts) = _both(run)
    assert_same_sets(jr, tr, rtol=1e-6)
    assert_same_sets(js, ts, rtol=1e-6)


def test_restart_from_particlefile(eddies, tmp_path):
    def run(m):
        pset = m.ParticleSet(eddies[m], x=[12000.0, 15000.0], y=[12500.0, 9000.0], t=[0.0, 0.0])
        path = str(tmp_path / f"traj_{m.__name__}.parquet")
        pf = m.ParticleFile(path, outputdt=np.timedelta64(30, "m"), mode="w")
        pset.execute(m.AdvectionRK4, dt=DT5, runtime=H1, output_file=pf)
        pf.close()
        restarted = m.ParticleSet.from_particlefile(eddy(m), m.Particle, path, restart=True)
        np.testing.assert_array_equal(np.sort(restarted.particle_id), [0, 1])
        np.testing.assert_allclose(np.sort(restarted.x), np.sort(pset.x), rtol=1e-6)
        return restarted, path

    (jr, jpath), (tr, tpath) = _both(run)
    assert_same_sets(jr, tr, rtol=1e-6)
    assert_same_files(jpath, tpath, rtol=1e-6)


def test_remove_indices_and_len(eddies):
    def run(m):
        pset = m.ParticleSet(eddies[m], x=[12000.0, 13000.0, 14000.0], y=[12000.0] * 3)
        assert len(pset) == 3
        pset.remove_indices([1])
        assert len(pset) == 2
        np.testing.assert_array_equal(pset.particle_id, [0, 2])
        return pset

    assert_same_sets(*_both(run), rtol=0.0)


def test_fieldset_eval_host_convenience():
    def run(m):
        fs = uniform_flow(m, u=1.0, v=0.5)
        u, v = fs.eval("UV", 0.0, 0.0, [1e5, 2e5], [1e5, 3e5])
        np.testing.assert_allclose(u, [1.0, 1.0], rtol=1e-6)
        np.testing.assert_allclose(v, [0.5, 0.5], rtol=1e-6)
        uo = fs.eval("U", 0.0, 0.0, 1e5, 1e5)
        np.testing.assert_allclose(uo, [1.0], rtol=1e-6)
        return [np.asarray(a) for a in (u, v, uo)]

    for j, t in zip(*_both(run)):
        np.testing.assert_allclose(t, j, rtol=1e-6)


def test_pset_add_merge_and_iadd(flows):
    def run(m):
        p1 = m.ParticleSet(flows[m], x=[1000.0, 2000.0], y=[1000.0, 2000.0], t=[0.0, 0.0])
        p2 = m.ParticleSet(flows[m], x=[3000.0], y=[3000.0], t=[0.0], particle_ids=[7])
        p1 += p2
        assert len(p1) == 3
        assert sorted(p1.particle_id.tolist()) == [0, 1, 7]
        np.testing.assert_allclose(sorted(p1.x.tolist()), [1000.0, 2000.0, 3000.0])
        err = raised(lambda: p1.add("not a pset"))
        assert isinstance(err, TypeError)
        p1.execute(m.AdvectionEE, dt=np.timedelta64(60, "s"), runtime=np.timedelta64(600, "s"))
        assert np.all(p1.t == 600.0)
        return p1, err

    (jset, jerr), (tset, terr) = _both(run)
    assert type(terr) is type(jerr)
    assert_same_sets(jset, tset, rtol=1e-6)


def test_pset_iteration_records(flows):
    def run(m):
        pset = m.ParticleSet(flows[m], x=[100.0, 200.0, 300.0], y=[10.0, 20.0, 30.0], t=[0.0] * 3)
        rows = list(pset)
        assert len(rows) == 3
        assert [float(r.x) for r in rows] == [100.0, 200.0, 300.0]
        assert "Particle(id=" in repr(rows[0])
        return [repr(r) for r in rows]

    jrows, trows = _both(run)
    assert trows == jrows


def test_getitem_and_write_status(eddies, tmp_path):
    def run(m):
        pset = m.ParticleSet(eddies[m], x=[12000.0, 13000.0], y=[12500.0, 12500.0],
                             t=[np.timedelta64(0, "s")] * 2)
        p0 = pset[0]
        assert p0.x == np.float32(12000.0) and p0.particle_id == 0
        assert "Particle(id=0" in repr(p0)
        pset.set_variable_write_status("z", False)
        assert [v.to_write for v in pset._pclass.variables if v.name == "z"] == [False]
        path = str(tmp_path / f"t_{m.__name__}.parquet")
        pf = m.ParticleFile(path, outputdt=np.timedelta64(10, "m"), mode="w")
        pset.execute(m.AdvectionRK4, dt=DT5, runtime=np.timedelta64(20, "m"), output_file=pf)
        pf.close()
        df = m.read_particlefile(path)
        assert "z" not in df.columns and "x" in df.columns
        err = raised(lambda: pset.set_variable_write_status("nope", True))
        assert isinstance(err, ValueError) and "no variable" in str(err)
        return pset, path, repr(p0)

    (jset, jpath, jrep), (tset, tpath, trep) = _both(run)
    assert trep == jrep
    assert_same_sets(jset, tset, rtol=1e-6)
    assert_same_files(jpath, tpath, rtol=1e-6)


def test_getitem_is_active_relative(eddies):
    def run(m):
        ps = m.ParticleSet(eddies[m], x=[12000.0, 12100.0, 12200.0], y=[12500.0] * 3,
                           t=[0.0] * 3)
        ps.remove_indices([1])
        assert ps[1].x == np.float32(12200.0)
        return repr(ps[1]), raised(lambda: ps[2])

    (jrep, jerr), (trep, terr) = _both(run)
    assert trep == jrep
    assert type(terr) is type(jerr) is IndexError


def test_write_status_roundtrip_preserves_attrs(eddies):
    def run(m):
        ps = m.ParticleSet(eddies[m], x=[12000.0], y=[12500.0], t=[0.0])
        before = next(v.attrs for v in ps._pclass.variables if v.name == "z")
        assert before
        ps.set_variable_write_status("z", False)
        ps.set_variable_write_status("z", True)
        after = next(v.attrs for v in ps._pclass.variables if v.name == "z")
        assert after == before
        return after

    jattrs, tattrs = _both(run)
    assert tattrs == jattrs


# -- the compensated clock ------------------------------------------------------


def _clock_run(m, t0_s, runtime, dt, u):
    ds = datasets(m).simple_UV_dataset(dims=(2, 2, 8, 8), mesh="flat")
    ds["U"].values[:] = u
    pset = m.ParticleSet(sgrid(m, ds), x=[-1.0e6], y=[0.0], t=[float(t0_s)])
    pset.execute(m.AdvectionEE, dt=dt, runtime=runtime)
    d = pset._data
    t_final = np.asarray(d["t"])[np.asarray(d["_active"])]
    return pset, t_final


# past the f32 clock cliff: a start of 100 days (8.64e6 s > 2^23 s, where
# the f32 step is 1 s), the JAX test's dt of 17.3 s, for one day (4994 steps)
CLIFF_T0 = 100 * 86400.0


def test_long_horizon_past_the_clock_cliff():
    """``test_engine.py:338`` past the cliff: both packages land ``t``
    exactly on the horizon, the position stays within the JAX test's 5 km
    drift bound, and the port's clock and position equal the JAX package's
    bit for bit (as measured)."""
    horizon = CLIFF_T0 + 86400.0
    runs = {m: _clock_run(m, CLIFF_T0, np.timedelta64(1, "D"), np.timedelta64(17300, "ms"), 0.1)
            for m in PACKAGES}
    exp_x = -1.0e6 + 0.1 * 86400.0
    for pset, t_final in runs.values():
        np.testing.assert_array_equal(t_final, np.float32(horizon))
        assert abs(pset.x[0] - exp_x) < 5e3, (pset.x[0], exp_x)
    np.testing.assert_array_equal(runs[tp][1], runs[jp][1])
    assert_same_sets(runs[jp][0], runs[tp][0], rtol=0.0)


@pytest.mark.slow
def test_long_horizon_full_length():
    """``test_engine.py:338`` at its full 180 days (about 900k steps; 53
    minutes of the port on one CPU process): both packages land ``t``
    exactly on the horizon, within the 5 km drift bound, and the port equals
    the JAX package bit for bit (as measured)."""
    horizon = 180 * 86400.0
    runs = {m: _clock_run(m, 0.0, np.timedelta64(180, "D"), np.timedelta64(17300, "ms"), 0.1)
            for m in PACKAGES}
    for pset, t_final in runs.values():
        np.testing.assert_array_equal(t_final, np.float32(horizon))
        assert abs(pset.x[0] - (-1.0e6 + 0.1 * horizon)) < 5e3
    assert_same_sets(runs[jp][0], runs[tp][0], rtol=0.0)


def test_exact_output_time_landing_subsecond_dt():
    runs = {m: _clock_run(m, 0.0, np.timedelta64(1, "h"), np.timedelta64(700, "ms"), 1.0)
            for m in PACKAGES}
    for pset, t_final in runs.values():
        np.testing.assert_array_equal(t_final, np.float32(3600.0))
        np.testing.assert_allclose(pset.x[0], -1.0e6 + 3600.0, atol=100.0)
    assert_same_sets(runs[jp][0], runs[tp][0], rtol=0.0)  # bit for bit, as measured

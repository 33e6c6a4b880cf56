"""The rest of the port's single-card ParticleSet API against parcels_tpu.

Same seeded inputs through both packages (the port on the CPU): the repr and
``describe``, a continuous release (``pset += other``) before and after an
``execute`` on a rectilinear set, a curvilinear C-grid set with the stage
cache's ``_sc_*`` columns and a UGRID set with the per-face cache's
``_uxc_*`` columns, a recapture (``remove_indices``), iteration and
indexing, ``set_variable_write_status`` down to the Parquet columns,
``data_indices`` and the error-particle counts, the kernel-chain semantics
of ``tests/test_kernel_semantics.py`` and the masked write-through of the
kernels' ``particles`` view (``tests/test_particles_view.py``).

Tolerances: the rectilinear runs at the JAX package's own closed-form
tolerance (rtol 1e-5); the C-grid runs at ``test_torch_stagecache.py``'s
reference tolerance (1e-4 deg), the UGRID runs at ``test_torch_uxcache.py``'s
(rtol 1e-6, atol 1e-4 m); states, ids and activity equal.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu._core.particles_view import Particles as JParticles
from parcels_tpu.datasets import delaunay_flow_dataset as j_delaunay
from parcels_tpu.datasets import moi_like_fieldset as j_moi
from parcels_tpu.datasets import moving_eddy_dataset as j_eddy
from parcels_tpu.datasets import simple_UV_dataset as j_simple
from parcels_tpu_torch._core.particles_view import Particles as TParticles
from parcels_tpu_torch.datasets import delaunay_flow_dataset as t_delaunay
from parcels_tpu_torch.datasets import moi_like_fieldset as t_moi
from parcels_tpu_torch.datasets import moving_eddy_dataset as t_eddy
from parcels_tpu_torch.datasets import simple_UV_dataset as t_simple


def _eddy(mod):
    if mod is jp:
        return jp.FieldSet.from_sgrid_conventions(j_eddy(), mesh="flat")
    return tp.FieldSet.from_sgrid_conventions(t_eddy(), mesh="flat", device="cpu")


def _strip_device(text):
    return text.replace(", device=cpu)", ")")


def _host(mod, pset, name):
    return np.asarray(getattr(pset, name))


def test_repr_and_describe_match_reference():
    x, y = np.linspace(11000, 13000, 20), np.full(20, 12500.0)
    sets = {mod: mod.ParticleSet(_eddy(mod), x=x, y=y, t=np.zeros(20)) for mod in (jp, tp)}
    assert repr(sets[tp]).endswith(", device=cpu)")
    assert _strip_device(repr(sets[tp])) == repr(sets[jp])
    texts = {}
    for mod, pset in sets.items():
        buf = io.StringIO()
        pset.describe(buf)
        texts[mod] = buf.getvalue()
    assert _strip_device(texts[tp]) == texts[jp]
    assert "... (13 more)" in texts[tp]
    html = sets[tp]._repr_html_()
    assert "particles" in html and "Particle(" in html


CASES = {
    # the cache key column the engine adds, and the tolerance against the JAX
    # package (3 releases of 60 + 40 + 20 lanes share one padded capacity,
    # so each package compiles or plans one chunk shape)
    "rect": dict(cols=None, tol=dict(rtol=1e-5, atol=0.0)),
    "cgrid": dict(cols="_sc_key", tol=dict(rtol=0, atol=1e-4)),
    "ugrid": dict(cols="_uxc_key", tol=dict(rtol=1e-6, atol=1e-4)),
}


def _case_fieldset(mod, case):
    if case == "rect":
        return _eddy(mod)
    if case == "cgrid":
        if mod is jp:
            return j_moi(xdim=96, ydim=64, zdim=3, seed=2)
        return t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")
    kw = dict(flow="rotation", placement="node", vertical="zf", nx=30, ny=30)
    if mod is jp:
        return jp.FieldSet.from_ugrid_conventions(j_delaunay(**kw), mesh="flat")
    return tp.FieldSet.from_ugrid_conventions(t_delaunay(**kw), mesh="flat", device="cpu")


def _case_release(case, n, seed, t0):
    rng = np.random.default_rng(seed)
    if case == "rect":
        kw = dict(x=rng.uniform(11000, 13000, n), y=rng.uniform(12000, 13000, n))
    elif case == "cgrid":
        kw = dict(x=rng.uniform(-150, 150, n), y=rng.uniform(-55, 60, n))
    else:
        kw = dict(x=rng.uniform(4e4, 6e4, n), y=rng.uniform(4e4, 6e4, n), z=np.full(n, 10.0))
    return dict(kw, t=np.full(n, t0))


def _case_run(mod, case, pset, t0):
    dt = {"rect": 300, "cgrid": 10800, "ugrid": 120}[case]
    opts = mod.EngineOptions(stagecache="force", uxcol="force", uxcache="force")
    pset.execute(mod.AdvectionRK4, dt=np.timedelta64(dt, "s"),
                 runtime=np.timedelta64(4 * dt, "s"), options=opts)
    return t0 + 4 * dt


@pytest.mark.parametrize("case", sorted(CASES))
def test_add_and_remove_before_and_after_execute(case):
    """A release, a second release merged before any run (neither set has
    cache columns), a run, a third release merged after it (the merged set
    has the engine's cache columns, the new one not: its entries start
    invalid), a seeded recapture of 10 % of the active lanes and a second
    run, in both packages."""
    cols = CASES[case]["cols"]
    out = {}
    for mod in (jp, tp):
        fs = _case_fieldset(mod, case)
        pset = mod.ParticleSet(fs, **_case_release(case, 60, 0, 0.0))
        pset += mod.ParticleSet(fs, **_case_release(case, 40, 1, 0.0),
                                particle_ids=np.arange(100, 140))
        assert len(pset) == 100
        t = _case_run(mod, case, pset, 0.0)
        if cols is not None:
            assert cols in pset._data
        pset += mod.ParticleSet(fs, **_case_release(case, 20, 2, t),
                                particle_ids=np.arange(200, 220))
        assert len(pset) == 120
        if cols is not None:
            key = np.asarray(pset._data[cols]) if mod is jp else pset._data[cols].numpy()
            np.testing.assert_array_equal(key[-20:, 0], -1)
        rng = np.random.default_rng(3)
        pset.remove_indices(rng.choice(120, 12, replace=False))
        assert len(pset) == 108
        _case_run(mod, case, pset, t)
        order = np.argsort(_host(mod, pset, "particle_id"))
        out[mod] = {v: _host(mod, pset, v)[order] for v in ("particle_id", "x", "y", "state")}
    np.testing.assert_array_equal(out[tp]["particle_id"], out[jp]["particle_id"])
    np.testing.assert_array_equal(out[tp]["state"], out[jp]["state"])
    for v in ("x", "y"):
        np.testing.assert_allclose(out[tp][v], out[jp][v], **CASES[case]["tol"])


def test_add_refuses_what_the_reference_refuses_and_other_devices():
    fs = _eddy(tp)
    a = tp.ParticleSet(fs, x=[12000.0], y=[12500.0], t=[0.0])
    with pytest.raises(TypeError, match="another ParticleSet"):
        a.add([1, 2])
    pclass = tp.Particle.add_variable(tp.Variable("p", dtype=np.float32, initial=0.0))
    with pytest.raises(ValueError, match="different particle variables"):
        a += tp.ParticleSet(fs, pclass=pclass, x=[12000.0], y=[12500.0], t=[0.0])
    fs_meta = tp.FieldSet(device="meta")
    fs_meta.add_constant_field("K", 1.0, mesh="flat")
    with pytest.raises(ValueError, match="on meta to one on cpu"):
        a += tp.ParticleSet(fs_meta, x=[0.0], y=[0.0], t=[0.0])


def test_iteration_and_indexing_match_reference():
    x, y = np.linspace(11000, 13000, 12), np.full(12, 12500.0)
    recs = {}
    for mod in (jp, tp):
        pset = mod.ParticleSet(_eddy(mod), x=x, y=y, t=np.zeros(12))
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"))
        pset.remove_indices([0, 5])
        recs[mod] = (list(pset), pset[0], pset[-1], pset[3])
        with pytest.raises(IndexError):
            pset[10]
    assert len(recs[tp][0]) == len(recs[jp][0]) == 10
    for a, b in zip([*recs[tp][0], *recs[tp][1:]], [*recs[jp][0], *recs[jp][1:]]):
        assert int(a.particle_id) == int(b.particle_id)
        assert int(a.state) == int(b.state)
        np.testing.assert_allclose([a.x, a.y, a.t], [b.x, b.y, b.t], rtol=1e-5)
        assert isinstance(a.x, np.floating)


@pytest.mark.parametrize("var, status", [("z", False), ("age", True)])
def test_write_status_reaches_the_parquet_columns(tmp_path, var, status):
    import pyarrow.parquet as pq

    cols = {}
    for mod in (jp, tp):
        pclass = mod.Particle.add_variable(
            mod.Variable("age", dtype=np.float32, initial=0.0, to_write=False))
        pset = mod.ParticleSet(_eddy(mod), pclass=pclass, x=[12000.0, 12100.0],
                               y=[12500.0, 12400.0], t=[0.0, 0.0])
        pset.set_variable_write_status(var, status)
        with pytest.raises(ValueError, match="no variable"):
            pset.set_variable_write_status("nope", False)
        with pytest.raises(ValueError, match="True or False"):
            pset.set_variable_write_status(var, "yes")
        path = tmp_path / f"{mod.__name__}.parquet"
        pf = mod.ParticleFile(path, outputdt=np.timedelta64(30, "m"), mode="w")
        pset.execute(mod.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"),
                     output_file=pf)
        pf.close()
        cols[mod] = pq.read_table(path).column_names
    assert cols[tp] == cols[jp]
    assert (var in cols[tp]) == status


def test_remove_and_data_indices_and_error_counts_match_reference():
    x = np.linspace(11000, 13000, 10)
    res = {}
    for mod in (jp, tp):
        pset = mod.ParticleSet(_eddy(mod), x=x, y=np.full(10, 12500.0), t=np.zeros(10))
        pset.remove_indices(np.array([True, False] * 5))
        pset.remove_indices([-1])
        pset.state = np.array([0, 50, 10, 30], dtype=np.int32)
        res[mod] = (len(pset), _host(mod, pset, "particle_id"),
                    pset.data_indices("state", [10, 30]),
                    pset.data_indices("state", 0, invert=True),
                    np.asarray(pset._error_particles), pset._num_error_particles)
    for a, b in zip(res[tp], res[jp]):
        np.testing.assert_array_equal(a, b)
    assert res[tp][0] == 4 and res[tp][-1] == 2


def _gradient(mod):
    simple = j_simple if mod is jp else t_simple
    ds = simple(dims=(2, 1, 4, 40), mesh="flat")
    ds["U"].values[:] = np.broadcast_to(np.linspace(-1, 1, 40, dtype=np.float32),
                                        ds["U"].values.shape)
    kw = {} if mod is jp else {"device": "cpu"}
    return mod.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw)


def _chain(mod, case):
    where = jnp.where if mod is jp else torch.where

    def MoveDX(particles, fieldset):  # noqa: N802
        particles.dx += 2e5

    def MoveX(particles, fieldset):  # noqa: N802
        particles.x = particles.x + 2e5

    def SampleP(particles, fieldset):  # noqa: N802
        u, _ = fieldset.UV[particles]
        particles.p = u

    def Scale(particles, fieldset):  # noqa: N802
        particles.dy += fieldset.scale * particles.p

    def Flag(particles, fieldset):  # noqa: N802
        particles.p = where(particles.x > 0, particles.p + 1.0, particles.p)

    return {
        "dx_order": [MoveDX, SampleP],
        "dx_reversed": [SampleP, MoveDX],
        "x_order": [MoveX, SampleP],
        "x_reversed": [SampleP, MoveX],
        "three_kernels": [SampleP, Scale, Flag],
    }[case]


@pytest.mark.parametrize("case", ["dx_order", "dx_reversed", "x_order", "x_reversed",
                                  "three_kernels"])
def test_kernel_chain_semantics_match_reference(case):
    """Deferred dx displacements against direct x writes in either kernel
    order, and a three-kernel chain reading a context constant
    (tests/test_kernel_semantics.py)."""
    got = {}
    for mod in (jp, tp):
        fs = _gradient(mod)
        fs.add_context("scale", 10.0)
        pclass = mod.Particle.add_variable(mod.Variable("p", dtype=np.float32, initial=0.0))
        pset = mod.ParticleSet(fs, pclass=pclass, x=[0.0, -3e5], y=[0.0, 0.0], t=[0.0, 0.0])
        pset.execute(_chain(mod, case), dt=np.timedelta64(1, "s"), runtime=np.timedelta64(3, "s"))
        got[mod] = [_host(mod, pset, v) for v in ("x", "y", "p", "t")]
    for a, b in zip(got[tp], got[jp]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


VIEW_MASK = np.array([True, False, True, False, True, False])


def _view_case(mod, case):
    arr = jnp.asarray if mod is jp else torch.as_tensor
    data = {"x": arr(np.arange(6, dtype=np.float32)), "dx": arr(np.zeros(6, np.float32)),
            "state": arr(np.full(6, 10, np.int32)), "_rng": arr(np.array([1, 2], np.uint32))}
    p = (JParticles if mod is jp else TParticles)(data, arr(VIEW_MASK))
    where = jnp.where if mod is jp else torch.where
    if case == "masked_add":
        p.dx = p.dx + 5.0
    elif case == "masked_assign":
        p.x = arr(np.full(6, -1.0, np.float32))
    elif case == "augmented":
        p.dx += 2.0
        p.dx += 3.0
    elif case == "read_after_write":
        p.dx = p.dx + 1.0
        p.x = p.x + p.dx
    else:
        p.state = where(p.x > 1.5, 30, p.state)
    assert len(p) == 6 and "Particles" in repr(p)
    return [np.asarray(p._data[k]) for k in ("x", "dx", "state")]


@pytest.mark.parametrize("case", ["masked_add", "masked_assign", "augmented",
                                  "read_after_write", "state_where"])
def test_particles_view_writes_match_reference(case):
    """The kernels' masked write-through view (tests/test_particles_view.py):
    only the mask's lanes change, exactly as in the JAX package."""
    for a, b in zip(_view_case(tp, case), _view_case(jp, case)):
        np.testing.assert_array_equal(a, b)

"""The JAX package's particle-schema tier (``tests/test_particle_schema.py``)
through both packages.

The schema cases run the same calls through ``parcels_tpu`` and the port:
the same exception type and message pattern, equal variable layouts and
equal SoA columns (exactly). The view cases build the same SoA from numpy,
as ``jnp`` arrays for the JAX package's ``Particles`` and as CPU tensors for
the port's, make the same writes and compare the columns exactly.

The RNG case holds each package to the JAX test's contract (the same key
gives the same draws, whatever the mask, and advances the key alike); the
port's streams are not the JAX package's threefry streams, by design
(``ROADMAP.md`` §3), so the draws are not compared across packages.
``test_view_works_under_jit`` (:141) has no counterpart: ``jax.jit`` is
JAX-only.
"""

from operator import attrgetter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu._core.particle import create_particle_data as j_create
from parcels_tpu._core.particles_view import Particles as JParticles
from parcels_tpu_torch._core.particle import create_particle_data as t_create
from parcels_tpu_torch._core.particles_view import Particles as TParticles
from torch_twins import PACKAGES, assert_same_error, raised

CREATE = {jp: j_create, tp: t_create}


def _same_errors(call):
    errs = [raised(lambda m=m: call(m)) for m in PACKAGES]
    assert_same_error(*errs)
    return errs


VARIABLE_ERRORS = {
    # test_particle_schema.py:21-29: the call and the JAX test's pattern
    "name": (lambda m: m.Variable("not a name"), "identifier"),
    "dtype": (lambda m: m.Variable("v", dtype="not_a_dtype"), "dtype"),
    "to_write": (lambda m: m.Variable("v", to_write="sometimes"), "to_write"),
    "attrs": (lambda m: m.Variable("v", to_write=False, attrs={"units": "m"}), "ttributes"),
}


@pytest.mark.parametrize("case", sorted(VARIABLE_ERRORS))
def test_variable_validation(case):
    call, match = VARIABLE_ERRORS[case]
    for e in _same_errors(call):
        assert match in str(e), e


def _layout(pclass):
    return [(v.name, np.dtype(v.dtype), v.initial, v.to_write, v.attrs) for v in pclass.variables]


def test_add_variable_returns_new_class():
    layouts = []
    for m in PACKAGES:
        base = m.get_default_particle()
        extra = base.add_variable(m.Variable("age", dtype=np.float32, initial=0.0))
        assert "age" in extra.var_names() and "age" not in base.var_names()
        layouts.append((_layout(base), _layout(extra)))
    assert layouts[1] == layouts[0]
    errs = _same_errors(lambda m: m.get_default_particle().add_variable(m.Variable("age"))
                        .add_variable(m.Variable("age")))
    assert "already exists" in str(errs[1])
    _same_errors(lambda m: m.get_default_particle().add_variable("age"))


def test_default_particle_layout():
    for m in PACKAGES:
        names = m.Particle.var_names()
        for required in ("t", "z", "y", "x", "dz", "dy", "dx", "particle_id", "dt", "state"):
            assert required in names
        by_name = {v.name: v for v in m.Particle.variables}
        assert by_name["t"].dtype == np.float64
        assert by_name["particle_id"].dtype == np.int64
        assert by_name["state"].initial == m.StatusCode.Evaluate
        assert by_name["dx"].to_write is False
    assert _layout(tp.Particle) == _layout(jp.Particle)


def _assert_same_data(jdata, tdata):
    assert sorted(tdata) == sorted(jdata)
    for k in jdata:
        assert np.asarray(tdata[k]).dtype == np.asarray(jdata[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(tdata[k]), np.asarray(jdata[k]), err_msg=k)


def test_create_particle_data_soa():
    datas = []
    for m in PACKAGES:
        pc = m.get_default_particle().add_variable(m.Variable("age", initial=7.0))
        data = CREATE[m](pclass=pc, nparticles=5, ngrids=2, initial={"x": np.arange(5.0)})
        assert data["x"].dtype == np.float32
        assert data["ei"].shape == (5, 2)
        assert data["age"].tolist() == [7.0] * 5
        assert data["t"].dtype == np.float32 and data["particle_id"].dtype == np.int32
        datas.append(data)
    _assert_same_data(*datas)

    def pc(m):
        return m.get_default_particle().add_variable(m.Variable("age", initial=7.0))

    errs = _same_errors(lambda m: CREATE[m](pclass=pc(m), nparticles=5, ngrids=1,
                                            initial={"x": np.zeros(3)}))
    assert "shape" in str(errs[1])
    errs = _same_errors(lambda m: CREATE[m](pclass=pc(m), nparticles=2, ngrids=1,
                                            initial={"nope": np.zeros(2)}))
    assert "not defined" in str(errs[1])


def test_attrgetter_initial_copies_other_variable():
    datas = []
    for m in PACKAGES:
        pc = m.get_default_particle().add_variable(m.Variable("x0", initial=attrgetter("x")))
        data = CREATE[m](pclass=pc, nparticles=4, ngrids=1, initial={"x": np.arange(4.0)})
        np.testing.assert_array_equal(data["x0"], data["x"])
        datas.append(data)
    _assert_same_data(*datas)


# -- the kernels' view, from the same numpy SoA -------------------------------------


def _soa(n=6):
    return {
        "x": np.arange(n, dtype=np.float32),
        "dx": np.zeros(n, np.float32),
        "state": np.full(n, jp.StatusCode.Evaluate, np.int32),
        "_active": np.ones(n, bool),
        "_rng": np.asarray([1, 2], np.uint32),
        "ei": np.zeros((n, 1), np.int32),
    }


def _views(mask):
    """The JAX package's view over ``jnp`` arrays and the port's over CPU
    tensors, of the same SoA under the same mask."""
    mask = np.asarray(mask)
    jview = JParticles({k: jnp.asarray(v) for k, v in _soa(mask.size).items()}, jnp.asarray(mask))
    tview = TParticles({k: torch.from_numpy(v) for k, v in _soa(mask.size).items()},
                       torch.from_numpy(mask))
    return jview, tview


def test_masked_write_through():
    views = _views([True, False, True, False, True, False])
    for p in views:
        p.dx = p.dx + 10.0
    outs = [np.asarray(p._data["dx"]) for p in views]
    np.testing.assert_array_equal(outs[0], [10, 0, 10, 0, 10, 0])
    np.testing.assert_array_equal(outs[1], outs[0])


def test_masked_read_returns_full_lane_array():
    views = _views([True, True, False, False, False, False])
    assert tuple(views[1].x.shape) == tuple(views[0].x.shape) == (6,)
    np.testing.assert_array_equal(np.asarray(views[1].x), np.asarray(views[0].x))


def test_state_write_respects_mask():
    mask = [False, True, False, True, False, True]
    jview, tview = _views(mask)
    jview.state = jnp.full(6, jp.StatusCode.Delete, jnp.int32)
    tview.state = torch.full((6,), tp.StatusCode.Delete, dtype=torch.int32)
    expect = np.where(mask, jp.StatusCode.Delete, jp.StatusCode.Evaluate)
    for p in (jview, tview):
        np.testing.assert_array_equal(np.asarray(p._data["state"]), expect)
    assert tview._data["state"].dtype == torch.int32


def test_rng_draws_deterministic_and_mask_stable():
    full, half = _views([True] * 6), _views([True, False] * 3)
    for p1, p2 in zip(full, half):
        r1 = np.asarray(p1.random_normal())
        r2 = np.asarray(p2.random_normal())
        assert r1.shape == (6,) and r1.dtype == np.float32
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(np.asarray(p1._data["_rng"]), np.asarray(p2._data["_rng"]))
        assert not np.array_equal(np.asarray(p1._data["_rng"]), [1, 2])  # the key advanced

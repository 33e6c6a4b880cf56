"""EngineOptions(colgather=...) in the port, against the port's other modes
and against parcels_tpu with the same option.

The JAX package's corner-column sampler (``ops/colgather.py``) reduces a
row of the corner-column table against a one-hot mask, which returns the
gathered value exactly; the port runs its plain gathers in every mode. On
the CPU the JAX package engages it only when forced, for fields with
2 <= T*Z <= 512 and Y*X >= 2^14 that neither the Pallas fold nor the binned
sampler takes: (2, 2, 128, 128) here. Tolerances are those of the port's
trajectory parity tests (RK4: rtol 1e-5, atol 1e-2 m).
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu.ops import colgather as jcolgather
from test_torch_slice import RK4_TOL, _fieldsets, _run, _seeds

torch.set_num_threads(1)

SHAPE = (2, 2, 128, 128)


@pytest.fixture(scope="module")
def runs():
    jfs, tfs = _fieldsets(SHAPE)
    seeds = _seeds(96, SHAPE, z=True)
    out = {}
    for mode in ("force", "off", "auto"):
        out[("torch", mode)] = _run(tfs, "torch", tp.AdvectionRK4, seeds,
                                    options=tp.EngineOptions(colgather=mode))
    return jfs, seeds, out


def test_jax_colgather_engages_on_the_fixture(runs, monkeypatch):
    jfs, seeds, _ = runs
    calls = []
    sample = jcolgather.colgather_sample
    monkeypatch.setattr(jcolgather, "colgather_sample",
                        lambda *a, **k: calls.append(1) or sample(*a, **k))
    _run(jfs, "jax", jp.AdvectionRK4, seeds, runtime=600,
         options=jp.EngineOptions(colgather="force"))
    assert calls, "the JAX package did not take its colgather path"


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_force_equals_other_modes_in_the_port(runs, mode):
    _, _, out = runs
    a, b = out[("torch", "force")], out[("torch", mode)]
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(a.z, b.z)
    np.testing.assert_array_equal(a.state, b.state)


def test_force_matches_reference_force(runs):
    jfs, seeds, out = runs
    jset = _run(jfs, "jax", jp.AdvectionRK4, seeds, options=jp.EngineOptions(colgather="force"))
    tset = out[("torch", "force")]
    np.testing.assert_allclose(tset.x, jset.x, **RK4_TOL)
    np.testing.assert_allclose(tset.y, jset.y, **RK4_TOL)
    np.testing.assert_allclose(tset.z, jset.z, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tset.state, jset.state)
    np.testing.assert_allclose(tset.t, jset.t, rtol=0, atol=0)

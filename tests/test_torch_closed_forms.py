"""The port's copies of the JAX package's closed-form fixtures.

``radial_rotation_dataset`` and ``decaying_moving_eddy_dataset`` of the port
equal the JAX package's builders, and ``ParticleSet.execute`` of the port
meets ``tests/test_advection.py``'s closed forms on them and agrees with the
JAX package's trajectories to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import datasets as j_datasets
from parcels_tpu_torch import datasets as t_datasets

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["radial_rotation_dataset", "decaying_moving_eddy_dataset",
                                  "stommel_gyre_dataset"])
def test_builders_equal_reference(name):
    a, b = getattr(t_datasets, name)(), getattr(j_datasets, name)()
    assert sorted(a.data_vars) == sorted(b.data_vars)
    for var in a.data_vars:
        np.testing.assert_array_equal(np.asarray(a[var].values), np.asarray(b[var].values))
    assert a.attrs == b.attrs


def _run(pkg, ds, x, y, dt_s, runtime_s):
    kw = {"device": "cpu"} if pkg is tp else {}
    fs = pkg.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw)
    pset = pkg.ParticleSet(fs, x=x, y=y, t=np.zeros(len(x)))
    pset.execute(pkg.AdvectionRK4, dt=np.timedelta64(dt_s, "s"),
                 runtime=np.timedelta64(runtime_s, "s"))
    return pset


def test_radial_rotation():
    """Solid-body rotation: a particle returns to its start after one period
    (dt 15 min here, against the JAX test's 30 s)."""
    x, y = [40.0, 30.0], [30.0, 40.0]
    a = _run(tp, t_datasets.radial_rotation_dataset(), x, y, 900, 86400)
    b = _run(jp, j_datasets.radial_rotation_dataset(), x, y, 900, 86400)
    np.testing.assert_allclose(a.x, x, atol=5e-2)
    np.testing.assert_allclose(a.y, y, atol=5e-2)
    np.testing.assert_allclose(a.x, b.x, rtol=1e-5)
    np.testing.assert_allclose(a.y, b.y, rtol=1e-5)


def _truth_decaying(x0, y0, t, u_0, u_g, f, gamma, gamma_g):
    lon = x0 + (
        u_g / gamma_g * (1 - np.exp(-gamma_g * t))
        + (u_0 - u_g) * f / (f**2 + gamma**2)
        * (gamma / f + np.exp(-gamma * t) * (np.sin(f * t) - gamma / f * np.cos(f * t)))
    )
    lat = y0 - (u_0 - u_g) * f / (f**2 + gamma**2) * (
        1 - np.exp(-gamma * t) * (np.cos(f * t) + gamma / f * np.sin(f * t))
    )
    return lon, lat


def test_decaying_moving_eddy():
    ds = t_datasets.decaying_moving_eddy_dataset()
    a = _run(tp, ds, [10000.0], [10000.0], 3600, 23 * 3600)
    b = _run(jp, j_datasets.decaying_moving_eddy_dataset(), [10000.0], [10000.0], 3600, 23 * 3600)
    at = ds.attrs
    exp_x, exp_y = _truth_decaying(10000.0, 10000.0, 23 * 3600.0, at["u_0"], at["u_g"], at["f"],
                                   at["gamma"], at["gamma_g"])
    np.testing.assert_allclose(a.x, exp_x, rtol=1e-5)
    np.testing.assert_allclose(a.y, exp_y, rtol=1e-5)
    np.testing.assert_allclose(a.x, b.x, rtol=1e-5)
    np.testing.assert_allclose(a.y, b.y, rtol=1e-5)

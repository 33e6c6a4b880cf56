"""Rectilinear index search: the port against parcels_tpu, same inputs.

Indices (and the -1/-2/-3 sentinels) must be identical. Barycentric
coordinates are the same f32 operations in both packages; they are held to
one f32 ulp near 1 (rtol 1e-6, atol 1e-7) because XLA may evaluate the
quotient with a reciprocal-multiply.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parcels_tpu._core import index_search as jis
from parcels_tpu._core.grid import XGrid as JXGrid
from parcels_tpu._core.grid import grid_search as j_grid_search
from parcels_tpu.datasets.structured import simple_UV_dataset as j_simple_UV
from parcels_tpu_torch._core import index_search as tis
from parcels_tpu_torch._core.grid import XGrid as TXGrid
from parcels_tpu_torch._core.grid import grid_search as t_grid_search
from parcels_tpu_torch.datasets import simple_UV_dataset as t_simple_UV

BC_TOL = dict(rtol=1e-6, atol=1e-7)


def _axes():
    rng = np.random.default_rng(1)
    return {
        "uniform": np.linspace(-5.0, 20.0, 26),
        "stretched_short": np.cumsum(rng.uniform(0.5, 3.0, 40)),
        "stretched_long": np.cumsum(rng.uniform(0.5, 3.0, 300)),
    }


@pytest.mark.parametrize("kind", ["uniform", "stretched_short", "stretched_long"])
def test_search_1d_matches(kind):
    from parcels_tpu._core.grid import _uniform_spacing

    arr = _axes()[kind]
    uniform = _uniform_spacing(arr)
    assert (uniform is not None) == (kind == "uniform")
    rng = np.random.default_rng(2)
    span = arr[-1] - arr[0]
    x = rng.uniform(arr[0] - 0.1 * span, arr[-1] + 0.1 * span, 2000).astype(np.float32)
    x[:5] = [arr[0], arr[-1], arr[1], np.nan, arr[0] - 1.0]
    arr32 = arr.astype(np.float32)
    ji, jb = jis.search_1d(jnp.asarray(arr32), jnp.asarray(x), uniform)
    ti, tb = tis.search_1d(torch.as_tensor(arr32), torch.as_tensor(x), uniform)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    assert {-1, -2} <= set(np.unique(ti.numpy()))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **BC_TOL)


@pytest.mark.parametrize("uniform", [True, False])
def test_search_time_matches(uniform):
    tflt = np.arange(0, 10 * 3600.0, 3600.0) if uniform else np.cumsum(np.arange(1.0, 11.0)) * 600
    spec = (tflt[0], tflt[1] - tflt[0], tflt[-1]) if uniform else None
    rng = np.random.default_rng(3)
    t = rng.uniform(-0.1 * tflt[-1], 1.1 * tflt[-1], 1000).astype(np.float32)
    j = jis.search_time(jnp.asarray(tflt.astype(np.float32)), jnp.asarray(t), spec)
    p = tis.search_time(torch.as_tensor(tflt.astype(np.float32)), torch.as_tensor(t), spec)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(p[1].numpy(), np.asarray(j[1]), **BC_TOL)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))


@pytest.mark.parametrize("dims", [(2, 5, 12, 9), (3, 1, 20, 30)])
def test_grid_search_matches(dims):
    jg = JXGrid(j_simple_UV(dims=dims, maxdepth=50.0, mesh="flat"), "flat")
    tg = TXGrid(t_simple_UV(dims=dims, maxdepth=50.0, mesh="flat"), "flat")
    for name in ("xdim", "ydim", "zdim", "lon_uniform", "lat_uniform", "depth_uniform",
                 "time_uniform", "offset_x", "offset_y", "offset_z", "spherical", "deg2m"):
        assert getattr(tg.spec, name) == getattr(jg.spec, name), name
    rng = np.random.default_rng(4)
    n = 1500
    z = rng.uniform(-5, 55, n).astype(np.float32)
    y = rng.uniform(-1.1e6, 1.1e6, n).astype(np.float32)
    x = rng.uniform(-1.1e6, 1.1e6, n).astype(np.float32)
    jg_arrs = jg.device_arrays()
    tg_arrs = tg.device_arrays("cpu")
    for k in ("lon", "lat", "depth", "time"):
        np.testing.assert_array_equal(tg_arrs[k].numpy(), np.asarray(jg_arrs[k]))
    jr = j_grid_search(jg.spec, jg_arrs, jnp.asarray(z), jnp.asarray(y), jnp.asarray(x))
    tr = t_grid_search(tg.spec, tg_arrs, *(torch.as_tensor(v) for v in (z, y, x)))
    for ax in "ZYX":
        np.testing.assert_array_equal(tr[ax]["index"].numpy(), np.asarray(jr[ax]["index"]))
        np.testing.assert_allclose(tr[ax]["bcoord"].numpy(), np.asarray(jr[ax]["bcoord"]), **BC_TOL)

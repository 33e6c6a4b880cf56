"""XNearest, the slip interpolators and the land-aware tracer of the port.

Values are held to ``parcels_tpu``'s on ``tests/test_slip_bc.py``'s inputs
and on random land masks with T, Z > 1 (rtol 1e-6, atol 1e-6; the slip
factors divide by the cell fraction, so the comparison is relative), and
``ParticleSet.execute`` runs each of them on the peninsula (its land has
U = V = P = 0) as the JAX package does, to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import xrlite as j_xr
from parcels_tpu.datasets import peninsula_dataset as j_peninsula
from parcels_tpu.datasets import simple_UV_dataset as j_simple_uv
from parcels_tpu_torch import xrlite as t_xr
from parcels_tpu_torch.datasets import peninsula_dataset as t_peninsula
from parcels_tpu_torch.datasets import simple_UV_dataset as t_simple_uv

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

PKGS = {"port": (tp, t_simple_uv, t_xr, {"device": "cpu"}), "jax": (jp, j_simple_uv, j_xr, {})}
VECTOR = ("XFreeslip", "XPartialslip")
SCALAR = ("XNearest", "XLinearInvdistLandTracer")


def _land_south(which, interp):
    """tests/test_slip_bc.py's fieldset: uniform U = 1 with a land row at the
    southernmost nodes."""
    pkg, simple_uv, _, kw = PKGS[which]
    ds = simple_uv(dims=(2, 1, 8, 8), mesh="flat")
    ds["U"].values[:] = 1.0
    ds["V"].values[:] = 0.0
    ds["U"].values[:, :, 0, :] = 0.0
    fs = pkg.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw)
    fs.fields["UV"].interp_method = getattr(pkg, interp)()
    fs._invalidate_caches()
    return fs


def _land_mask(which, seed=0, shape=(3, 3, 12, 12)):
    """Random U, V and a tracer P with land (zero) nodes: whole columns, and
    some nodes that are land at one depth level only."""
    pkg, simple_uv, xr, kw = PKGS[which]
    ds = simple_uv(dims=shape, mesh="flat")
    rng = np.random.default_rng(seed)
    T, Z, Y, X = shape
    u, v, p = (rng.uniform(-1.0, 1.0, shape) for _ in range(3))
    land = rng.random((Y, X)) < 0.35
    level = rng.random((Z, Y, X)) < 0.1
    for a in (u, v, p):
        a[..., land] = 0.0
        a[:, level] = 0.0
    ds["U"].values[:] = u
    ds["V"].values[:] = v
    ds["P"] = xr.DataArray(p, dims=("time", "depth", "YG", "XG"), name="P")
    return pkg.FieldSet.from_sgrid_conventions(ds, mesh="flat", **kw)


def _eval(which, fs, name, t, z, y, x):
    arr = torch.as_tensor if which == "port" else jnp.asarray
    view = getattr(fs.build_views(fs.device_arrays()), name)
    out = view.eval(*(arr(np.asarray(a, np.float32)) for a in (t, z, y, x)))
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("interp", VECTOR + ("XLinear_Velocity",))
def test_land_south_row_values(interp):
    """test_slip_bc.py's land-row point (eta = 0.25): free slip recovers
    u = 1, partial slip 0.5 + 0.5 eta, plain linear eta; the port equals the
    JAX package."""
    y_nodes = np.linspace(-1e6, 1e6, 8)
    eta = np.array([0.25, 0.6, 0.05])
    y = y_nodes[0] + eta * (y_nodes[1] - y_nodes[0])
    args = (np.zeros(3), np.zeros(3), y, np.zeros(3))
    got = _eval("port", _land_south("port", interp), "UV", *args)
    ref = _eval("jax", _land_south("jax", interp), "UV", *args)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
    want = {"XFreeslip": np.ones(3), "XPartialslip": 0.5 + 0.5 * eta,
            "XLinear_Velocity": eta}[interp]
    np.testing.assert_allclose(got[0], want, rtol=1e-4)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 2 * 365 * 86400.0 / 2, n), rng.uniform(0.0, 1.0, n),
            rng.uniform(-1e6, 1e6, n), rng.uniform(-1e6, 1e6, n))


@pytest.mark.parametrize("interp", VECTOR + SCALAR)
def test_random_land_masks_match_reference(interp):
    """Random land masks on a (3, 3, 12, 12) field: every corner pattern
    (all land, some land, a corner on the query point) against the JAX
    package, to 1e-6."""
    pts = _points(4000, seed=1)
    # some points exactly on nodes (the tracer's exact-corner branch)
    y_nodes = np.linspace(-1e6, 1e6, 12)
    pts[2][:100], pts[3][:100] = y_nodes[5], y_nodes[np.arange(100) % 12]
    out = {}
    for which in PKGS:
        fs = _land_mask(which, seed=2)
        name = "UV" if interp in VECTOR else "P"
        fs.fields[name].interp_method = getattr(PKGS[which][0], interp)()
        fs._invalidate_caches()
        out[which] = _eval(which, fs, name, *pts)
    for g, r in zip(out["port"], out["jax"]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
    if interp == "XLinearInvdistLandTracer":
        assert (out["port"][0] == 0).any() and (out["port"][0] != 0).mean() > 0.5


def _peninsula_run(which, uv_interp, p_interp):
    pkg = PKGS[which][0]
    ds = (t_peninsula if which == "port" else j_peninsula)(grid_type="A")
    fs = pkg.FieldSet.from_sgrid_conventions(ds, mesh="flat", **PKGS[which][3])
    fs.fields["UV"].interp_method = getattr(pkg, uv_interp)()
    fs.fields["P"].interp_method = getattr(pkg, p_interp)()
    fs._invalidate_caches()
    pclass = pkg.Particle.add_variable(pkg.Variable("p", dtype=np.float32))

    def SampleP(particles, fieldset):  # noqa: N802
        particles.p = fieldset.P[particles]

    rng = np.random.default_rng(4)
    n = 64
    pset = pkg.ParticleSet(fs, pclass=pclass, x=rng.uniform(2e3, 8e4, n),
                           y=rng.uniform(2e3, 4.5e4, n), t=np.zeros(n))
    pset.execute([pkg.AdvectionRK4, SampleP], dt=np.timedelta64(2, "m"),
                 runtime=np.timedelta64(1, "h"))
    return pset


@pytest.mark.parametrize("uv_interp,p_interp", [("XFreeslip", "XNearest"),
                                                ("XPartialslip", "XLinearInvdistLandTracer")])
def test_execute_on_peninsula_matches_reference(uv_interp, p_interp):
    a = _peninsula_run("port", uv_interp, p_interp)
    b = _peninsula_run("jax", uv_interp, p_interp)
    for var in ("x", "y", "p"):
        np.testing.assert_allclose(getattr(a, var), getattr(b, var), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(a.state, b.state)
    assert (a.p != 0).any()

"""CROCO sigma-grid kernels of the port against the JAX package.

``tests/test_sigmagrids.py``'s idealized CROCO set (uniform u, flat bottom,
cubic Cs_w stretching, free surface) goes through ``convert.croco_to_sgrid``
and ``FieldSet.from_sgrid_conventions`` of both packages:
``convert_z_to_sigma_croco`` agrees within 1e-6 and the
``AdvectionRK2_3D_CROCO`` + ``SampleOmegaCroco`` trajectories to rtol 1e-5,
and the JAX test's closed-form asserts hold on the port.
"""

import numpy as np
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import xrlite as j_xr
from parcels_tpu_torch import xrlite as t_xr

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

HC = 20.0
H0 = 126.0
PKGS = {"port": (tp, t_xr, {"device": "cpu"}), "jax": (jp, j_xr, {})}


def _croco_idealized(xr, nx=8, ny=8, nz=6, nt=2, u=1.0, v=0.0, zeta0=0.0, omega0=3.3,
                     extent=200e3, h=None):
    """Idealized CROCO output (tests/test_sigmagrids.py's), with an optional
    meridional flow and bathymetry."""
    x_rho = np.broadcast_to(np.linspace(0, extent, nx), (ny, nx)).copy()
    y_rho = np.broadcast_to(np.linspace(0, extent, ny)[:, None], (ny, nx)).copy()
    s_w = np.linspace(-1.0, 0.0, nz)
    cs_w = s_w**3
    h = np.full((ny, nx), H0, np.float32) if h is None else h
    fields = {
        "U": xr.DataArray(np.full((nt, nz, ny, nx - 1), u, np.float32),
                          dims=("time", "s_rho", "eta_rho", "xi_u"), name="U"),
        "V": xr.DataArray(np.full((nt, nz, ny - 1, nx), v, np.float32),
                          dims=("time", "s_rho", "eta_v", "xi_rho"), name="V"),
        "W": xr.DataArray(np.zeros((nt, nz, ny, nx), np.float32),
                          dims=("time", "s_w", "eta_rho", "xi_rho"), name="W"),
        "h": xr.DataArray(h, dims=("eta_rho", "xi_rho"), name="h"),
        "zeta": xr.DataArray(np.full((nt, ny, nx), zeta0, np.float32),
                             dims=("time", "eta_rho", "xi_rho"), name="zeta"),
        "Cs_w": xr.DataArray(cs_w.astype(np.float32), dims=("s_w",), name="Cs_w"),
        "omega": xr.DataArray(np.full((nt, nz, ny, nx), omega0, np.float32),
                              dims=("time", "s_w", "eta_rho", "xi_rho"), name="omega"),
    }
    coords = xr.Dataset(coords={
        "time": (("time",), np.arange(nt) * 20000.0, {"units": "seconds"}),
        "x_rho": (("eta_rho", "xi_rho"), x_rho, {"units": "m"}),
        "y_rho": (("eta_rho", "xi_rho"), y_rho, {"units": "m"}),
        "s_w": (("s_w",), s_w),
    })
    return fields, coords


def _fieldset(which, **kw):
    pkg, xr, fkw = PKGS[which]
    ds = pkg.convert.croco_to_sgrid(**dict(zip(("fields", "coords"), _croco_idealized(xr, **kw))))
    fs = pkg.FieldSet.from_sgrid_conventions(ds, **fkw)
    fs.add_context("hc", HC)
    return fs


def _z_of_sigma(sigma, h=H0, zeta=0.0):
    z0 = HC * sigma + (h - HC) * sigma**3
    return z0 + zeta * (1.0 + z0 / h)


def test_fieldset_layout_matches_reference():
    """The port takes the 1-D Cs_w and the 2-D h/zeta as the JAX package
    does: same field shapes, sigma levels on the depth axis, a C-grid UV."""
    a, b = _fieldset("port", zeta0=0.25), _fieldset("jax", zeta0=0.25)
    for name in ("U", "V", "W", "h", "zeta", "Cs_w", "omega"):
        assert a.fields[name].data.shape == b.fields[name].data.shape, name
        np.testing.assert_array_equal(a.fields[name].data, np.asarray(b.fields[name].data))
    np.testing.assert_array_equal(a.U.grid.depth, b.U.grid.depth)
    assert type(a.UV.interp_method).__name__ == type(b.UV.interp_method).__name__


def test_conversion_3DCROCO():
    s_levels = np.linspace(-1.0, 0.0, 6, dtype=np.float32)
    z_levels = _z_of_sigma(s_levels.astype(np.float64), zeta=0.25).astype(np.float32)
    args = (np.zeros_like(z_levels), z_levels, np.full_like(z_levels, 100e3),
            np.full_like(z_levels, 100e3), None)
    sig = {w: np.asarray(getattr(PKGS[w][0].kernels, "convert_z_to_sigma_croco")(
        _fieldset(w, zeta0=0.25), *args)) for w in PKGS}
    np.testing.assert_allclose(sig["port"], sig["jax"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(sig["port"], s_levels, atol=1e-3)
    zmid = 0.5 * (z_levels[:-1] + z_levels[1:])
    margs = (np.zeros_like(zmid), zmid, np.full_like(zmid, 100e3), np.full_like(zmid, 73e3), None)
    smid = {w: np.asarray(PKGS[w][0].kernels.convert_z_to_sigma_croco(_fieldset(w, zeta0=0.25),
                                                                       *margs)) for w in PKGS}
    np.testing.assert_allclose(smid["port"], smid["jax"], rtol=0, atol=1e-6)
    assert ((smid["port"] > s_levels[:-1]) & (smid["port"] < s_levels[1:])).all()


def _advect(which, **kw):
    pkg = PKGS[which][0]
    fs = _fieldset(which, **kw)
    X, Z = np.meshgrid([40e3, 80e3, 120e3], [-10.0, -100.0])
    X, Z = X.flatten(), Z.flatten()
    Y = np.full(X.size, 100e3)
    pclass = pkg.Particle.add_variable(pkg.Variable("omega"))
    pset = pkg.ParticleSet(fs, pclass=pclass, x=X, y=Y, z=Z, t=np.zeros(X.size))
    pset.execute([pkg.AdvectionRK2_3D_CROCO, pkg.SampleOmegaCroco],
                 runtime=np.timedelta64(10_000, "s"), dt=np.timedelta64(100, "s"))
    return pset, X, Y, Z


def test_advection_3DCROCO():
    """The JAX test's run through the port: with w = 0 the particle holds
    its depth exactly while advecting at u in x."""
    a, X, Y, Z = _advect("port")
    np.testing.assert_allclose(a.z, Z, atol=1e-3)
    np.testing.assert_allclose(a.x, X + 10_000.0, atol=1e-2)
    np.testing.assert_allclose(a.y, Y, atol=1e-3)
    np.testing.assert_allclose(a.omega, 3.3, rtol=1e-6)
    assert torch.is_tensor(a._data["z"])


def test_advection_3DCROCO_sloped_matches_reference():
    """A meridional flow over a sloping bottom under a free surface, where
    each particle's sigma and depth change with h: the port's trajectories
    and omega samples equal the JAX package's."""
    h = np.broadcast_to(np.linspace(80.0, 160.0, 8)[:, None], (8, 8)).astype(np.float32).copy()
    kw = dict(v=0.3, zeta0=0.4, h=h)
    (a, X, Y, Z), (b, *_) = _advect("port", **kw), _advect("jax", **kw)
    for var in ("x", "y", "z", "omega"):
        np.testing.assert_allclose(getattr(a, var), getattr(b, var), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(a.state, b.state)
    assert np.abs(a.y - Y).min() > 1e3 and np.abs(a.z - Z).max() > 0.1

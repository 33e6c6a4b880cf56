"""The four SGRID padding layouts through the port, against parcels_tpu.

``tests/test_padding_variants.py``'s inputs (the reference's ds_2d_left /
right / inner / outer fixtures: MITgcm HIGH, NEMO LOW, NONE and BOTH
padding): the port's datasets equal the JAX package's, and sampling and
advection through every structured interpolator agree with it. Tolerances:
the advection closed forms of the reference test (1e-2 m A-grid, 1 m
C-grid after 30 and 10 minutes at 1 m/s) and rtol 1e-6 against the JAX
package's positions and samples.
"""

import numpy as np
import pytest

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import _sgrid as jsgrid
from parcels_tpu.datasets import generic_datasets as j_generic
from parcels_tpu.datasets import padded_variant_dataset as j_padded
from parcels_tpu_torch import _sgrid as tsgrid
from parcels_tpu_torch.datasets import generic_datasets as t_generic
from parcels_tpu_torch.datasets import padded_variant_dataset as t_padded

VARIANTS = ("left", "right", "inner", "outer")
PADDING = {"ds_2d_left": "HIGH", "ds_2d_right": "LOW", "ds_2d_inner": "NONE",
           "ds_2d_outer": "BOTH"}


def _fieldset(mod, variant):
    ds = (j_padded if mod is jp else t_padded)(variant)
    kw = {} if mod is jp else {"device": "cpu"}
    return mod.FieldSet.from_sgrid_conventions(
        ds, mesh="flat",
        vector_fields={"UV": ("U_A_grid", "V_A_grid"), "UV_C": ("U_C_grid", "V_C_grid")}, **kw)


def test_registry_equals_reference():
    treg, jreg = t_generic(), j_generic()
    assert sorted(treg) == sorted(jreg) == sorted(PADDING)
    for name, ds in treg.items():
        meta = tsgrid.parse_sgrid_metadata(ds)
        assert repr(meta) == repr(jsgrid.parse_sgrid_metadata(jreg[name]))
        for fnp in meta.face_dimensions:
            assert fnp.padding == tsgrid.Padding[PADDING[name]], name
        nf = ds.sizes[meta.face_dimensions[0].face]
        nn = ds.sizes[meta.face_dimensions[0].node]
        assert nf == tsgrid.get_n_faces(nn, tsgrid.Padding[PADDING[name]])
        for var in list(jreg[name].data_vars) + list(jreg[name].coords):
            np.testing.assert_array_equal(np.asarray(ds[var].values),
                                          np.asarray(jreg[name][var].values))
            assert ds[var].attrs == jreg[name][var].attrs


def _cgrid_kernel(particles, fieldset):
    u, v = fieldset.UV_C[particles]
    particles.dx += u * particles.dt
    particles.dy += v * particles.dt


@pytest.mark.parametrize("grid", ["A", "C"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_advection_matches_reference(variant, grid):
    """Uniform 1 m/s flow advects exactly in every layout, A-grid through
    AdvectionRK4, C-grid face-normal velocities through a user kernel."""
    out = {}
    for mod in (jp, tp):
        pset = mod.ParticleSet(_fieldset(mod, variant), x=[2500.0, 3400.0], y=[3000.0, 2200.0],
                               z=[15.0, 5.0], t=[np.timedelta64(0, "s")] * 2)
        kernel, minutes = (mod.AdvectionRK4, 30) if grid == "A" else (_cgrid_kernel, 10)
        pset.execute(kernel, dt=np.timedelta64(60, "s"), runtime=np.timedelta64(minutes, "m"))
        out[mod] = (np.asarray(pset.x), np.asarray(pset.y), np.asarray(pset.state))
    tx, ty, ts = out[tp]
    shift = 1800.0 if grid == "A" else 600.0
    np.testing.assert_allclose(tx, [2500.0 + shift, 3400.0 + shift],
                               atol=1e-2 if grid == "A" else 1.0)
    np.testing.assert_allclose(ty, [3000.0, 2200.0], atol=1e-5)
    np.testing.assert_allclose(tx, out[jp][0], rtol=1e-6)
    np.testing.assert_allclose(ty, out[jp][1], rtol=1e-6)
    np.testing.assert_array_equal(ts, out[jp][2])


@pytest.mark.parametrize("variant", VARIANTS)
def test_interpolators_sample_like_reference(variant, monkeypatch):
    """XLinear/XNearest on node- and face-placed scalars, XFreeslip/
    XPartialslip on the A-grid vector field, in every layout.

    These fields fit K1, so the JAX package runs its Pallas fold here (in
    interpret mode, as its own CPU tests do), which is what the port's K1
    and its plain version compute: a corner outside the data contributes
    nothing. (The JAX package's XLA path clamps such a corner instead; the
    face-placed data of the NONE layout is one cell smaller than the grid,
    so the two JAX paths differ at its last cell.)
    """
    monkeypatch.setenv("PARCELS_TPU_FORCE_PALLAS_INTERPRET", "1")
    t, z = np.timedelta64(30, "m"), np.array([12.0, 18.0, 3.0])
    y, x = np.array([2500.0, 3100.0, 5400.0]), np.array([2500.0, 4100.0, 6500.0])
    got = {}
    for mod in (jp, tp):
        fs = _fieldset(mod, variant)
        vals = []
        for fname in ("data_g", "data_c"):
            for method in (mod.XLinear(), mod.XNearest()):
                fs.fields[fname].interp_method = method
                fs._invalidate_caches()
                vals.append(np.asarray(fs.fields[fname].eval(t, z, y, x)))
        for method in (mod.XFreeslip(), mod.XPartialslip()):
            fs.fields["UV"].interp_method = method
            fs._invalidate_caches()
            vals.extend(np.asarray(c) for c in fs.fields["UV"].eval(t, z, y, x))
        got[mod] = vals
    for a, b in zip(got[tp], got[jp]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert all(np.all((v >= 0.0) & (v <= 1.0)) for v in got[tp][:4])

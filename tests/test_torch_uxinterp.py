"""The port's four UGRID interpolators and Ux_Velocity against parcels_tpu.

``UV.eval`` on the same points, for every {node, face} x {zc, zf}
placement, through the gather tier (``uxcol`` off) and the corner-column
tier (``uxcol`` forced), in both packages, at the tolerance of
tests/test_uxcol.py (rtol 1e-6, atol 1e-7). ``PARCELS_TPU_UXCOL`` is set
for both packages by monkeypatch.
"""

import numpy as np
import pytest

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu.datasets.unstructured import delaunay_flow_dataset as j_dataset
from parcels_tpu_torch.datasets.unstructured import delaunay_flow_dataset as t_dataset

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tier", ["off", "force"])
@pytest.mark.parametrize("placement,vertical", [
    ("node", "zc"), ("node", "zf"), ("face", "zc"), ("face", "zf"),
])
def test_uv_eval_matches(monkeypatch, placement, vertical, tier):
    monkeypatch.setenv("PARCELS_TPU_UXCOL", tier)
    kw = dict(flow="rotation", placement=placement, vertical=vertical, nx=25, ny=25,
              with_w=True, w0=1e-3)
    jfs = jp.FieldSet.from_ugrid_conventions(j_dataset(**kw), mesh="flat")
    tfs = tp.FieldSet.from_ugrid_conventions(t_dataset(**kw), mesh="flat", device="cpu")
    rng = np.random.default_rng(7)
    n = 500
    x = rng.uniform(1e4, 9e4, n)
    y = rng.uniform(1e4, 9e4, n)
    z = rng.uniform(1.0, 90.0, n)
    t = np.full(n, 3600.0)
    x[:3] = [-5e3, 1.2e5, 5e4]  # out of the mesh on both sides, then out in depth
    z[2] = 150.0
    got = tfs.UVW.eval(t, z, y, x)
    ref = jfs.UVW.eval(t, z, y, x)
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    assert np.all(got[0][:3] == 0.0), "out-of-bounds samples return 0"
    assert np.abs(got[0][3:]).max() > 0.1
    # the tier ran: the column table was built once, on the fieldset's arrays
    farrays = tfs.device_arrays()
    assert ("col" in farrays["tables"]["U"]) == (tier == "force")
    assert ("face_table" in farrays["grids"][0]) == (tier == "force")

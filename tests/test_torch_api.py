"""The JAX package's API tier (``tests/test_api.py``) through both packages.

The reference's 33 public names, the grids' ``BaseGrid`` classes, the host
searches of ``XGrid`` and ``UxGrid`` (equal indices, barycentric
coordinates within 1e-6), ``open_raw_zarr`` on stores written by either
package (equal values), the package logger and the interpolator names:
the JAX test's assertions on both packages (the port's fieldsets and
searches on the CPU, as its ``device="cpu"`` asks), and the port's results
held to the JAX package's.
"""

import logging

import numpy as np
import pytest

import parcels_tpu as jp
import parcels_tpu_torch as tp
from torch_twins import PACKAGES, datasets, sgrid, ugrid

# tests/test_api.py:16, the reference's src/parcels/__init__.py:47-82
REFERENCE_ALL = [
    "AdvectionRK45", "AllParcelsErrorCodes", "BaseGrid", "Field", "FieldInterpolationError",
    "FieldOutOfBoundError", "FieldSamplingError", "FieldSet", "KernelError",
    "OutsideTimeInterval", "Particle", "ParticleClass", "ParticleFile", "ParticleSet",
    "SphericalMesh", "StatusCode", "TimeInterval", "UxGrid", "Variable", "VectorField", "XGrid",
    "convert", "io", "kernels", "logger", "open_raw_zarr", "read_particlefile", "tutorial",
    "FieldSetWarning", "FieldEvalWarning", "FileWarning", "KernelWarning", "ParticleSetWarning",
]


@pytest.mark.parametrize("mod", PACKAGES, ids=["jax", "torch"])
def test_reference_api_surface_is_covered(mod):
    missing = [n for n in REFERENCE_ALL if n not in mod.__all__]
    assert not missing, f"missing reference exports: {missing}"
    for n in mod.__all__:
        assert hasattr(mod, n), n


def _unstructured(m):
    from importlib import import_module

    return import_module(f"{m.__name__}.datasets.unstructured")


def test_grids_subclass_basegrid():
    for m in PACKAGES:
        grid = sgrid(m, datasets(m).simple_UV_dataset(), mesh="flat").U.grid
        assert isinstance(grid, m.BaseGrid) and isinstance(grid, m.XGrid)
        ugrid_ = ugrid(m, _unstructured(m).delaunay_flow_dataset()).U.grid
        assert isinstance(ugrid_, m.BaseGrid) and isinstance(ugrid_, m.UxGrid)


def _search(m, grid, *args, **kw):
    """``grid.search``; the port's on the CPU (it defaults to the card)."""
    return grid.search(*args, **kw) if m is jp else grid.search(*args, device="cpu", **kw)


def _host(pos):
    return {ax: {k: np.asarray(v) for k, v in d.items()} for ax, d in pos.items()}


def _assert_same_positions(jpos, tpos):
    jpos, tpos = _host(jpos), _host(tpos)
    assert set(tpos) == set(jpos)
    for ax in jpos:
        np.testing.assert_array_equal(tpos[ax]["index"], jpos[ax]["index"], err_msg=ax)
        np.testing.assert_allclose(tpos[ax]["bcoord"], jpos[ax]["bcoord"], rtol=0, atol=1e-6,
                                   err_msg=ax)


def test_xgrid_host_search_scalars_and_arrays():
    found = {}
    for m in PACKAGES:
        grid = sgrid(m, datasets(m).simple_UV_dataset(), mesh="flat").U.grid
        lon, lat = np.asarray(grid.lon), np.asarray(grid.lat)
        x = 0.5 * (lon[1] + lon[2])
        y = 0.5 * (lat[0] + lat[1])
        pos = _search(m, grid, 0.0, y, x)
        assert set(pos) >= {"Y", "X"}
        assert pos["X"]["index"][0] == 1 and pos["Y"]["index"][0] == 0
        np.testing.assert_allclose(pos["X"]["bcoord"][0], 0.5, atol=1e-5)
        np.testing.assert_allclose(pos["Y"]["bcoord"][0], 0.5, atol=1e-5)
        ei = grid.ravel_index(0, pos["Y"]["index"], pos["X"]["index"])
        pos2 = _search(m, grid, np.zeros(1), np.asarray([y]), np.asarray([x]), ei=ei)
        assert pos2["X"]["index"][0] == 1
        oob = _search(m, grid, 0.0, y, lon[-1] + (lon[-1] - lon[0]))
        assert oob["X"]["index"][0] < 0
        found[m] = (pos, pos2, oob, np.asarray(ei))
    for jp_, tp_ in zip(found[jp][:3], found[tp][:3]):
        _assert_same_positions(jp_, tp_)
    np.testing.assert_array_equal(found[tp][3], found[jp][3])


def test_uxgrid_host_search():
    found = {}
    for m in PACKAGES:
        grid = ugrid(m, _unstructured(m).delaunay_flow_dataset()).U.grid
        tri = np.asarray(grid.face_node_connectivity)[0]
        cx = np.asarray(grid.node_lon)[tri].mean()
        cy = np.asarray(grid.node_lat)[tri].mean()
        depth = np.asarray(grid.depth)
        pos = _search(m, grid, 0.5 * (depth[0] + depth[1]), cy, cx)
        assert set(pos) == {"Z", "FACE"}
        assert pos["FACE"]["index"][0] == 0
        assert pos["FACE"]["bcoord"].shape[-1] == 3
        found[m] = pos
    _assert_same_positions(found[jp], found[tp])


@pytest.mark.parametrize("writer", PACKAGES, ids=["jax", "torch"])
def test_open_raw_zarr_alias(writer, tmp_path):
    """A store written by either package reads the same through both
    packages' ``open_raw_zarr`` (by path and through a store's ``root``)."""
    from importlib import import_module

    ds = datasets(writer).simple_UV_dataset()
    path = str(tmp_path / "raw.zarr")
    import_module(f"{writer.__name__}.io").write_zarr_dataset(ds, path)

    class FakeStore:
        root = path

    reads = []
    for m in PACKAGES:
        out = m.open_raw_zarr(path)
        assert "U" in out.data_vars
        np.testing.assert_allclose(np.asarray(out["U"].values), np.asarray(ds["U"].values),
                                   atol=1e-6)
        assert "V" in m.open_raw_zarr(FakeStore()).data_vars
        reads.append({k: np.asarray(out[k].values) for k in ("U", "V")})
    for k in ("U", "V"):
        np.testing.assert_array_equal(reads[1][k], reads[0][k])


def test_logger_is_package_logger():
    for m in PACKAGES:
        assert isinstance(m.logger, logging.Logger)
        assert m.logger.name == m.__name__
    assert tp.logger.level == jp.logger.level
    assert [type(h) for h in tp.logger.handlers] == [type(h) for h in jp.logger.handlers]


def test_reference_interpolator_names_importable():
    import parcels_tpu.interpolators as jinterp
    import parcels_tpu_torch.interpolators as tinterp

    ref = [
        "CGrid_Tracer", "CGrid_Velocity", "XConstantField", "XFreeslip",
        "XLinear", "XLinearInvdistLandTracer", "XLinear_Velocity", "XNearest",
        "XPartialslip", "Ux_Velocity", "UxConstantFaceConstantZC",
        "UxConstantFaceLinearZF", "UxLinearNodeConstantZC", "UxLinearNodeLinearZF",
    ]
    for interp in (jinterp, tinterp):
        missing = [n for n in ref if n not in interp.__all__ or not hasattr(interp, n)]
        assert not missing, missing
    assert sorted(tinterp.__all__) == sorted(jinterp.__all__)

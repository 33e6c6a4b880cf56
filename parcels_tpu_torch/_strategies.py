"""Hypothesis strategies for property-based testing (reference _strategies/).

Public so downstream users can property-test their own pipelines, mirroring
the reference's ``parcels._strategies`` package (sgrid.py:11, time.py:29-58).
"""

from __future__ import annotations

import numpy as np

try:
    from hypothesis import strategies as st
except ImportError as e:  # pragma: no cover
    raise ImportError("parcels_tpu_torch._strategies requires the 'hypothesis' package") from e

from parcels_tpu_torch import _sgrid as sgrid
from parcels_tpu_torch._core.timeutils import TimeInterval

__all__ = ["paddings", "sgrid_dataset", "sgrid_metadata", "time_intervals"]

_dim_names = st.text(
    alphabet=st.characters(whitelist_categories=("Ll", "Lu"), max_codepoint=122),
    min_size=1,
    max_size=8,
).filter(str.isidentifier)

paddings = st.sampled_from(list(sgrid.Padding))


@st.composite
def sgrid_metadata(draw):
    """Random valid SGrid2DMetadata with unique dimension names."""
    names = draw(st.lists(_dim_names, min_size=7, max_size=7, unique=True))
    xn, yn, xf, yf, zn, zf, cx = names
    return sgrid.SGrid2DMetadata(
        node_dimensions=(xn, yn),
        node_coordinates=(cx, cx + "y"),
        face_dimensions=(
            sgrid.FaceNodePadding(xf, xn, draw(paddings)),
            sgrid.FaceNodePadding(yf, yn, draw(paddings)),
        ),
        vertical_dimensions=(sgrid.FaceNodePadding(zf, zn, draw(paddings)),),
    )


@st.composite
def time_intervals(draw, max_start_s: int = 10**9, max_length_s: int = 10**9):
    """Random TimeInterval over np.datetime64 nanoseconds."""
    start = draw(st.integers(min_value=0, max_value=max_start_s))
    length = draw(st.integers(min_value=1, max_value=max_length_s))
    left = np.datetime64("2000-01-01", "ns") + np.timedelta64(start, "s")
    return TimeInterval(left, left + np.timedelta64(length, "s"))


@st.composite
def sgrid_dataset(draw, grid: "sgrid.SGrid2DMetadata | None" = None):
    """Whole random SGRID dataset built from (possibly drawn) metadata.

    Mirrors reference _datasets/structured/strategies.py:11-85: node/face dim
    sizes satisfying the padding arithmetic, optional curvilinear 2-D node
    coordinates, optional vertical axis, and 1-4 data variables on random
    node/face placements.
    """
    from parcels_tpu_torch import xrlite as xr

    if grid is None:
        grid = draw(sgrid_metadata())
    elif grid.node_coordinates is None:
        raise ValueError("grid in parcels_tpu_torch must have node_coordinates set")

    N = draw(st.integers(min_value=5, max_value=40))
    M = draw(st.integers(min_value=5, max_value=40))
    node_dim1, node_dim2 = grid.node_dimensions
    fnp1, fnp2 = grid.face_dimensions
    N_face = sgrid.get_n_faces(N, fnp1.padding)
    M_face = sgrid.get_n_faces(M, fnp2.padding)

    has_vertical = grid.vertical_dimensions is not None
    if has_vertical:
        P = draw(st.integers(min_value=5, max_value=12))
        fnp_z = grid.vertical_dimensions[0]
        P_face = sgrid.get_n_faces(P, fnp_z.padding)

    coord1, coord2 = grid.node_coordinates
    rngseed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    rng = np.random.default_rng(rngseed)
    if draw(st.booleans()):  # curvilinear 2-D node coordinates
        c1, c2 = np.meshgrid(np.linspace(0, 100, N), np.linspace(0, 100, M), indexing="ij")
        coords = {
            coord1: ((node_dim1, node_dim2), c1),
            coord2: ((node_dim1, node_dim2), c2),
        }
    else:
        coords = {
            coord1: ((node_dim1,), np.linspace(0, 100, N)),
            coord2: ((node_dim2,), np.linspace(0, 100, M)),
        }

    data_vars = {}
    for i in range(draw(st.integers(min_value=1, max_value=4))):
        dim1 = draw(st.sampled_from([node_dim1, fnp1.face]))
        size1 = N if dim1 == node_dim1 else N_face
        dim2 = draw(st.sampled_from([node_dim2, fnp2.face]))
        size2 = M if dim2 == node_dim2 else M_face
        if has_vertical and draw(st.booleans()):
            vdim = draw(st.sampled_from([fnp_z.node, fnp_z.face]))
            vsize = P if vdim == fnp_z.node else P_face
            dims, shape = (vdim, dim1, dim2), (vsize, size1, size2)
        else:
            dims, shape = (dim1, dim2), (size1, size2)
        data_vars[f"field_{i}"] = (dims, 1e-3 + 100.0 * rng.random(shape))

    ds = xr.Dataset(data_vars=data_vars, coords=coords)
    return sgrid.attach_sgrid_metadata(ds, grid)


@st.composite
def sgrid3d_metadata(draw):
    """Random valid SGrid3DMetadata: 3 node dims x 3 padded volume dims with
    all four paddings drawn independently (reference round-trip depth,
    _sgrid/core.py:192-260)."""
    names = draw(st.lists(_dim_names, min_size=9, max_size=9, unique=True))
    xn, yn, zn, xv, yv, zv, cx, cy, cz = names
    return sgrid.SGrid3DMetadata(
        node_dimensions=(xn, yn, zn),
        node_coordinates=(cx, cy, cz),
        volume_dimensions=(
            sgrid.FaceNodePadding(xv, xn, draw(paddings)),
            sgrid.FaceNodePadding(yv, yn, draw(paddings)),
            sgrid.FaceNodePadding(zv, zn, draw(paddings)),
        ),
    )

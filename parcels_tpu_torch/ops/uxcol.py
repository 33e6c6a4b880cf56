"""Unstructured (UGRID) row tier: fused face rows and corner-column tables (torch).

Port of the JAX package's ``ops/uxcol.py``:

1. **Fused per-face geometry rows** (``build_face_table``): one
   (n_face, 64) f32 table holding the 3 corner-node embedding coordinates,
   the 3 node ids and the 3 edge-adjacent face ids (ids stored as the f32
   bit patterns of their int32 values). A barycentric point-in-face check,
   and a walk hop, read one row instead of a connectivity row plus three
   node rows. The ids are moved only by copies and gathers and read back
   with ``Tensor.view(torch.int32)``: small ids are f32 denormals and -1 is
   a NaN pattern, so no float arithmetic, ``where`` or cast touches them.
   A row read takes the 15 columns the row ops use, not the zero padding.

2. **Corner-column data tables** (``ux_col_table``): the (T, Z, N) field
   transposed to (N, >=64) rows, so one (t, z)-blended sample per face or
   node is a row read and a weighted reduce over the row; and the
   per-(node, time) z-row tables of the stage cache (``ux_colT_table``,
   ``ux_colT_uv_table``), from which ``ops/uxcache`` reads the exact
   corner elements.

The barycentric math mirrors the JAX package's, with one deliberate
difference on spherical meshes: each sub-triangle area takes the sign of
its normal along the face normal (``_signed_area``), so a point outside a
face gets a negative coordinate and the walk has a direction. The JAX
package uses unsigned areas there; on flat meshes both are the same.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = [
    "MAX_COLS",
    "MIN_FACES",
    "ROW_WIDTH",
    "adj_from_rows",
    "bary_from_rows",
    "bary_from_verts",
    "build_face_table",
    "col_usable",
    "enabled",
    "face_rows",
    "nids_from_rows",
    "node_ids",
    "sample_col",
    "ux_col_table",
    "ux_colT_table",
    "ux_colT_uv_table",
    "verts_from_rows",
    "weight_row",
]

#: fused face-row width (the JAX package's, which keeps its table row-major)
ROW_WIDTH = 64
# column layout
_V0, _V1, _V2 = 0, 3, 6  # corner embedding coords (x, y, z; z = 0 flat)
_NID = 9  # 3 node ids, int32 bit patterns
_ADJ = 12  # 3 edge-adjacent face ids, int32 bit patterns (-1 = boundary)
#: the columns a row op reads
_ROW_USED = _ADJ + 3

#: least faces for the fused tier to pay for its memory (256 B a face)
MIN_FACES = 1 << 12
#: node/face column-table width cap (T * Z)
MAX_COLS = 512


def _mode() -> str:
    return os.environ.get("PARCELS_TPU_UXCOL", "auto")


def enabled(n_face: int, device) -> bool:
    """Gate of the fused tier. ``PARCELS_TPU_UXCOL`` (set by
    ``EngineOptions(uxcol=...)``) is ``auto``, ``force`` or ``off``; ``auto``
    is on for meshes of at least ``MIN_FACES`` faces on CUDA (the JAX
    package's gate is on for every backend but the CPU)."""
    mode = _mode()
    if mode in ("0", "off"):
        return False
    if mode == "force":
        return True
    return n_face >= MIN_FACES and torch.device(device).type == "cuda"


def col_usable(shape3) -> bool:
    T, Z, _ = shape3
    return T * Z <= MAX_COLS


# ---------------------------------------------------------------------------
# host-side table build
# ---------------------------------------------------------------------------


def build_face_table(nodes: np.ndarray, conn: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """(n_face, 64) fused geometry rows from host mesh arrays.

    ``nodes`` is (n_node, 2|3) embedding coordinates (unit-sphere XYZ for
    spherical meshes, (x, y) flat); ``conn`` (n_face, 3) node ids; ``adj``
    (n_face, 3) edge-adjacent faces (-1 on the boundary).
    """
    nodes = np.asarray(nodes, dtype=np.float32)
    conn = np.asarray(conn, dtype=np.int32)
    adj = np.asarray(adj, dtype=np.int32)
    d = nodes.shape[1]
    tbl = np.zeros((conn.shape[0], ROW_WIDTH), dtype=np.float32)
    for k, off in enumerate((_V0, _V1, _V2)):
        tbl[:, off : off + d] = nodes[conn[:, k]]
    tbl[:, _NID : _NID + 3] = conn.view(np.float32)
    tbl[:, _ADJ : _ADJ + 3] = adj.view(np.float32)
    return tbl


# ---------------------------------------------------------------------------
# row ops
# ---------------------------------------------------------------------------


def face_rows(table, fi):
    """The used columns of the fused rows at (clamped) face indices ``fi``."""
    idx = torch.clamp(fi, 0, table.shape[0] - 1).long()
    return table[:, :_ROW_USED][idx]


def nids_from_rows(row):
    """(n, 3) int32 node ids of the rows."""
    return row[:, _NID : _NID + 3].view(torch.int32)


def adj_from_rows(row, k):
    """Per-lane face across edge ``k`` (n,) of the rows (-1 on the boundary)."""
    a = row[:, _ADJ : _ADJ + 3].view(torch.int32)
    return torch.where(k == 0, a[:, 0], torch.where(k == 1, a[:, 1], a[:, 2]))


def verts_from_rows(row, spherical: bool):
    """(n, 3*d) packed corner coordinates (d = 2 flat, 3 spherical): the
    per-lane triangle frame the stage cache carries across RK stages."""
    d = 3 if spherical else 2
    return torch.cat([row[:, _V0 : _V0 + d], row[:, _V1 : _V1 + d], row[:, _V2 : _V2 + d]],
                     dim=1)


def _cross(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    return (a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0)


def _sub(a, b):
    return tuple(p - q for p, q in zip(a, b))


def _norm(c):
    return torch.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])


def _signed_area(a, b, c, nhat):
    """Half the norm of ``(b - a) x (c - a)`` (the JAX package's unsigned
    spherical area), negative where that normal points against ``nhat``."""
    cr = _cross(_sub(b, a), _sub(c, a))
    area = 0.5 * _norm(cr)
    facing = cr[0] * nhat[0] + cr[1] * nhat[1] + cr[2] * nhat[2]
    return torch.where(facing < 0, -area, area)


def bary(v0, v1, v2, p, spherical: bool):
    """Barycentric coords (n, 3) of points ``p`` in triangles (v0, v1, v2);
    each argument is a tuple of per-axis (n,) tensors. Spherical meshes
    project the query onto the face's plane first."""
    if spherical:
        nhat = _cross(_sub(v1, v0), _sub(v2, v0))
        norm = _norm(nhat)
        norm = torch.where(norm == 0.0, 1.0, norm)
        nhat = tuple(c / norm for c in nhat)
        pt = _sub(p, v0)
        dot = pt[0] * nhat[0] + pt[1] * nhat[1] + pt[2] * nhat[2]
        p = tuple(q - dot * n + v for q, n, v in zip(pt, nhat, v0))

        def area(a, b, c):
            return _signed_area(a, b, c, nhat)
    else:

        def area(a, b, c):
            d1 = _sub(b, a)
            d2 = _sub(c, a)
            return 0.5 * (d1[0] * d2[1] - d1[1] * d2[0])

    a = area(v0, v1, v2)
    a = torch.where(torch.abs(a) < 1e-30, 1e-30, a)
    return torch.stack([area(p, v1, v2) / a, area(p, v2, v0) / a, area(p, v0, v1) / a],
                       dim=-1)


def _axes(t):
    return tuple(t[:, k] for k in range(t.shape[1]))


def bary_from_verts(verts, pts, spherical: bool):
    """Barycentric coords of ``pts`` (n, d) against packed (n, 3*d) corners."""
    d = 3 if spherical else 2
    v = [_axes(verts[:, k * d : (k + 1) * d]) for k in range(3)]
    return bary(*v, _axes(pts), spherical)


def bary_from_rows(row, pts, spherical: bool):
    """Barycentric coords of ``pts`` in the rows' triangles -> (n, 3)."""
    return bary_from_verts(verts_from_rows(row, spherical), pts, spherical)


# ---------------------------------------------------------------------------
# corner-column data tables, built once per fieldset device arrays
# ---------------------------------------------------------------------------


def _padded(t, width):
    if t.shape[1] < width:
        t = torch.nn.functional.pad(t, (0, width - t.shape[1]))
    return t.contiguous()


def ux_col_table(field):
    """(N, max(T*Z, 64)) column table of a (T, Z, N) field, cached."""
    tbl = field._tables.get("col")
    if tbl is None:
        T, Z, N = field.data.shape
        tbl = _padded(field.data.reshape(T * Z, N).t(), ROW_WIDTH)
        field._tables["col"] = tbl
    return tbl


def _colT(data):
    T, Z, N = data.shape
    return _padded(data.permute(2, 0, 1).reshape(N * T, Z), max(Z, ROW_WIDTH))


def ux_colT_table(field):
    """(N*T, max(Z, 64)) per-(node, time) z-row table, cached: row
    ``node * T + t`` holds one node's depth column at one time level."""
    tbl = field._tables.get("colT")
    if tbl is None:
        tbl = field._tables["colT"] = _colT(field.data)
    return tbl


def ux_colT_uv_table(vf):
    """(N*T, 2*max(Z, 64)) fused [U | V] z-row table, cached on the vector
    view: one row serves both components' corners."""
    tbl = vf._tables.get("uv_colT")
    if tbl is None:
        tbl = torch.cat([_colT(vf.U.data), _colT(vf.V.data)], dim=1)
        vf._tables["uv_colT"] = tbl
    return tbl


def weight_row(T, Z, width, ti, tau, zw):
    """(n, width) per-lane (t, z) blend weights over the flattened row.

    ``zw`` is a list of (zi, w) vertical taps (w None for weight 1); time
    blends as a hat around ``ti + tau``, or pins to ``ti`` when T == 1.
    """
    j = torch.arange(width, dtype=torch.int32, device=ti.device)[None, :]
    tj = torch.div(j, Z, rounding_mode="floor").to(torch.float32)
    zj = j % Z
    if T == 1:
        wt = (tj == 0.0).to(torch.float32)
    else:
        pt = torch.clamp(ti, 0, T - 2).to(torch.float32) + tau.to(torch.float32)
        wt = torch.clamp_min(1.0 - torch.abs(tj - pt[:, None]), 0.0)
    wz = None
    for zi, w in zw:
        ind = (zj == zi[:, None]).to(torch.float32)
        if w is not None:
            ind = ind * w[:, None]
        wz = ind if wz is None else wz + ind
    return wt * wz


def sample_col(table, rows_idx, wrow, lat_w=None):
    """One blended sample: a row read per tap and a weighted reduce.

    ``rows_idx`` is a list of per-lane row indices (1 for face data, 3 for
    node data); ``lat_w`` the matching lateral weights (None: weight 1).
    """
    val = None
    for k, idx in enumerate(rows_idx):
        v = torch.sum(table[idx.long()] * wrow, dim=1)
        if lat_w is not None:
            v = v * lat_w[k]
        val = v if val is None else val + v
    return val


def node_ids(field, gpos):
    """(n, 3) node ids of the lanes' faces: a fused-row read when the grid
    ships a face table, else the connectivity gather."""
    garrs = field.grid.garrs
    n_face = field.grid.spec.n_face
    fi = torch.clamp(gpos["FACE"]["index"], 0, n_face - 1)
    if "face_table" in garrs and enabled(n_face, field.data.device):
        return nids_from_rows(face_rows(garrs["face_table"], fi))
    return garrs["conn"][fi.long()]

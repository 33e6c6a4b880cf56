"""Unstructured-grid interpolators (torch).

Port of the JAX package's ``interpolators/uxinterp.py``: the four placement
combinations, {face, node} lateral x {zc centres, zf interfaces} vertical,
and the ``Ux_Velocity`` vector wrapper. Two sampling tiers share the math:

- gather tier: per-element gathers from the dense (T, Zdata, N) tensors;
- corner-column tier (``ops/uxcol.py``): the field transposed to (N, T*Z)
  rows, so one (t, z)-blended sample is one row read (face data) or three
  (node data, barycentric) and a weighted reduce over the row.

The vertical blend is a list of (zi, weight) taps: layer-centre
placements pin one tap, interface placements blend two with the
non-uniform depth weights.
"""

from __future__ import annotations

import torch

from parcels_tpu_torch.interpolators._base import ScalarInterpolator, VectorInterpolator

__all__ = [
    "UxConstantFaceConstantZC",
    "UxConstantFaceLinearZF",
    "UxLinearNodeConstantZC",
    "UxLinearNodeLinearZF",
    "Ux_Velocity",
]


def _tlevels(gpos, T):
    ti = torch.clamp(gpos["T"]["index"], 0, T - 1)
    tau = gpos["T"]["bcoord"]
    if T == 1:
        return ((ti, None),)
    return ((ti, 1 - tau), (torch.clamp(ti + 1, 0, T - 1), tau))


def _zw_zc(gpos, Zdata):
    """Single-tap vertical: piecewise constant at the layer centre."""
    return [(torch.clamp(gpos["Z"]["index"], 0, Zdata - 1), None)]


def _zw_zf(ppos, gpos, depth):
    """Two-tap vertical: linear between interface levels zi and zi+1."""
    nz = depth.shape[0]
    zi = torch.clamp(gpos["Z"]["index"], 0, nz - 2)
    zi1 = torch.clamp(zi + 1, 0, nz - 1)
    z = ppos["z"]
    zk = depth[zi.long()]
    zkp1 = depth[zi1.long()]
    denom = torch.where(zkp1 == zk, 1.0, zkp1 - zk)
    return [(zi, (zkp1 - z) / denom), (zi1, (z - zk) / denom)]


# ---------------------------------------------------------------------------
# gather tier
# ---------------------------------------------------------------------------


def _gather_zn(data, ti, zi, ni):
    """data[t, z, n] at per-particle (ti, zi, ni)."""
    return data[ti.long(), zi.long(), ni.long()]


def _face_sample(data, gpos, zi):
    fi = torch.clamp(gpos["FACE"]["index"], 0, data.shape[2] - 1)
    val = None
    for tl, wt in _tlevels(gpos, data.shape[0]):
        v = _gather_zn(data, tl, zi, fi)
        if wt is not None:
            v = v * wt
        val = v if val is None else val + v
    return val


def _node_sample(data, gpos, conn, zi):
    bc = gpos["FACE"]["bcoord"]  # (n, 3)
    fi = torch.clamp(gpos["FACE"]["index"], 0, conn.shape[0] - 1)
    nids = conn[fi.long()]  # (n, 3)
    val = None
    for tl, wt in _tlevels(gpos, data.shape[0]):
        v = (
            _gather_zn(data, tl, zi, nids[:, 0]) * bc[:, 0]
            + _gather_zn(data, tl, zi, nids[:, 1]) * bc[:, 1]
            + _gather_zn(data, tl, zi, nids[:, 2]) * bc[:, 2]
        )
        if wt is not None:
            v = v * wt
        val = v if val is None else val + v
    return val


# ---------------------------------------------------------------------------
# shared dispatch
# ---------------------------------------------------------------------------


def _col_on(field) -> bool:
    from parcels_tpu_torch.ops import uxcol

    return (uxcol.enabled(field.grid.spec.n_face, field.data.device)
            and uxcol.col_usable(field.data.shape))


def _sample(field, ppos, gpos, zw, node: bool):
    if _col_on(field):
        from parcels_tpu_torch.ops import uxcol

        T, Z, N = field.data.shape
        tbl = uxcol.ux_col_table(field)
        wrow = uxcol.weight_row(T, Z, tbl.shape[1], gpos["T"]["index"], gpos["T"]["bcoord"], zw)
        if node:
            nids = uxcol.node_ids(field, gpos)
            bc = gpos["FACE"]["bcoord"]
            return uxcol.sample_col(tbl, [nids[:, 0], nids[:, 1], nids[:, 2]], wrow,
                                    lat_w=[bc[:, 0], bc[:, 1], bc[:, 2]])
        fi = torch.clamp(gpos["FACE"]["index"], 0, N - 1)
        return uxcol.sample_col(tbl, [fi], wrow)

    conn = field.grid.garrs["conn"] if node else None
    val = None
    for zi, w in zw:
        if node:
            v = _node_sample(field.data, gpos, conn, zi)
        else:
            v = _face_sample(field.data, gpos, zi)
        if w is not None:
            v = v * w
        val = v if val is None else val + v
    return val


class UxConstantFaceConstantZC(ScalarInterpolator):
    """Piecewise constant: face-registered, layer-centre vertical."""

    def interp(self, ppos, gpos, field):
        return _sample(field, ppos, gpos, _zw_zc(gpos, field.data.shape[1]), node=False)


class UxConstantFaceLinearZF(ScalarInterpolator):
    """Face-registered laterally, linear between zf interfaces vertically."""

    def interp(self, ppos, gpos, field):
        depth = field.grid.garrs["depth"]
        return _sample(field, ppos, gpos, _zw_zf(ppos, gpos, depth), node=False)


class UxLinearNodeConstantZC(ScalarInterpolator):
    """Barycentric lateral (node-registered), layer-centre vertical."""

    def interp(self, ppos, gpos, field):
        return _sample(field, ppos, gpos, _zw_zc(gpos, field.data.shape[1]), node=True)


class UxLinearNodeLinearZF(ScalarInterpolator):
    """Barycentric lateral, linear between zf interfaces vertically."""

    def interp(self, ppos, gpos, field):
        depth = field.grid.garrs["depth"]
        return _sample(field, ppos, gpos, _zw_zf(ppos, gpos, depth), node=True)


class Ux_Velocity(VectorInterpolator):  # noqa: N801
    """Velocity on a UxGrid; spherical meshes convert m/s to deg/s."""

    def interp(self, ppos, gpos, vf):
        u = vf.U.interp_method.interp(ppos, gpos, vf.U)
        v = vf.V.interp_method.interp(ppos, gpos, vf.V)
        if vf.grid.spec.spherical:
            deg2m = vf.grid.spec.deg2m
            u = u / (deg2m * torch.cos(torch.deg2rad(ppos["y"])))
            v = v / deg2m
        if vf.W is not None:
            w = vf.W.interp_method.interp(ppos, gpos, vf.W)
        else:
            w = torch.zeros_like(u)
        return u, v, w

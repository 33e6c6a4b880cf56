"""Structured-grid A-grid interpolators (torch).

Port of the A-grid part of the JAX package's
``interpolators/xinterp.py``. ``_linear_sample`` dispatches, in the JAX
package's order, to K1 (``ops/interp_kernels``) for fields within the fold
budget, else to K2 (``ops/binned_sample``) over an engine-sorted batch,
else to the plain 16-corner gather ``_multilinear``. The dispatch depends on
shapes and options only, never on the device: on the CPU the kernels' plain
versions run the same branches.

Schemes in this slice: XLinear, XLinear_Velocity, XConstantField. The
C-grid and slip schemes belong to later slices.
"""

from __future__ import annotations

import torch

from parcels_tpu_torch.interpolators._base import ScalarInterpolator, VectorInterpolator

__all__ = ["XConstantField", "XLinear", "XLinear_Velocity"]


def _flat_gather(data4d, ti, zi, yi, xi):
    """data[ti, zi, yi, xi] per lane via one flat take (indices clamped)."""
    T, Z, Y, X = data4d.shape
    idx = ((ti.long() * Z + zi.long()) * Y + yi.long()) * X + xi.long()
    flat = data4d.reshape(-1)
    return flat[torch.clamp(idx, 0, flat.numel() - 1)]


def _axis_levels(idx, frac, size):
    """[(clipped_index, weight), ...] for one axis; 1 level if size == 1."""
    i0 = torch.clamp(idx, 0, size - 1)
    if size == 1:
        return [(i0, None)]
    return [(i0, 1.0 - frac), (torch.clamp(idx + 1, 0, size - 1), frac)]


def _multilinear(data, levels_t, levels_z, levels_y, levels_x):
    """Weighted sum over the outer product of per-axis (index, weight) levels."""
    val = None
    for ti, wt in levels_t:
        for zi, wz in levels_z:
            for yi, wy in levels_y:
                for xi, wx in levels_x:
                    v = _flat_gather(data, ti, zi, yi, xi)
                    for w in (wt, wz, wy, wx):
                        if w is not None:
                            v = v * w
                    val = v if val is None else val + v
    return val


def _positions(gpos):
    return tuple(gpos[ax][k] for ax in "TZYX" for k in ("index", "bcoord"))


def gather_sample(data, gpos):
    """The plain 16-corner gather path (reference XLinear)."""
    T, Z, Y, X = data.shape
    ti, tau, zi, zeta, yi, eta, xi, xsi = _positions(gpos)
    return _multilinear(
        data,
        _axis_levels(ti, tau, T),
        _axis_levels(zi, zeta, Z),
        _axis_levels(yi, eta, Y),
        _axis_levels(xi, xsi, X),
    )


def _linear_sample(data, gpos):
    """Multilinear hat sampling of ``data`` at ``gpos``: K1, K2 or gather."""
    from parcels_tpu_torch.ops.binned_sample import binned_enabled, binned_linear_sample
    from parcels_tpu_torch.ops.interp_kernels import (
        fits_fast_path,
        fold_sample,
        positions_from_gpos,
    )

    shape4 = tuple(data.shape)
    if fits_fast_path(shape4):
        return fold_sample(data, *positions_from_gpos(gpos, shape4))
    if binned_enabled(shape4, gpos):
        return binned_linear_sample(data, gpos)
    return gather_sample(data, gpos)


class XLinear(ScalarInterpolator):
    """Trilinear interpolation on a regular grid + linear time blend."""

    def interp(self, ppos, gpos, field):
        return _linear_sample(field.data, gpos)


class XConstantField(ScalarInterpolator):
    """Returns the single value of a constant (1,1,1,1) field."""

    def interp(self, ppos, gpos, field):
        return field.data[0, 0, 0, 0] * torch.ones_like(ppos["x"])


class XLinear_Velocity(VectorInterpolator):  # noqa: N801
    """Trilinear A-grid velocity; converts m/s to deg/s on spherical meshes."""

    def interp(self, ppos, gpos, vf):
        lin = XLinear()
        u = lin.interp(ppos, gpos, vf.U)
        v = lin.interp(ppos, gpos, vf.V)
        if vf.grid.spec.spherical:
            deg2m = vf.grid.spec.deg2m
            u = u / (deg2m * torch.cos(torch.deg2rad(ppos["y"])))
            v = v / deg2m
        w = lin.interp(ppos, gpos, vf.W) if vf.W is not None else torch.zeros_like(u)
        return u, v, w

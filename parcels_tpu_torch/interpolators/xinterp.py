"""Structured-grid interpolators (torch).

Port of the JAX package's ``interpolators/xinterp.py``. ``_linear_sample``
dispatches, in the JAX package's order, to K1 (``ops/interp_kernels``) for
fields within the fold budget, else to K2 (``ops/binned_sample``) over an
engine-sorted batch, else to the plain 16-corner gather ``_multilinear``.
The dispatch depends on shapes and options only, never on the device: on
the CPU the kernels' plain versions run the same branches.

Schemes: XLinear, XLinear_Velocity, XConstantField, and the Delandmeter &
van Sebille (2019) C-grid schemes CGrid_Velocity and CGrid_Tracer. The slip
and nearest schemes belong to a later slice.
"""

from __future__ import annotations

import math

import torch

from parcels_tpu_torch.interpolators._base import ScalarInterpolator, VectorInterpolator

__all__ = ["CGrid_Tracer", "CGrid_Velocity", "XConstantField", "XLinear", "XLinear_Velocity"]


def _flat_gather(data4d, ti, zi, yi, xi):
    """data[ti, zi, yi, xi] per lane via one flat take (indices clamped)."""
    T, Z, Y, X = data4d.shape
    idx = ((ti.long() * Z + zi.long()) * Y + yi.long()) * X + xi.long()
    flat = data4d.reshape(-1)
    return flat[torch.clamp(idx, 0, flat.numel() - 1)]


def _axis_levels(idx, frac, size, blend: bool = True):
    """[(clipped_index, weight), ...] for one axis; 1 level if size == 1 or not blend."""
    i0 = torch.clamp(idx, 0, size - 1)
    if size == 1 or not blend:
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


def gather_sample(data, gpos, blend=(True, True, True, True)):
    """The plain 16-corner gather path (reference XLinear); an axis that
    does not blend takes one level."""
    T, Z, Y, X = data.shape
    ti, tau, zi, zeta, yi, eta, xi, xsi = _positions(gpos)
    return _multilinear(
        data,
        _axis_levels(ti, tau, T, blend[0]),
        _axis_levels(zi, zeta, Z, blend[1]),
        _axis_levels(yi, eta, Y, blend[2]),
        _axis_levels(xi, xsi, X, blend[3]),
    )


def _linear_sample(data, gpos, blend=(True, True, True, True)):
    """Multilinear hat sampling of ``data`` at ``gpos``: K1, K2 or gather.

    ``gpos`` may be synthetic (the C-grid interpolator builds face-flux
    samples this way). ``blend`` marks which (T, Z, Y, X) axes interpolate:
    a False axis must have bcoord 0, and the plain gather then takes a
    single level; K1 and K2 give the same selection without it.
    """
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
    return gather_sample(data, gpos, blend)


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


# ---------------------------------------------------------------------------
# C-grid geometry helpers
# ---------------------------------------------------------------------------


def _cell_corner_coords(grid, yi, xi):
    """Quad corner lon/lat (4, n) for cells (yi, xi), antimeridian-unwrapped."""
    spec = grid.spec
    lon = grid.garrs["lon"]
    lat = grid.garrs["lat"]
    if lon.dim() == 1:
        nx = lon.shape[0]
        ny = lat.shape[0]
        x0 = torch.clamp(xi, 0, max(nx - 2, 0)).long()
        y0 = torch.clamp(yi, 0, max(ny - 2, 0)).long()
        x1 = torch.clamp(x0 + 1, 0, nx - 1)
        y1 = torch.clamp(y0 + 1, 0, ny - 1)
        px = torch.stack([lon[x0], lon[x1], lon[x1], lon[x0]])
        py = torch.stack([lat[y0], lat[y0], lat[y1], lat[y1]])
    else:
        ny, nx = lon.shape
        y0 = torch.clamp(yi, 0, ny - 2).long()
        x0 = torch.clamp(xi, 0, nx - 2).long()
        flat_lon = lon.reshape(-1)
        flat_lat = lat.reshape(-1)

        def g(arr, dy, dx):
            return arr[(y0 + dy) * nx + (x0 + dx)]

        px = torch.stack([g(flat_lon, 0, 0), g(flat_lon, 0, 1), g(flat_lon, 1, 1), g(flat_lon, 1, 0)])
        py = torch.stack([g(flat_lat, 0, 0), g(flat_lat, 0, 1), g(flat_lat, 1, 1), g(flat_lat, 1, 0)])

    if spec.spherical:
        # floor-mod like jnp's %: the result takes the divisor's sign
        px = torch.remainder(px + 180.0, 360.0) - 180.0
        shift = torch.where(px[1:] - px[0] > 180.0, px[1:] - 360.0, px[1:])
        shift = torch.where(-shift + px[0] > 180.0, shift + 360.0, shift)
        px = torch.cat([px[:1], shift], dim=0)
    return px, py


def _geodetic_distance(lat1, lat2, lon1, lon2, spherical: bool, lat, deg2m: float):
    if spherical:
        rad = math.pi / 180.0
        a = (lon2 - lon1) * deg2m * torch.cos(rad * lat)
        b = (lat2 - lat1) * deg2m
        return torch.sqrt(a * a + b * b)
    a = lon2 - lon1
    b = lat2 - lat1
    return torch.sqrt(a * a + b * b)


def _jacobian_determinant(py, px, eta, xsi):
    """det of the bilinear map at (xsi, eta); corners (4, n)."""
    dphidxsi = (eta - 1, 1 - eta, eta, -eta)
    dphideta = (xsi - 1, -xsi, xsi, 1 - xsi)
    dxdxsi = sum(w * px[k] for k, w in enumerate(dphidxsi))
    dxdeta = sum(w * px[k] for k, w in enumerate(dphideta))
    dydxsi = sum(w * py[k] for k, w in enumerate(dphidxsi))
    dydeta = sum(w * py[k] for k, w in enumerate(dphideta))
    return dxdxsi * dydeta - dxdeta * dydxsi


def cgrid_edge_lengths(spec, dlon10, dlon23, dlon30, dlon21, dlat10, dlat23, dlat30, dlat21,
                       py0, xsi, eta):
    """Edge lengths c1..c4 (south, east, north, west) from a geometry row,
    each at the particle's edge latitude (reference _xinterpolators.py)."""
    deg2m = spec.deg2m

    def edge_len(dlon, dlat, lat_edge):
        if spec.spherical:
            a = dlon * deg2m * torch.cos((math.pi / 180.0) * lat_edge)
            b = dlat * deg2m
            return torch.sqrt(a * a + b * b)
        return torch.sqrt(dlon * dlon + dlat * dlat)

    c1 = edge_len(dlon10, dlat10, py0 + xsi * dlat10)  # south: p0->p1
    c2 = edge_len(dlon21, dlat21, py0 + dlat10 + eta * dlat21)  # east: p1->p2
    c3 = edge_len(dlon23, dlat23, py0 + dlat30 + xsi * dlat23)  # north: p3->p2
    c4 = edge_len(dlon30, dlat30, py0 + eta * dlat30)  # west: p0->p3
    return c1, c2, c3, c4


def cgrid_velocity_from_fluxes(spec, Uvel, Vvel, dlon10, dlon23, dlon30, dlon21,
                               dlat10, dlat23, dlat30, dlat21, xsi, eta, y_deg):
    """The closed-form inverse bilinear map u = (U dx/dxsi + V dx/deta)/J,
    then m/s -> deg/s on a spherical mesh."""
    deg2m = spec.deg2m
    dxdxsi = (1.0 - eta) * dlon10 + eta * dlon23
    dxdeta = (1.0 - xsi) * dlon30 + xsi * dlon21
    dydxsi = (1.0 - eta) * dlat10 + eta * dlat23
    dydeta = (1.0 - xsi) * dlat30 + xsi * dlat21
    jac = dxdxsi * dydeta - dxdeta * dydxsi
    if spec.spherical:
        jac = jac * deg2m
    u = (Uvel * dxdxsi + Vvel * dxdeta) / jac
    v = (Uvel * dydxsi + Vvel * dydeta) / jac
    if spec.spherical:
        conversion = deg2m * torch.cos(torch.deg2rad(y_deg))
        u = u / conversion
        v = v / conversion
    return u, v


class CGrid_Velocity(VectorInterpolator):  # noqa: N801
    """C-grid velocity per Delandmeter & van Sebille (2019).

    Velocities are interpolated only normal to cell faces: face fluxes are
    scaled by geodesic edge lengths c1..c4 and blended linearly across the
    cell, then mapped through the cell's bilinear Jacobian
    (reference _xinterpolators.py:193-332).
    """

    def interp(self, ppos, gpos, vf):
        if "cgrid_geom" in vf.grid.garrs:
            return self._interp_geom_table(ppos, gpos, vf)
        return self._interp_corner_gather(ppos, gpos, vf)

    def _interp_geom_table(self, ppos, gpos, vf):
        """One row-gather of the memoized per-cell geometry
        (grid.cgrid_geometry) and face-flux samples through ``_linear_sample``
        with synthetic barycentric coordinates, so K1 and K2 sample C-grid
        velocities too."""
        grid = vf.grid
        spec = grid.spec
        T, Z, Y, X = vf.U.data.shape
        ti, tau, zi, zeta, yi, eta, xi, xsi = _positions(gpos)
        off_x, off_y, off_z = spec.offset_x, spec.offset_y, spec.offset_z

        cy, cx = max(spec.ydim, 1), max(spec.xdim, 1)
        cell = torch.clamp(yi, 0, cy - 1).long() * cx + torch.clamp(xi, 0, cx - 1).long()
        g = grid.garrs["cgrid_geom"][cell]  # (n, 9) row gather
        geo = [g[:, k] for k in range(9)]
        c1, c2, c3, c4 = cgrid_edge_lengths(spec, *geo, xsi, eta)

        def sample(comp, t_ix, z_ix, zb, y_ix, yb, x_ix, xb, blend):
            pseudo = {
                "T": {"index": t_ix, "bcoord": tau},
                "Z": {"index": z_ix, "bcoord": zb},
                "Y": {"index": y_ix, "bcoord": yb},
                "X": {"index": x_ix, "bcoord": xb},
                "_sorted": gpos.get("_sorted", False),
                "_z_occ": gpos.get("_z_occ"),
            }
            if "active" in gpos:
                pseudo["active"] = gpos["active"]
            return _linear_sample(comp.data, pseudo, blend)

        zero = torch.zeros_like(xsi)
        zi_c = torch.clamp(zi, 0, Z - 1)
        yi_o = torch.clamp(yi + off_y, 0, Y - 1)
        xi_o = torch.clamp(xi + off_x, 0, X - 1)

        # U face fluxes: Uvel = (1-xsi) c4 u_w + xsi c2 u_e, folded into ONE
        # hat sample: (a+b) * [(1-b/(a+b)) u_w + b/(a+b) u_e]
        au, bu = (1.0 - xsi) * c4, xsi * c2
        su = au + bu
        Uvel = su * sample(
            vf.U, ti, zi_c, zero, yi_o, zero,
            torch.clamp(xi, 0, max(X - 2, 0)), bu / torch.clamp_min(su, 1e-30),
            blend=(True, False, False, True),
        )
        av, bv = (1.0 - eta) * c1, eta * c3
        sv = av + bv
        Vvel = sv * sample(
            vf.V, ti, zi_c, zero, torch.clamp(yi, 0, max(Y - 2, 0)),
            bv / torch.clamp_min(sv, 1e-30), xi_o, zero,
            blend=(True, False, True, False),
        )
        u, v = cgrid_velocity_from_fluxes(spec, Uvel, Vvel, *geo[:8], xsi, eta, ppos["y"])

        if vf.W is not None:
            Zw = vf.W.data.shape[1]
            w = sample(
                vf.W, ti, torch.clamp(zi + off_z, 0, max(Zw - 2, 0)), zeta, yi_o, zero, xi_o,
                zero, blend=(True, True, False, False),
            )
        else:
            w = torch.zeros_like(u)
        return u, v, w

    def _interp_corner_gather(self, ppos, gpos, vf):
        """Corner coordinates gathered and geometry computed per sample, as
        the reference does (grids without the geometry table)."""
        grid = vf.grid
        spec = grid.spec
        U = vf.U.data
        V = vf.V.data
        T, Z, Y, X = U.shape
        ti, tau, zi, zeta, yi, eta, xi, xsi = _positions(gpos)
        off_x, off_y, off_z = spec.offset_x, spec.offset_y, spec.offset_z
        deg2m = spec.deg2m
        spherical = spec.spherical

        px, py = _cell_corner_coords(grid, yi, xi)

        lat_c1 = (1 - xsi) * py[0] + xsi * py[1]
        lat_c2 = (1 - eta) * py[1] + eta * py[2]
        lat_c3 = xsi * py[2] + (1 - xsi) * py[3]
        lat_c4 = (1 - eta) * py[0] + eta * py[3]
        c1 = _geodetic_distance(py[0], py[1], px[0], px[1], spherical, lat_c1, deg2m)
        c2 = _geodetic_distance(py[1], py[2], px[1], px[2], spherical, lat_c2, deg2m)
        c3 = _geodetic_distance(py[2], py[3], px[2], px[3], spherical, lat_c3, deg2m)
        c4 = _geodetic_distance(py[3], py[0], px[3], px[0], spherical, lat_c4, deg2m)

        t_levels = _axis_levels(ti, tau, T)
        zi_c = torch.clamp(zi, 0, Z - 1)

        def tblend(data, z_, y_, x_):
            val = None
            for tl, wt in t_levels:
                v = _flat_gather(data, tl, z_, y_, x_)
                if wt is not None:
                    v = v * wt
                val = v if val is None else val + v
            return val

        # U: the two corners are the west/east X faces
        yi_o = torch.clamp(yi + off_y, 0, Y - 1)
        u_w = tblend(U, zi_c, yi_o, torch.clamp(xi, 0, X - 1))
        u_e = tblend(U, zi_c, yi_o, torch.clamp(xi + 1, 0, X - 1))
        Uvel = (1 - xsi) * (u_w * c4) + xsi * (u_e * c2)

        # V: the two corners are the south/north Y faces
        xi_o = torch.clamp(xi + off_x, 0, X - 1)
        v_s = tblend(V, zi_c, torch.clamp(yi, 0, Y - 1), xi_o)
        v_n = tblend(V, zi_c, torch.clamp(yi + 1, 0, Y - 1), xi_o)
        Vvel = (1 - eta) * (v_s * c1) + eta * (v_n * c3)

        jac = _jacobian_determinant(py, px, eta, xsi)
        if spherical:
            jac = jac * deg2m

        wu0 = -(1 - eta) * Uvel - (1 - xsi) * Vvel
        wu1 = (1 - eta) * Uvel - xsi * Vvel
        wu2 = eta * Uvel + xsi * Vvel
        wu3 = -eta * Uvel + (1 - xsi) * Vvel
        u = (wu0 * px[0] + wu1 * px[1] + wu2 * px[2] + wu3 * px[3]) / jac
        v = (wu0 * py[0] + wu1 * py[1] + wu2 * py[2] + wu3 * py[3]) / jac

        if spherical:
            conversion = deg2m * torch.cos(torch.deg2rad(ppos["y"]))
            u = u / conversion
            v = v / conversion

        if vf.W is not None:
            Zw = vf.W.data.shape[1]
            w0 = tblend(vf.W.data, torch.clamp(zi + off_z, 0, Zw - 1), yi_o, xi_o)
            w1 = tblend(vf.W.data, torch.clamp(zi + off_z + 1, 0, Zw - 1), yi_o, xi_o)
            w = w0 * (1 - zeta) + w1 * zeta
        else:
            w = torch.zeros_like(u)
        return u, v, w


class CGrid_Tracer(ScalarInterpolator):  # noqa: N801
    """Piecewise-constant C-grid tracer (reference _xinterpolators.py:335-383)."""

    def interp(self, ppos, gpos, field):
        data = field.data
        T, Z, Y, X = data.shape
        spec = field.grid.spec
        ti, tau, zi, zeta, yi, eta, xi, xsi = _positions(gpos)
        zi_o = torch.clamp(zi + spec.offset_z, 0, Z - 1)
        yi_o = torch.clamp(yi + spec.offset_y, 0, Y - 1)
        xi_o = torch.clamp(xi + spec.offset_x, 0, X - 1)
        v0 = _flat_gather(data, torch.clamp(ti, 0, T - 1), zi_o, yi_o, xi_o)
        if T == 1:
            return v0
        v1 = _flat_gather(data, torch.clamp(ti + 1, 0, T - 1), zi_o, yi_o, xi_o)
        return v0 * (1 - tau) + v1 * tau


def _corner_stack(data, ti, tau, zi, yi, xi, blend_z: bool):
    """(nz, 2, 2, n) stack of time-blended corner values (nz = 1 or 2)."""
    T, Z, Y, X = data.shape
    t_levels = _axis_levels(ti, tau, T)

    def tblend(z_, y_, x_):
        val = None
        for tl, wt in t_levels:
            v = _flat_gather(data, tl, z_, y_, x_)
            if wt is not None:
                v = v * wt
            val = v if val is None else val + v
        return val

    z_list = [torch.clamp(zi, 0, Z - 1)]
    if blend_z and Z > 1:
        z_list.append(torch.clamp(zi + 1, 0, Z - 1))
    rows = []
    for z_ in z_list:
        r = []
        for dy in (0, 1):
            yy = torch.clamp(yi + dy, 0, Y - 1)
            r.append(torch.stack([tblend(z_, yy, torch.clamp(xi, 0, X - 1)),
                                  tblend(z_, yy, torch.clamp(xi + 1, 0, X - 1))]))
        rows.append(torch.stack(r))
    return torch.stack(rows)  # (nz, 2(y), 2(x), n)

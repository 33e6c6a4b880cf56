"""Analytical (Ariane/TRACMASS) advection, vectorized over the lanes (torch).

Port of the JAX package's ``kernels/analytical.py`` (reference
src/parcels/kernels/_advection.py:158-329, itself per-particle scalar
NumPy): the exponential-in-cell solution of Doos et al. (2017, GMD
10:1733). C-grid velocity only. Every branch of the reference's
compute_ds/compute_rs is a ``torch.where`` over the lanes, with safe
denominators, so ``log`` and ``exp`` of masked-out lanes never leak NaN.

Inside one cell the face-normal volume flux varies linearly between the
opposing faces, F(r) = F0 + (F1-F0) r, giving an exponential trajectory in
the cell's barycentric coordinate. The particle jumps to the cell boundary
it exits first (or to its position at the time-step end / next intermediate
time level), and ``particles.dt`` is set to the exact transit time, so the
engine's time loop does one cell per iteration; the engine then reverts dt
to the nominal value.
"""

from __future__ import annotations

import math

import torch

from parcels_tpu_torch._core.field import _get_positions
from parcels_tpu_torch.interpolators.xinterp import (
    _cell_corner_coords,
    _flat_gather,
    _geodetic_distance,
    _jacobian_determinant,
)

__all__ = ["AdvectionAnalytical"]

_TOL = 1e-10
#: face-boundary detection tolerance. The reference uses 1e-10 (f64 NumPy);
#: in f32 a particle landing on a cell face has |xsi-1| ~ 1e-7, so a f32-eps
#: aware margin is required or particles stick to faces forever.
_TOL_BUMP = 1e-5
_I_S = 10  # intermediate time levels per model timestep (reference :163)


def _compute_ds(F0, F1, r, direction):
    """Scaled time to exit the cell along one axis (reference :262-288), with
    the face it exits by (``r_target``: 1 the upper, 0 the lower)."""
    up = F0 * (1 - r) + F1 * r
    r_target = torch.where(direction * up >= 0.0, 1.0, 0.0)
    B = F0 - F1
    B = torch.where(torch.abs(B) < _TOL, 0.0, B)
    delta = -F0

    B_safe = torch.where(B == 0.0, 1.0, B)
    F_r1 = r_target + delta / B_safe
    F_r0 = r + delta / B_safe

    delta_safe = torch.where(torch.abs(delta) < _TOL, 1.0, delta)
    ratio = F_r1 / torch.where(F_r0 == 0.0, 1.0, F_r0)
    log_ratio = torch.log(torch.where(ratio > 0.0, ratio, 1.0))

    inf = math.inf
    ds = torch.where(
        (B == 0.0) & (torch.abs(delta) < _TOL),
        inf,
        torch.where(
            B == 0.0,
            -(r_target - r) / delta_safe,
            torch.where(F_r1 * F_r0 < _TOL, inf, -log_ratio / B_safe),
        ),
    )
    ds = torch.where(torch.abs(ds) < _TOL, inf, ds)
    return ds, B, delta, r_target


def _compute_rs(r, B, delta, s_min):
    """Barycentric coordinate after travelling for s_min (reference :301-305)."""
    B_safe = torch.where(torch.abs(B) < _TOL, 1.0, B)
    lin = -delta * s_min + r
    expo = (r + delta / B_safe) * torch.exp(-B * torch.clamp_max(s_min, 1e30)) - delta / B_safe
    return torch.where(torch.abs(B) < _TOL, lin, expo)


def _cross_stalled_faces(new, old, axes, face, s_min):
    """The jump's end ``new``, with a lane that stalls on a face moved one
    f32 step past where it stands.

    A deliberate difference from the JAX package. In f32 a lane whose exit
    face lies within one f32 step of its position ends its jump to the face
    where it stands (the exponential leaves it a fraction of a step short,
    and the position rounds back), and would repeat that jump, one engine
    iteration each, to the end of the run. For each axis the lane exits by
    (``ds == s_min``, a face and not a time limit) along which the jump
    makes no progress toward the exit face, each position coordinate that
    the cell's axis moves takes one f32 step outward (``nextafter``) from
    where the lane stands, and one more where that lands on the face itself
    (an axis-aligned face's coordinate): the search reads a lane on a face
    as r = 0 of the cell above it, and the scheme never leaves a lower face
    it sits on. ``axes`` holds, for
    each axis, its ``ds``, exit face (1 upper, 0 lower) and, for each
    coordinate, the axis's component and the lower and upper faces'
    coordinate (NaN where the face is not aligned with it). A lane whose
    jump makes progress keeps the JAX package's values bit for bit.
    """
    out, moved = dict(new), {c: torch.zeros_like(face) for c in new}
    for ds, exit_face, comps in axes:
        sign = torch.where(exit_face == 1.0, 1.0, -1.0)
        progress = sum((new[c] - old[c]) * e for c, (e, _, _) in comps.items())
        stall = face & (torch.abs(ds) == s_min) & (sign * progress <= 0.0)
        for c, (e, lower, upper) in comps.items():
            hit = stall & (e != 0.0)
            base = torch.where(moved[c], out[c], old[c])
            ahead = torch.where(sign * e > 0.0, math.inf, -math.inf).to(base.dtype)
            step = torch.nextafter(base, ahead)
            on_face = step == torch.where(exit_face == 1.0, upper, lower)
            step = torch.where(on_face, torch.nextafter(step, ahead), step)
            out[c] = torch.where(hit, step, out[c])
            moved[c] = moved[c] | hit
    return out


def AdvectionAnalytical(particles, fieldset):
    """Analytical advection (C-grid only; see module docstring)."""
    vf = fieldset.UV
    U, V = vf.U, vf.V
    grid = U.grid
    spec = grid.spec
    Udata, Vdata = U.data, V.data
    T, Z, Y, X = Udata.shape
    with_w = "W" in fieldset.fields and getattr(fieldset, "UVW", None) is not None
    Wdata = fieldset.UVW.W.data if with_w else None

    dt = particles.dt
    direction = torch.sign(dt)
    direction = torch.where(direction == 0, 1.0, direction)

    _, gpos = _get_positions(U, particles.t, particles.z, particles.y, particles.x, particles)
    ti, tau = gpos["T"]["index"], gpos["T"]["bcoord"]
    zi, zeta = gpos["Z"]["index"], gpos["Z"]["bcoord"]
    yi, eta = gpos["Y"]["index"], gpos["Y"]["bcoord"]
    xi, xsi = gpos["X"]["index"], gpos["X"]["bcoord"]
    yi = torch.clamp(yi, 0, max(spec.ydim - 1, 0))
    xi = torch.clamp(xi, 0, max(spec.xdim - 1, 0))
    zi = torch.clamp(zi, 0, max(spec.zdim - 1, 0))

    off_x, off_y, off_z = spec.offset_x, spec.offset_y, spec.offset_z

    # Face-boundary nudge (reference :183-200): a particle sitting exactly on
    # the east/north/upper face of its cell belongs to the next cell when the
    # flux there carries it onward.
    ti_c = torch.clamp(ti, 0, T - 1)
    u_face = _flat_gather(
        Udata, ti_c, torch.clamp(zi + off_z, 0, Z - 1), torch.clamp(yi + off_y, 0, Y - 1),
        torch.clamp(xi + 1, 0, X - 1),
    )
    bump_x = (torch.abs(xsi - 1.0) < _TOL_BUMP) & (u_face > 0) & (xi < spec.xdim - 1)
    xi = torch.where(bump_x, xi + 1, xi)
    xsi = torch.where(bump_x, 0.0, xsi)
    v_face = _flat_gather(
        Vdata, ti_c, torch.clamp(zi + off_z, 0, Z - 1), torch.clamp(yi + 1, 0, Y - 1),
        torch.clamp(xi + off_x, 0, X - 1),
    )
    bump_y = (torch.abs(eta - 1.0) < _TOL_BUMP) & (v_face > 0) & (yi < spec.ydim - 1)
    yi = torch.where(bump_y, yi + 1, yi)
    eta = torch.where(bump_y, 0.0, eta)
    if with_w:
        w_face = _flat_gather(
            Wdata, ti_c, torch.clamp(zi + 1, 0, Wdata.shape[1] - 1),
            torch.clamp(yi + off_y, 0, Y - 1), torch.clamp(xi + off_x, 0, X - 1),
        )
        bump_z = (torch.abs(zeta - 1.0) < _TOL_BUMP) & (w_face > 0) & (zi < spec.zdim - 1)
        zi = torch.where(bump_z, zi + 1, zi)
        zeta = torch.where(bump_z, 0.0, zeta)

    # Cell geometry (same conventions as CGrid_Velocity, xinterp.py).
    px, py = _cell_corner_coords(grid, yi, xi)
    spherical = spec.spherical
    deg2m = spec.deg2m
    lat_c1 = (1 - xsi) * py[0] + xsi * py[1]
    lat_c2 = (1 - eta) * py[1] + eta * py[2]
    lat_c3 = xsi * py[2] + (1 - xsi) * py[3]
    lat_c4 = (1 - eta) * py[0] + eta * py[3]
    c1 = _geodetic_distance(py[0], py[1], px[0], px[1], spherical, lat_c1, deg2m)
    c2 = _geodetic_distance(py[1], py[2], px[1], px[2], spherical, lat_c2, deg2m)
    c3 = _geodetic_distance(py[2], py[3], px[2], px[3], spherical, lat_c3, deg2m)
    c4 = _geodetic_distance(py[3], py[0], px[3], px[0], spherical, lat_c4, deg2m)

    if "Z" in spec.axes and with_w:
        depth = grid.garrs["depth"]
        nz = depth.shape[0]
        pz0 = depth[torch.clamp(zi, 0, nz - 1).long()]
        pz1 = depth[torch.clamp(zi + 1, 0, nz - 1).long()]
        dz = pz1 - pz0
    else:
        dz = 1.0

    rad = math.pi / 180.0
    mesh_jac = (deg2m * deg2m * torch.cos(rad * particles.y)) if spherical else 1.0
    dxdy = _jacobian_determinant(py, px, eta, xsi) * mesh_jac

    def tblend(data, z_, y_, x_):
        v0 = _flat_gather(data, ti_c, z_, y_, x_)
        if T == 1:
            return v0
        v1 = _flat_gather(data, torch.clamp(ti + 1, 0, T - 1), z_, y_, x_)
        return v0 * (1 - tau) + v1 * tau

    zi_o = torch.clamp(zi + off_z, 0, Z - 1)
    yi_o = torch.clamp(yi + off_y, 0, Y - 1)
    xi_o = torch.clamp(xi + off_x, 0, X - 1)
    U0 = direction * tblend(Udata, zi_o, yi_o, torch.clamp(xi, 0, X - 1)) * c4 * dz
    U1 = direction * tblend(Udata, zi_o, yi_o, torch.clamp(xi + 1, 0, X - 1)) * c2 * dz
    V0 = direction * tblend(Vdata, zi_o, torch.clamp(yi, 0, Y - 1), xi_o) * c1 * dz
    V1 = direction * tblend(Vdata, zi_o, torch.clamp(yi + 1, 0, Y - 1), xi_o) * c3 * dz

    ds_x, B_x, delta_x, out_x = _compute_ds(U0, U1, xsi, direction)
    ds_y, B_y, delta_y, out_y = _compute_ds(V0, V1, eta, direction)
    if with_w:
        Zw = Wdata.shape[1]
        W0 = direction * tblend(Wdata, torch.clamp(zi, 0, Zw - 1), yi_o, xi_o) * dxdy
        W1 = direction * tblend(Wdata, torch.clamp(zi + 1, 0, Zw - 1), yi_o, xi_o) * dxdy
        ds_z, B_z, delta_z, out_z = _compute_ds(W0, W1, zeta, direction)
    else:
        ds_z = torch.full_like(ds_x, math.inf)

    # Time limit: the full |dt|, or, for time-varying fields, the next of
    # I_s intermediate levels inside the current model timestep (reference
    # :177-181 limits each jump so the frozen-field approximation holds).
    ds_t = torch.abs(dt)
    if T > 1:
        tarr = grid.garrs["time"]
        tcell = tarr[torch.clamp(ti + 1, 0, T - 1).long()] - tarr[ti_c.long()]
        step = torch.clamp_min(tcell / (_I_S - 1), _TOL)
        elapsed = particles.t - tarr[ti_c.long()]
        k = torch.floor(elapsed / step + 1e-6) + 1.0
        to_boundary = torch.maximum(k * step - elapsed, step * 0.5)
        ds_t = torch.minimum(ds_t, to_boundary)

    vol = torch.clamp_min(torch.abs(dxdy * dz), _TOL)
    s_min = torch.minimum(
        torch.minimum(torch.abs(ds_x), torch.abs(ds_y)),
        torch.minimum(torch.abs(ds_z), torch.abs(ds_t / vol)),
    )

    rs_x = torch.clamp(_compute_rs(xsi, B_x, delta_x, s_min), 0.0, 1.0)
    rs_y = torch.clamp(_compute_rs(eta, B_y, delta_y, s_min), 0.0, 1.0)

    new_x = (
        (1.0 - rs_x) * (1.0 - rs_y) * px[0]
        + rs_x * (1.0 - rs_y) * px[1]
        + rs_x * rs_y * px[2]
        + (1.0 - rs_x) * rs_y * px[3]
    )
    new_y = (
        (1.0 - rs_x) * (1.0 - rs_y) * py[0]
        + rs_x * (1.0 - rs_y) * py[1]
        + rs_x * rs_y * py[2]
        + (1.0 - rs_x) * rs_y * py[3]
    )
    new = {"x": new_x, "y": new_y}
    old = {"x": particles.x, "y": particles.y}

    def aligned(p, i, j):
        """Coordinate ``p`` of the face through corners ``i`` and ``j``, or NaN."""
        return torch.where(p[i] == p[j], p[i], math.nan)

    # per axis: (ds, exit face, {coordinate: (axis component, lower face, upper face)})
    axes = [
        (ds_x, out_x, {"x": (px[1] + px[2] - px[0] - px[3], aligned(px, 0, 3), aligned(px, 1, 2)),
                       "y": (py[1] + py[2] - py[0] - py[3], aligned(py, 0, 3), aligned(py, 1, 2))}),
        (ds_y, out_y, {"x": (px[2] + px[3] - px[0] - px[1], aligned(px, 0, 1), aligned(px, 3, 2)),
                       "y": (py[2] + py[3] - py[0] - py[1], aligned(py, 0, 1), aligned(py, 3, 2))}),
    ]
    if with_w:
        rs_z = torch.clamp(_compute_rs(zeta, B_z, delta_z, s_min), 0.0, 1.0)
        new["z"] = (1.0 - rs_z) * pz0 + rs_z * pz1
        old["z"] = particles.z
        axes.append((ds_z, out_z, {"z": (pz1 - pz0, pz0, pz1)}))
    # the jump ends on a face, not at a time limit
    face = (s_min < torch.abs(ds_t / vol)) & torch.isfinite(s_min)
    new = _cross_stalled_faces(new, old, axes, face, s_min)
    particles.dx = particles.dx + (new["x"] - old["x"])
    particles.dy = particles.dy + (new["y"] - old["y"])
    if with_w:
        particles.dz = particles.dz + (new["z"] - old["z"])

    # Transit time becomes this step's dt (the engine adds it to t and then
    # resets dt to the nominal value, reference kernel.py:226-228).
    jump = direction * s_min * vol
    particles.dt = torch.where(
        dt > 0, torch.clamp_min(jump, 1e-7), torch.clamp_max(jump, -1e-7)
    ).to(particles.dt.dtype)

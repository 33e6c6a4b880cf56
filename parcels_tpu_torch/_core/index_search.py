"""Index search over whole particle batches (torch).

Port of the JAX package's ``_core/index_search.py``:

- 1-D bracketing (``search_1d``, ``search_time``) uses an O(1) analytic
  index when the axis is uniformly spaced (detected at ingest) and a
  searchsorted otherwise.
- Curvilinear 2-D search (``curvilinear_search``) is a warm-started
  point-in-cell check, a re-seed of the misses from a coarse lon/lat raster
  built once on the host, and a directed cell walk.

Out-of-bounds lanes carry the reference's sentinel codes (-1 right, -2
left, -3 search error) so the status-machine semantics carry over unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "GRID_SEARCH_ERROR",
    "LEFT_OUT_OF_BOUNDS",
    "PIC_TABLE_COLS",
    "RIGHT_OUT_OF_BOUNDS",
    "build_pic_table",
    "curvilinear_point_in_cell",
    "curvilinear_search",
    "pic_from_rows",
    "query_xyz",
    "search_1d",
    "search_time",
]

GRID_SEARCH_ERROR = -3
LEFT_OUT_OF_BOUNDS = -2
RIGHT_OUT_OF_BOUNDS = -1


def search_1d(
    arr: torch.Tensor,
    x: torch.Tensor,
    uniform: tuple[float, float, float] | None = None,
    oob_bounds: tuple[float, float] | None = None,
):
    """Bracket positions ``x`` in strictly-increasing 1-D ``arr``.

    Returns ``(index, bcoord)``: ``index`` is the int32 left bracket (or an
    OOB sentinel) and ``bcoord`` the barycentric coordinate.
    ``uniform=(origin, step, last)`` selects the O(1) path.
    """
    n = arr.shape[0]
    if n < 2:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device), torch.zeros_like(x)

    if uniform is not None:
        origin, step, last = uniform
        inv = 1.0 / step
        s = (x - origin) * inv
        fidx = torch.clamp(torch.floor(s), 0, n - 2)
        # a NaN position brackets cell 0 (its bcoord stays NaN), as XLA's
        # saturating float->int conversion does in the reference
        idx = torch.nan_to_num(fidx, nan=0.0).to(torch.int32)
        bcoord = s - fidx
        lo, hi = (origin, last) if oob_bounds is None else oob_bounds
        idx = torch.where(x < lo, LEFT_OUT_OF_BOUNDS, idx)
        idx = torch.where(x > hi, RIGHT_OUT_OF_BOUNDS, idx).to(torch.int32)
        return idx, bcoord

    if n <= 128:
        # count of nodes <= x, as the reference's broadcast compare does
        # (a NaN position counts 0 nodes and brackets cell 0)
        ins = (x[..., None] >= arr).sum(dim=-1).to(torch.int32)
    else:
        ins = torch.searchsorted(arr, x.contiguous(), right=True).to(torch.int32)
    idx = torch.clamp(ins - 1, 0, n - 2)
    left = arr[idx.long()]
    right = arr[idx.long() + 1]
    bcoord = (x - left) / (right - left)

    if oob_bounds is None:
        lo, hi = arr[0], arr[-1]
    else:
        lo, hi = oob_bounds
    idx = torch.where(x < lo, LEFT_OUT_OF_BOUNDS, idx)
    idx = torch.where(x > hi, RIGHT_OUT_OF_BOUNDS, idx).to(torch.int32)
    return idx, bcoord


def search_time(time_flt: torch.Tensor, t: torch.Tensor, uniform=None):
    """Bracket simulation times in the field's time axis (float seconds).

    Out-of-interval times are clamped to the first / last bracket and
    reported through a separate boolean (ErrorOutsideTimeInterval).
    """
    n = time_flt.shape[0]
    if n < 2:
        zi = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
        return zi, torch.zeros_like(t), torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    oob = (t < time_flt[0]) | (t > time_flt[-1])
    idx, bc = search_1d(time_flt, t, uniform)
    idx = torch.clamp(idx, 0, n - 2)
    bc = torch.clamp(bc, 0.0, 1.0)
    return idx, bc, oob


# ---------------------------------------------------------------------------
# Curvilinear 2-D search
# ---------------------------------------------------------------------------


def _to_index(f: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``clip(int32(f), lo, hi)`` with XLA's conversion: NaN -> 0 and
    out-of-range values saturate (a plain torch cast of NaN is undefined)."""
    return torch.nan_to_num(f, nan=0.0).clamp(lo, hi).to(torch.int32)


def _bilinear_inverse(px, py, xq, yq):
    """Solve the bilinear map for (xsi, eta) given quad corners (4, n) and queries (n,).

    As in the JAX package: the two roots come from the cancellation-free
    ``q`` formulation and the one inside (or nearest) [0, 1] is selected.
    """
    a0 = px[0]
    a1 = -px[0] + px[1]
    a2 = -px[0] + px[3]
    a3 = px[0] - px[1] + px[2] - px[3]
    b0 = py[0]
    b1 = -py[0] + py[1]
    b2 = -py[0] + py[3]
    b3 = py[0] - py[1] + py[2] - py[3]

    aa = a3 * b2 - a2 * b3
    bb = a3 * b0 - a0 * b3 + a1 * b2 - a2 * b1 + xq * b3 - yq * a3
    cc = a1 * b0 - a0 * b1 + xq * b1 - yq * a1
    det2 = bb * bb - 4 * aa * cc
    det = torch.sqrt(torch.clamp_min(det2, 0.0))

    sign_bb = torch.where(bb >= 0, 1.0, -1.0)
    q = -0.5 * (bb + sign_bb * det)
    r1 = q / torch.where(aa == 0.0, 1.0, aa)  # large root (noise if aa ~ 0)
    r2 = cc / torch.where(q == 0.0, 1.0, q)  # stable root; -cc/bb in the limit
    r1 = torch.where(aa == 0.0, r2, r1)
    r2 = torch.where(q == 0.0, 0.0, r2)

    def _dist01(r):
        return torch.clamp_min(torch.maximum(-r, r - 1.0), 0.0)

    eta = torch.where(_dist01(r2) <= _dist01(r1), r2, r1)
    eta = torch.where(det2 < 0.0, -1.0, eta)  # no real intersection: not in cell

    denom = a1 + a3 * eta
    fallback = ((yq - py[0]) / torch.where(py[1] == py[0], 1.0, py[1] - py[0])
                + (yq - py[3]) / torch.where(py[2] == py[3], 1.0, py[2] - py[3])) * 0.5
    degenerate = denom.abs() < 1e-12
    xsi = torch.where(
        degenerate, fallback, (xq - a0 - a2 * eta) / torch.where(degenerate, 1.0, denom)
    )
    return xsi, eta


def _latlon_to_xyz(lat_deg, lon_deg):
    lat = torch.deg2rad(lat_deg)
    lon = torch.deg2rad(lon_deg)
    cl = torch.cos(lat)
    return torch.cos(lon) * cl, torch.sin(lon) * cl, torch.sin(lat)


def _project_cell_and_query(clon, clat, x, y):
    """Project 4 cell corners (4, n) and the query onto the cell's tangent plane."""
    cX, cY, cZ = _latlon_to_xyz(clat, clon)
    qX, qY, qZ = _latlon_to_xyz(y, x)
    return _project_cell_and_query_xyz(cX, cY, cZ, qX, qY, qZ)


def _project_cell_and_query_xyz(cX, cY, cZ, qX, qY, qZ):
    """Tangent-plane projection from unit-sphere coordinates: basis from
    edge-midpoint difference vectors, Gram-Schmidt orthonormalized."""
    ux = (cX[1] + cX[2]) - (cX[0] + cX[3])
    uy = (cY[1] + cY[2]) - (cY[0] + cY[3])
    uz = (cZ[1] + cZ[2]) - (cZ[0] + cZ[3])
    un = torch.sqrt(ux * ux + uy * uy + uz * uz)
    un = torch.where(un == 0.0, 1.0, un)
    eux, euy, euz = ux / un, uy / un, uz / un

    vx = (cX[2] + cX[3]) - (cX[0] + cX[1])
    vy = (cY[2] + cY[3]) - (cY[0] + cY[1])
    vz = (cZ[2] + cZ[3]) - (cZ[0] + cZ[1])
    vd = vx * eux + vy * euy + vz * euz
    vx, vy, vz = vx - vd * eux, vy - vd * euy, vz - vd * euz
    vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    vn = torch.where(vn == 0.0, 1.0, vn)
    evx, evy, evz = vx / vn, vy / vn, vz / vn

    def proj(wx, wy, wz):
        return wx * eux + wy * euy + wz * euz, wx * evx + wy * evy + wz * evz

    pu, pv = proj(cX, cY, cZ)
    qu, qv = proj(qX, qY, qZ)
    return pu, pv, qu, qv


def _gather_cell_corners(lon2d, lat2d, yi, xi):
    """Gather the 4 corner coordinates of cells (yi, xi) -> two (4, n) tensors."""
    return _gather_corners_k((lon2d, lat2d), yi, xi)


def _gather_corners_k(arrays2d, yi, xi):
    """Gather 4 cell corners from each of k same-shaped 2-D tensors, in
    corner order p0=(y,x), p1=(y,x+1), p2=(y+1,x+1), p3=(y+1,x)."""
    ydim, xdim = arrays2d[0].shape
    yi0 = torch.clamp(yi, 0, ydim - 2).long()
    xi0 = torch.clamp(xi, 0, xdim - 2).long()
    flats = [a.reshape(-1) for a in arrays2d]
    idx = [(yi0 + dy) * xdim + (xi0 + dx) for dy, dx in ((0, 0), (0, 1), (1, 1), (1, 0))]
    return tuple(torch.stack([f[i] for i in idx]) for f in flats)


#: f32-aware acceptance margin in cell-fraction units: a point riding a cell
#: edge can compute as fractionally outside both neighbouring cells under f32
#: rounding; without the margin the walk oscillates between them (the JAX
#: package's value, measured there as an order above the f32 noise)
_PIC_TOL = 2e-4


def _tol_check(xsi, eta):
    return (
        (xsi >= -_PIC_TOL) & (xsi <= 1 + _PIC_TOL) & (eta >= -_PIC_TOL) & (eta <= 1 + _PIC_TOL)
    )


def curvilinear_point_in_cell(lon2d, lat2d, y, x, yi, xi, spherical: bool):
    """Bilinear-inverse point-in-cell for curvilinear cells; (in_cell, xsi, eta)."""
    return _make_point_in_cell(lon2d, lat2d, y, x, spherical)(yi, xi)


#: per-cell search-geometry table row (16 x f32), built on the host in f64:
#: cols 0-2 p0 in the embedding frame (unit-sphere XYZ, or (lon, lat, 0) on a
#: flat mesh), 3-5 the tangent u axis, 6-8 the v axis, 9-14 (pu, pv) of
#: corners 1..3 in that frame (corner 0 is the origin), 15 padding
PIC_TABLE_COLS = 16


def build_pic_table(lon2d, lat2d, spherical: bool):
    """Host-side (f64) per-cell tangent-frame table, (ny-1, nx-1, 16) f32."""
    lon = np.asarray(lon2d, dtype=np.float64)
    lat = np.asarray(lat2d, dtype=np.float64)
    if lon.ndim == 1:
        lon, lat = np.meshgrid(lon, lat)
    if spherical:
        latr, lonr = np.deg2rad(lat), np.deg2rad(lon)
        cl = np.cos(latr)
        gx, gy, gz = np.cos(lonr) * cl, np.sin(lonr) * cl, np.sin(latr)
    else:
        gx, gy, gz = lon, lat, np.zeros_like(lon)

    def corners(a):
        return np.stack([a[:-1, :-1], a[:-1, 1:], a[1:, 1:], a[1:, :-1]])

    cX, cY, cZ = corners(gx), corners(gy), corners(gz)
    ux = (cX[1] + cX[2]) - (cX[0] + cX[3])
    uy = (cY[1] + cY[2]) - (cY[0] + cY[3])
    uz = (cZ[1] + cZ[2]) - (cZ[0] + cZ[3])
    un = np.sqrt(ux * ux + uy * uy + uz * uz)
    un[un == 0.0] = 1.0
    eux, euy, euz = ux / un, uy / un, uz / un
    vx = (cX[2] + cX[3]) - (cX[0] + cX[1])
    vy = (cY[2] + cY[3]) - (cY[0] + cY[1])
    vz = (cZ[2] + cZ[3]) - (cZ[0] + cZ[1])
    vd = vx * eux + vy * euy + vz * euz
    vx, vy, vz = vx - vd * eux, vy - vd * euy, vz - vd * euz
    vn = np.sqrt(vx * vx + vy * vy + vz * vz)
    vn[vn == 0.0] = 1.0
    evx, evy, evz = vx / vn, vy / vn, vz / vn

    dX, dY, dZ = cX - cX[0], cY - cY[0], cZ - cZ[0]
    pu = dX * eux + dY * euy + dZ * euz  # (4, ny-1, nx-1); pu[0] == 0
    pv = dX * evx + dY * evy + dZ * evz

    ny1, nx1 = gx.shape[0] - 1, gx.shape[1] - 1
    tbl = np.zeros((ny1, nx1, PIC_TABLE_COLS), dtype=np.float32)
    tbl[..., 0], tbl[..., 1], tbl[..., 2] = cX[0], cY[0], cZ[0]
    tbl[..., 3], tbl[..., 4], tbl[..., 5] = eux, euy, euz
    tbl[..., 6], tbl[..., 7], tbl[..., 8] = evx, evy, evz
    for k in range(1, 4):
        tbl[..., 9 + 2 * (k - 1)] = pu[k]
        tbl[..., 10 + 2 * (k - 1)] = pv[k]
    return tbl


def query_xyz(y, x, spherical: bool):
    """Embedding-frame query coordinates (computed once per batch)."""
    if spherical:
        return _latlon_to_xyz(y, x)
    return x, y, torch.zeros_like(x)


def pic_from_rows(row, q):
    """Point-in-cell check against pre-gathered pic-table rows (n, >=16).

    ``q`` is ``query_xyz(y, x, spherical)``. Returns (in_cell, xsi, eta).
    """
    qX, qY, qZ = q
    dx = qX - row[:, 0]
    dy = qY - row[:, 1]
    dz = qZ - row[:, 2]
    qu = dx * row[:, 3] + dy * row[:, 4] + dz * row[:, 5]
    qv = dx * row[:, 6] + dy * row[:, 7] + dz * row[:, 8]
    pu = (torch.zeros_like(qu), row[:, 9], row[:, 11], row[:, 13])
    pv = (torch.zeros_like(qv), row[:, 10], row[:, 12], row[:, 14])
    xsi, eta = _bilinear_inverse(pu, pv, qu, qv)
    return _tol_check(xsi, eta), xsi, eta


def _make_point_in_cell_table(table_flat, ncols_x, y, x, spherical: bool):
    """Table-backed pic closure: one row-gather per lane per invocation."""
    q = query_xyz(y, x, spherical)

    def pic(yi, xi):
        row = table_flat[(yi * ncols_x + xi).long()]  # (n, cols)
        return pic_from_rows(row, q)

    return pic


def _make_point_in_cell(lon2d, lat2d, y, x, spherical: bool):
    """A ``pic(yi, xi) -> (in_cell, xsi, eta)`` closure for fixed queries,
    from the node coordinates (query and node XYZ computed once)."""
    if spherical:
        gX, gY, gZ = _latlon_to_xyz(lat2d, lon2d)
        qX, qY, qZ = _latlon_to_xyz(y, x)

        def pic(yi, xi):
            cX, cY, cZ = _gather_corners_k((gX, gY, gZ), yi, xi)
            pu, pv, qu, qv = _project_cell_and_query_xyz(cX, cY, cZ, qX, qY, qZ)
            xsi, eta = _bilinear_inverse(pu - pu[0], pv - pv[0], qu - pu[0], qv - pv[0])
            return _tol_check(xsi, eta), xsi, eta

    else:

        def pic(yi, xi):
            # invert in cell-local coordinates: at global coords ~1e5 m the
            # quadratic-formula terms cancel catastrophically in f32
            clon, clat = _gather_cell_corners(lon2d, lat2d, yi, xi)
            xsi, eta = _bilinear_inverse(
                clon - clon[0], clat - clat[0], x - clon[0], y - clat[0]
            )
            return _tol_check(xsi, eta), xsi, eta

    return pic


def curvilinear_search(
    lon2d, lat2d, y, x, yi_guess, xi_guess, *, spherical: bool, lookup: dict | None = None,
    n_walk: int = 12, pic_table=None,
):
    """Locate particles in a 2-D curvilinear grid (the JAX package's search).

    1. point-in-cell at the warm-start guess;
    2. misses re-seeded from the coarse lon/lat raster (host-built);
    3. up to ``n_walk`` directed cell-walk iterations while a lane that is
       neither found nor hopeless remains (one host read per iteration):
       each miss moves its cell index by the rounded, clamped overshoot.

    Returns (yi, eta, xi, xsi) with yi/xi = GRID_SEARCH_ERROR where the walk
    failed and RIGHT_OUT_OF_BOUNDS outside the grid's bounding raster.
    """
    ydim, xdim = lon2d.shape
    yi = torch.clamp(yi_guess, 0, ydim - 2).to(torch.int32)
    xi = torch.clamp(xi_guess, 0, xdim - 2).to(torch.int32)

    if pic_table is not None:
        # callers may pass the (cells, >=16) fused row table of the stage
        # cache, whose first 16 columns are the pic row
        cols = pic_table.shape[-1]
        pic = _make_point_in_cell_table(pic_table.reshape(-1, cols), xdim - 1, y, x, spherical)
    else:
        pic = _make_point_in_cell(lon2d, lat2d, y, x, spherical)
    in_cell, xsi, eta = pic(yi, xi)

    if lookup is not None:
        # Re-seed misses from the coarse raster. The JAX package skips this
        # under a batch-wide cond when every lane is in its cell; the where
        # keeps found lanes, so the unconditional re-seed gives the same
        # values without a host read.
        ly0, lx0 = lookup["origin"]
        lys, lxs = lookup["step"]
        tbl_y = lookup["yi"]  # (ny, nx) int32 seeds
        tbl_x = lookup["xi"]
        ny, nx = tbl_y.shape
        ry = _to_index(torch.floor((y - ly0) / lys), 0, ny - 1).long()
        rx = _to_index(torch.floor((x - lx0) / lxs), 0, nx - 1).long()
        yi = torch.where(in_cell, yi, torch.clamp(tbl_y[ry, rx], 0, ydim - 2)).to(torch.int32)
        xi = torch.where(in_cell, xi, torch.clamp(tbl_x[ry, rx], 0, xdim - 2)).to(torch.int32)
        if spherical:
            outside = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
        else:
            outside = (y < ly0) | (y > ly0 + lys * ny) | (x < lx0) | (x > lx0 + lxs * nx)
    else:
        outside = torch.zeros(y.shape, dtype=torch.bool, device=y.device)

    def _outside_dist(xsi_n, eta_n):
        """How far outside [0,1]^2 the local coords are, in cell fractions."""
        dx = torch.clamp_min(torch.maximum(-xsi_n, xsi_n - 1.0), 0.0)
        dy = torch.clamp_min(torch.maximum(-eta_n, eta_n - 1.0), 0.0)
        return torch.maximum(dx, dy)

    found = in_cell
    best = [torch.full_like(y, math.inf, dtype=torch.float32), torch.zeros_like(yi),
            torch.zeros_like(xi), torch.zeros_like(y, dtype=torch.float32),
            torch.zeros_like(y, dtype=torch.float32)]
    hopeless = outside | ~(torch.isfinite(y) & torch.isfinite(x))
    i = 0
    # the loop condition is the JAX package's: lanes outside the raster are
    # hopeless but keep walking while other lanes are unresolved, and one
    # that is found on the way is no longer reported out of bounds
    while i < n_walk and bool((~found & ~hopeless).any()):
        ok, xsi_n, eta_n = pic(yi, xi)
        # track the least-outside cell seen: a walk that oscillates on an
        # edge where f32 rounding rejects both neighbours is rescued below
        d_n = _outside_dist(xsi_n, eta_n)
        better = d_n < best[0]
        best = [torch.where(better, new, old)
                for new, old in zip((d_n, yi, xi, xsi_n, eta_n), best)]
        # directed move: floor gives 0 inside [0,1), 1 just above 1, -1 below 0
        dx = _to_index(torch.floor(xsi_n), -2, 2)
        dy = _to_index(torch.floor(eta_n), -2, 2)
        move = ~ok
        yi_new = torch.clamp(yi + torch.where(move, dy, 0), 0, ydim - 2).to(torch.int32)
        xi_new = torch.clamp(xi + torch.where(move, dx, 0), 0, xdim - 2).to(torch.int32)
        xsi = torch.where(ok & ~found, xsi_n, xsi)
        eta = torch.where(ok & ~found, eta_n, eta)
        found2 = found | ok
        # a not-found lane whose attempted move was fully clamped can never
        # make progress (its target cell is beyond the grid edge)
        stalled = ~found2 & ~found & (yi_new == yi) & (xi_new == xi)
        yi = torch.where(found, yi, yi_new)
        xi = torch.where(found, xi, xi_new)
        found = found2
        hopeless = hopeless | stalled
        i += 1

    # rescue oscillating edge lanes within 1% of a cell of the boundary;
    # raster-outside lanes must surface as out of bounds instead
    rescue = ~outside & ~found & (best[0] < 0.01)
    yi = torch.where(rescue, best[1], yi)
    xi = torch.where(rescue, best[2], xi)
    xsi = torch.where(rescue, best[3], xsi)
    eta = torch.where(rescue, best[4], eta)
    found = found | rescue

    yi = torch.where(found, yi, GRID_SEARCH_ERROR)
    xi = torch.where(found, xi, GRID_SEARCH_ERROR)
    yi = torch.where(outside & ~found, RIGHT_OUT_OF_BOUNDS, yi).to(torch.int32)
    xi = torch.where(outside & ~found, RIGHT_OUT_OF_BOUNDS, xi).to(torch.int32)
    return yi, eta, xi, xsi

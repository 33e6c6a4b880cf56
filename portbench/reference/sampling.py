"""Plain float64 samplers of the two grids the configurations run on.

Written from the semantics the program states (Parcels' A-grid linear
interpolation and its C-grid scheme of Delandmeter and van Sebille, 2019),
not from the program's code, and importing nothing of it. Every lane is a
row of a batch; nothing is cached across lanes. Each lane keeps the node
values of its current cell and time bracket and recomputes them only when
either changes, which is what makes a float64 run over hundreds of steps
cheap: it changes no value.

``dtype`` is the precision the velocity is sampled in: float64 for the
reference, bfloat16 for its control. The node (or face) values, the
interpolation weights and their blend are rounded to it, as a field stored
and interpolated in that type would be; positions, the search, the cell's
geometry and the conversion to degrees stay float64.
"""

from __future__ import annotations

import math

import torch

from reference import inputs

#: a point within this fraction of a cell outside it still counts as inside,
#: as the program's point-in-cell test takes it
PIC_TOL = 2e-4
WALK_MAX = 200
#: Newton steps of the bilinear inverse: the cells are near parallelograms,
#: so a handful reach float64 round-off
NEWTON_STEPS = 8
F64 = torch.float64


class NodeCache:
    """Per-lane node values of the lane's current (time bracket, cell)."""

    def __init__(self, n: int, width: int):
        self.key = torch.full((n,), -1, dtype=torch.int64)
        self.vals = torch.zeros((n, width), dtype=F64)

    def get(self, key, fill):
        stale = key != self.key
        if bool(stale.any()):
            idx = torch.nonzero(stale).flatten()
            self.vals[idx] = fill(idx)
            self.key[idx] = key[idx]
        return self.vals


def _time_bracket(t, t_step, nt):
    s = t / t_step
    ti = torch.clamp(torch.floor(s), 0, nt - 2)
    tau = torch.clamp(s - ti, 0.0, 1.0)
    return ti.to(torch.int64), tau


def _f32_round(v):
    return v.to(torch.float32).to(F64)


class AGridSampler:
    """Linear A-grid velocity on a regular longitude-latitude grid (one
    depth level), linear in time; out of bounds outside the node range."""

    def __init__(self, *, lon0, dlon, nx, lat0, dlat, ny, t_step, nt, t0_h, m, land=None,
                 dtype=F64):
        self.lon0, self.dlon, self.nx = lon0, dlon, nx
        self.lat0, self.dlat, self.ny = lat0, dlat, ny
        self.t_step, self.nt, self.t0_h = t_step, nt, t0_h
        self.m, self.dtype = m, dtype
        self.ocean = None if land is None else torch.as_tensor(~land)

    def start(self, n):
        return {"cache": NodeCache(n, 16)}

    def _nodes(self, ti, j, i):
        """(n, 16): U then V at corners (t0, t1) x (j, j+1) x (i, i+1)."""
        out = []
        for comp in (0, 1):
            for dt_ in (0, 1):
                for dj in (0, 1):
                    for di in (0, 1):
                        jj, ii = j + dj, i + di
                        lon = self.lon0 + ii.to(F64) * self.dlon
                        lat = self.lat0 + jj.to(F64) * self.dlat
                        th = self.t0_h + (ti + dt_).to(F64) * self.t_step / 3600.0
                        v = inputs.at_points(self.m, lon, lat, th)[comp]
                        v = _f32_round(v)
                        if self.ocean is not None:
                            v = v * self.ocean[jj, ii].to(F64)
                        out.append(v)
        return torch.stack(out, 1)

    def velocity(self, st, t, z, x, y):
        """(u, v) in degrees per second and the out-of-bounds flag (``z``:
        one level, unused)."""
        sx = (x - self.lon0) / self.dlon
        sy = (y - self.lat0) / self.dlat
        i = torch.clamp(torch.floor(sx), 0, self.nx - 2)
        j = torch.clamp(torch.floor(sy), 0, self.ny - 2)
        xsi, eta = sx - i, sy - j
        i, j = i.to(torch.int64), j.to(torch.int64)
        oob = ((x < self.lon0) | (x > self.lon0 + (self.nx - 1) * self.dlon)
               | (y < self.lat0) | (y > self.lat0 + (self.ny - 1) * self.dlat))
        ti, tau = _time_bracket(t, self.t_step, self.nt)
        key = (ti * self.ny + j) * self.nx + i
        vals = st["cache"].get(key, lambda idx: self._nodes(ti[idx], j[idx], i[idx]))
        d = self.dtype
        vals, xsi, eta, tau = vals.to(d), xsi.to(d), eta.to(d), tau.to(d)
        w = []
        for wt in (1 - tau, tau):
            for wy in (1 - eta, eta):
                for wx in (1 - xsi, xsi):
                    w.append(wt * wy * wx)
        w = torch.stack(w, 1)
        u = (vals[:, :8] * w).sum(1).to(F64)
        v = (vals[:, 8:] * w).sum(1).to(F64)
        u = u / (inputs.DEG2M * torch.cos(torch.deg2rad(y)))
        v = v / inputs.DEG2M
        zero = torch.zeros_like(u)
        return torch.where(oob, zero, u), torch.where(oob, zero, v), oob


#: the cell's edges as (from corner, to corner): south, north (west to
#: east), west, east (south to north)
EDGES = {"10": (0, 1), "23": (3, 2), "30": (0, 3), "21": (1, 2)}


def _xyz(lon, lat):
    lon, lat = torch.deg2rad(lon), torch.deg2rad(lat)
    c = torch.cos(lat)
    return torch.stack([torch.cos(lon) * c, torch.sin(lon) * c, torch.sin(lat)], -1)


class CGridSampler:
    """The C-grid velocity of a curvilinear (ORCA-like) spherical mesh.

    The point-in-cell test projects the cell's corners and the point onto
    the cell's tangent plane (axes along the mean of its i and j edges) and
    inverts the bilinear map there by Newton's method; a lane starts at the
    cell it was last found in and walks toward the point. Velocities are
    face values normal to the faces, scaled by the faces' lengths, blended
    across the cell and mapped through the cell's bilinear Jacobian in
    longitude and latitude. U and V take the depth level of the w-interval
    that holds the particle; the mesh's nodes are the f-points.
    """

    def __init__(self, *, nx, ny, depth_w, t_step, nt, m, fac, dtype=F64):
        self.nx, self.ny = nx, ny  # nodes
        self.lon1, self.lat1 = (torch.as_tensor(a) for a in inputs.orca_like_axes(nx, ny))
        self.dlat = float(self.lat1[1] - self.lat1[0])
        self.depth_w = torch.as_tensor(depth_w, dtype=F64)
        self.t_step, self.nt = t_step, nt
        self.m, self.fac = m, torch.as_tensor(fac)
        self.dtype = dtype

    def node(self, j, i):
        return inputs.orca_like_nodes(self.lon1[i], self.lat1[j], self.nx, self.dlat)

    def start(self, n):
        return {"cache": NodeCache(n, 8), "geo": NodeCache(n, 8),
                "j": None, "i": None}

    def first_guess(self, x, y):
        i = torch.round((x + 180.0) / 360.0 * self.nx)
        j = torch.round((y - float(self.lat1[0])) / self.dlat)
        return (torch.clamp(j, 0, self.ny - 2).to(torch.int64),
                torch.clamp(i, 0, self.nx - 2).to(torch.int64))

    def pic(self, j, i, x, y):
        """(xsi, eta) of the points in cells (j, i)."""
        corners = [self.node(j + dj, i + di) for dj, di in ((0, 0), (0, 1), (1, 1), (1, 0))]
        c = [_xyz(lo, la) for lo, la in corners]
        q = _xyz(x, y)
        eu = (c[1] + c[2]) - (c[0] + c[3])
        eu = eu / torch.linalg.vector_norm(eu, dim=-1, keepdim=True)
        ev = (c[2] + c[3]) - (c[0] + c[1])
        ev = ev - (ev * eu).sum(-1, keepdim=True) * eu
        ev = ev / torch.linalg.vector_norm(ev, dim=-1, keepdim=True)

        def proj(w):
            d = w - c[0]
            return (d * eu).sum(-1), (d * ev).sum(-1)

        p = [proj(ck) for ck in c]
        qu, qv = proj(q)
        xsi = torch.full_like(qu, 0.5)
        eta = torch.full_like(qu, 0.5)
        for _ in range(NEWTON_STEPS):
            a, b = 1 - xsi, 1 - eta
            fu = a * b * p[0][0] + xsi * b * p[1][0] + xsi * eta * p[2][0] + a * eta * p[3][0] - qu
            fv = a * b * p[0][1] + xsi * b * p[1][1] + xsi * eta * p[2][1] + a * eta * p[3][1] - qv
            du_x = b * (p[1][0] - p[0][0]) + eta * (p[2][0] - p[3][0])
            du_e = a * (p[3][0] - p[0][0]) + xsi * (p[2][0] - p[1][0])
            dv_x = b * (p[1][1] - p[0][1]) + eta * (p[2][1] - p[3][1])
            dv_e = a * (p[3][1] - p[0][1]) + xsi * (p[2][1] - p[1][1])
            det = du_x * dv_e - du_e * dv_x
            xsi = xsi - (fu * dv_e - fv * du_e) / det
            eta = eta - (fv * du_x - fu * dv_x) / det
        return xsi, eta

    def search(self, st, x, y):
        j, i = st["j"], st["i"]
        if j is None:
            j, i = self.first_guess(x, y)
        xsi, eta = self.pic(j, i, x, y)
        found = ((xsi >= -PIC_TOL) & (xsi <= 1 + PIC_TOL)
                 & (eta >= -PIC_TOL) & (eta <= 1 + PIC_TOL))
        for _ in range(WALK_MAX):
            if bool(found.all()):
                break
            idx = torch.nonzero(~found).flatten()
            dj = torch.clamp(torch.floor(eta[idx]), -2, 2).to(torch.int64)
            di = torch.clamp(torch.floor(xsi[idx]), -2, 2).to(torch.int64)
            j[idx] = torch.clamp(j[idx] + dj, 0, self.ny - 2)
            i[idx] = torch.clamp(i[idx] + di, 0, self.nx - 2)
            xs, es = self.pic(j[idx], i[idx], x[idx], y[idx])
            xsi[idx], eta[idx] = xs, es
            found[idx] = ((xs >= -PIC_TOL) & (xs <= 1 + PIC_TOL)
                          & (es >= -PIC_TOL) & (es <= 1 + PIC_TOL))
        st["j"], st["i"] = j, i
        return j, i, xsi, eta, ~found

    def _faces(self, ti, zi, j, i):
        """(n, 8): u_w, u_e, v_s, v_n at the two times of the bracket."""
        out = []
        for t_ in (ti, ti + 1):
            th = t_.to(F64) * self.t_step / 3600.0
            for comp, (dj, di) in ((0, (1, 0)), (0, (1, 1)), (1, (0, 1)), (1, (1, 1))):
                jj = torch.clamp(j + dj, 0, self.ny - 1)
                ii = torch.clamp(i + di, 0, self.nx - 1)
                v = inputs.at_points(self.m, self.lon1[ii], self.lat1[jj], th)[comp]
                v = (v.to(torch.float32) * self.fac[zi]).to(F64)
                out.append(v)
        return torch.stack(out, 1)

    def _geometry(self, j, i):
        """(n, 8): corner longitudes then latitudes, p0 (j, i), p1 (j, i+1),
        p2 (j+1, i+1), p3 (j+1, i), longitudes unwrapped around p0."""
        lon, lat = [], []
        for dj, di in ((0, 0), (0, 1), (1, 1), (1, 0)):
            lo, la = self.node(j + dj, i + di)
            lon.append(lo)
            lat.append(la)
        lon = [torch.remainder(lo + 180.0, 360.0) - 180.0 for lo in lon]
        lon = [lon[0]] + [lo - 360.0 * torch.round((lo - lon[0]) / 360.0) for lo in lon[1:]]
        return torch.stack(lon + lat, 1)

    def velocity(self, st, t, z, x, y):
        j, i, xsi, eta, lost = self.search(st, x, y)
        zi = torch.clamp(torch.searchsorted(self.depth_w, z, right=True) - 1, 0,
                         self.depth_w.numel() - 2)
        ti, tau = _time_bracket(t, self.t_step, self.nt)
        cell = j * self.nx + i
        key = (ti * self.depth_w.numel() + zi) * (self.ny * self.nx) + cell
        faces = st["cache"].get(key, lambda idx: self._faces(ti[idx], zi[idx], j[idx], i[idx]))
        geo = st["geo"].get(cell, lambda idx: self._geometry(j[idx], i[idx]))
        d = self.dtype
        # the cell's geometry as edge differences and its corners' latitudes
        px, py = geo[:, :4], geo[:, 4:]
        dx = {e: px[:, b] - px[:, a] for e, (a, b) in EDGES.items()}
        dy = {e: py[:, b] - py[:, a] for e, (a, b) in EDGES.items()}
        # the face values, their blend in time and across the cell in the
        # sampling precision
        fl, xl, el, tl = (a.to(d) for a in (faces, xsi, eta, tau))
        f = fl[:, :4] * (1 - tl)[:, None] + fl[:, 4:] * tl[:, None]
        u_w, u_e, v_s, v_n = f.unbind(1)
        a_w, a_e = ((1 - xl) * u_w).to(F64), (xl * u_e).to(F64)
        a_s, a_n = ((1 - el) * v_s).to(F64), (el * v_n).to(F64)
        D = inputs.DEG2M

        def edge(e, lat_edge):
            a = dx[e] * D * torch.cos(lat_edge * (math.pi / 180.0))
            return torch.sqrt(a * a + (dy[e] * D) ** 2)

        c1 = edge("10", py[:, 0] + xsi * dy["10"])  # south
        c2 = edge("21", py[:, 1] + eta * dy["21"])  # east
        c3 = edge("23", py[:, 3] + xsi * dy["23"])  # north
        c4 = edge("30", py[:, 0] + eta * dy["30"])  # west
        Uvel = c4 * a_w + c2 * a_e
        Vvel = c1 * a_s + c3 * a_n
        dxdxsi = (1 - eta) * dx["10"] + eta * dx["23"]
        dxdeta = (1 - xsi) * dx["30"] + xsi * dx["21"]
        dydxsi = (1 - eta) * dy["10"] + eta * dy["23"]
        dydeta = (1 - xsi) * dy["30"] + xsi * dy["21"]
        jac = (dxdxsi * dydeta - dxdeta * dydxsi) * D
        conv = D * torch.cos(torch.deg2rad(y))
        u = (Uvel * dxdxsi + Vvel * dxdeta) / jac / conv
        v = (Uvel * dydxsi + Vvel * dydeta) / jac / conv
        return u, v, lost


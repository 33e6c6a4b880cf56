"""K3: the fused C-grid RK4 hit step and its compacted exact repair.

Port of the JAX package's fused-step path (``scripts/bench_fused_rk4.py``).
Per step:

1. ONE kernel (``fused_rk4_step``, ``csrc/fused_rk4.cu``) advances every lane
   through the complete spherical RK4 step from its resident cell row and
   face-value quads, and flags the lanes where any stage left the cached
   cell (or whose row is invalid).
2. The first ``kcap`` flagged lanes are compacted on the device and re-run
   through the stage cache's exact search + gather + blend
   (``stagecache._full`` / ``_blend``); their positions, rows and quads are
   scattered back.

Like the JAX path this is a stepper of its own: ``ParticleSet.execute``
keeps the engine's stage-cache path and does not call it. It carries the
JAX path's assumptions, a 2-level time axis (``ti = 0``, ``t1i = 1``) and a
2-D spherical C-grid field sampled at the surface level (``zc = 0``), and
checks them.

``fused_rk4_step`` launches the kernel for tensors on the card and uses its
plain PyTorch version, ``fused_rk4_step_plain``, only for tensors on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from parcels_tpu_torch._core import index_search
from parcels_tpu_torch.ops import stagecache

__all__ = ["FusedRK4Stepper", "fused_rk4_step", "fused_rk4_step_plain"]

_PIC_TOL = 2e-4
_RAD = float(np.float32(math.pi / 180.0))
#: planes of the resident layouts: cell rows (pic 0-14 and the table's zero
#: pad column 15, geometry 16-24, valid 25, padding 26-31), face values [u_w, u_e] x 2 times + [v_s, v_n] x 2
#: times, state [x, y, t, dt, miss, 0, 0, 0]
ROW_PLANES, UV_PLANES, STATE_PLANES = 32, 8, 8
#: the repair round holds max(n // KCAP_DIV, KCAP_MIN) lanes, as in the JAX path
KCAP_DIV, KCAP_MIN = 64, 8192


def _stage_plain(r, uv, x, y, tstage, deg2m, inv_t1):
    """One RK stage in the kernel's operation order: (u, v) in deg/s, hit."""
    lat = y * _RAD
    lon = x * _RAD
    cl = torch.cos(lat)
    qX = torch.cos(lon) * cl
    qY = torch.sin(lon) * cl
    qZ = torch.sin(lat)
    dxq = qX - r[0]
    dyq = qY - r[1]
    dzq = qZ - r[2]
    qu = dxq * r[3] + dyq * r[4] + dzq * r[5]
    qv = dxq * r[6] + dyq * r[7] + dzq * r[8]
    # bilinear inverse (index_search._bilinear_inverse with p0 = 0)
    a1, a2, a3 = r[9], r[13], r[11] - r[9] - r[13]
    b1, b2, b3 = r[10], r[14], r[12] - r[10] - r[14]
    aa = a3 * b2 - a2 * b3
    bb = a1 * b2 - a2 * b1 + qu * b3 - qv * a3
    cc = qu * b1 - qv * a1
    det2 = bb * bb - 4 * aa * cc
    det = torch.sqrt(torch.clamp_min(det2, 0.0))
    sign_bb = torch.where(bb >= 0, 1.0, -1.0)
    q = -0.5 * (bb + sign_bb * det)
    r1 = q / torch.where(aa == 0.0, 1.0, aa)
    r2 = cc / torch.where(q == 0.0, 1.0, q)
    r1 = torch.where(aa == 0.0, r2, r1)
    r2 = torch.where(q == 0.0, 0.0, r2)

    def dist01(v):
        return torch.clamp_min(torch.maximum(-v, v - 1.0), 0.0)

    eta = torch.where(dist01(r2) <= dist01(r1), r2, r1)
    eta = torch.where(det2 < 0.0, -1.0, eta)
    denom = a1 + a3 * eta
    fallback = (qv / torch.where(b1 == 0.0, 1.0, b1)
                + (qv - b2) / torch.where(r[12] == r[14], 1.0, r[12] - r[14])) * 0.5
    degen = denom.abs() < 1e-12
    xsi = torch.where(degen, fallback, (qu - a2 * eta) / torch.where(degen, 1.0, denom))
    hit = (xsi >= -_PIC_TOL) & (xsi <= 1 + _PIC_TOL) & (eta >= -_PIC_TOL) & (eta <= 1 + _PIC_TOL)

    # C-grid blend (stagecache._blend, spherical)
    dlon10, dlon23, dlon30, dlon21 = r[16], r[17], r[18], r[19]
    dlat10, dlat23, dlat30, dlat21 = r[20], r[21], r[22], r[23]
    py0 = r[24]

    def edge_len(dlon, dlat, lat_edge):
        a = dlon * deg2m * torch.cos(_RAD * lat_edge)
        b = dlat * deg2m
        return torch.sqrt(a * a + b * b)

    c1 = edge_len(dlon10, dlat10, py0 + xsi * dlat10)
    c2 = edge_len(dlon21, dlat21, py0 + dlat10 + eta * dlat21)
    c3 = edge_len(dlon23, dlat23, py0 + dlat30 + xsi * dlat23)
    c4 = edge_len(dlon30, dlat30, py0 + eta * dlat30)
    tau = torch.clamp(tstage * inv_t1, 0.0, 1.0)
    u_w = uv[0] * (1.0 - tau) + uv[1] * tau
    u_e = uv[2] * (1.0 - tau) + uv[3] * tau
    v_s = uv[4] * (1.0 - tau) + uv[5] * tau
    v_n = uv[6] * (1.0 - tau) + uv[7] * tau
    Uvel = (1.0 - xsi) * c4 * u_w + xsi * c2 * u_e
    Vvel = (1.0 - eta) * c1 * v_s + eta * c3 * v_n
    dxdxsi = (1.0 - eta) * dlon10 + eta * dlon23
    dxdeta = (1.0 - xsi) * dlon30 + xsi * dlon21
    dydxsi = (1.0 - eta) * dlat10 + eta * dlat23
    dydeta = (1.0 - xsi) * dlat30 + xsi * dlat21
    jac = (dxdxsi * dydeta - dxdeta * dydxsi) * deg2m
    jac = torch.where(jac == 0.0, 1.0, jac)
    u = (Uvel * dxdxsi + Vvel * dxdeta) / jac
    v = (Uvel * dydxsi + Vvel * dydeta) / jac
    conv = deg2m * torch.cos(_RAD * y)
    return u / conv, v / conv, hit


def _f32(v) -> float:
    return float(np.float32(v))


def fused_rk4_step_plain(rowsT, uvT, state, deg2m, inv_t1, dt):
    """Plain PyTorch version of K3, operation for operation.

    Divisions are tensor by tensor: a division by a Python scalar may run as
    a multiplication by its reciprocal on the card, which rounds otherwise.
    """
    deg2m, inv_t1, dt = _f32(deg2m), _f32(inv_t1), _f32(dt)
    x, y, t = state[0], state[1], state[2]
    valid = rowsT[25] > 0.5
    hdt = 0.5 * dt
    u1, v1, h1 = _stage_plain(rowsT, uvT, x, y, t, deg2m, inv_t1)
    u2, v2, h2 = _stage_plain(rowsT, uvT, x + hdt * u1, y + hdt * v1, t + hdt, deg2m, inv_t1)
    u3, v3, h3 = _stage_plain(rowsT, uvT, x + hdt * u2, y + hdt * v2, t + hdt, deg2m, inv_t1)
    u4, v4, h4 = _stage_plain(rowsT, uvT, x + dt * u3, y + dt * v3, t + dt, deg2m, inv_t1)
    six = torch.full_like(x, 6.0)
    xn = x + (u1 + 2 * u2 + 2 * u3 + u4) / six * dt
    yn = y + (v1 + 2 * v2 + 2 * v3 + v4) / six * dt
    miss = torch.where(valid & h1 & h2 & h3 & h4, 0.0, 1.0)
    zero = torch.zeros_like(xn)
    return torch.stack([xn, yn, t + dt, state[3], miss, zero, zero, zero])


def _check(name, t, planes, n, device):
    if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 tensor on {device}")
    if tuple(t.shape) != (planes, n):
        raise ValueError(f"{name}: expected shape {(planes, n)}, got {tuple(t.shape)}")


def fused_rk4_step(rowsT, uvT, state, deg2m, inv_t1, dt):
    """One fused RK4 step of every lane: (8, n) [x', y', t + dt, dt, miss, 0, 0, 0].

    ``rowsT`` (32, n), ``uvT`` (8, n) and ``state`` (8, n) are f32 planes.
    On a CUDA tensor this launches K3 (``fused_rk4_step.launches`` counts
    the launches); on a CPU tensor it runs the plain version.
    """
    if rowsT.device.type == "cpu":
        return fused_rk4_step_plain(rowsT, uvT, state, deg2m, inv_t1, dt)
    if rowsT.device.type != "cuda":
        raise ValueError(f"fused_rk4_step: expected CUDA or CPU tensors, got {rowsT.device}")
    n = rowsT.shape[1]
    for name, t, planes in (("rowsT", rowsT, ROW_PLANES), ("uvT", uvT, UV_PLANES),
                            ("state", state, STATE_PLANES)):
        _check(name, t, planes, n, rowsT.device)
    out = torch.empty((STATE_PLANES, n), dtype=torch.float32, device=rowsT.device)
    if n == 0:
        return out
    from parcels_tpu_torch.ops._build import load

    launch = load("fused_rk4")
    err = launch(
        rowsT.data_ptr(), uvT.data_ptr(), state.data_ptr(), out.data_ptr(), n,
        _f32(deg2m), _f32(inv_t1), _f32(dt),
        torch.cuda.current_stream(rowsT.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_rk4 kernel launch failed with cudaError {err}")
    fused_rk4_step.launches += 1
    return out


fused_rk4_step.launches = 0


class FusedRK4Stepper:
    """The fused hit step plus one compacted exact repair round per step.

    Built from the SoA after one engine step (``warm``: a ParticleSet's
    ``_data`` whose stage-cache columns ``_sc_key``/``_sc_u4``/``_sc_v4`` the
    engine filled) on ``fieldset``, for a fixed ``dt``. Each ``one_step``
    launches K3 on every lane, then (with ``repair``) re-runs the first
    ``kcap`` missed lanes through the exact path. Raises on a fieldset or
    batch outside the path's assumptions, and when ``state`` is read after a
    step had more misses than the repair round holds.
    """

    def __init__(self, fieldset, warm: dict, dt: float, repair: bool = True):
        from parcels_tpu_torch.interpolators.xinterp import CGrid_Velocity

        vf_host = fieldset.UV
        spec = vf_host.grid.spec
        if not (isinstance(vf_host.interp_method, CGrid_Velocity) and spec.curvilinear
                and spec.spherical):
            raise ValueError("FusedRK4Stepper needs a curvilinear spherical C-grid UV field")
        if vf_host.U.data.shape[0] != 2:
            raise ValueError("FusedRK4Stepper needs a 2-level time axis (ti = 0, t1i = 1)")
        if stagecache.SC_KEY not in warm:
            raise ValueError("warm SoA has no stage-cache columns: run one engine step "
                             "with the stage cache on first")
        key = warm[stagecache.SC_KEY]
        live = warm["_active"] & (key[:, 0] >= 0)
        if bool(((key[:, 1] != 0) | (key[:, 2] != 0))[live].any()):
            raise ValueError("FusedRK4Stepper needs every cached lane at ti = 0 and zc = 0")

        farrays = fieldset.device_arrays()
        self.vf = fieldset.build_views(farrays).UV
        self.spec = spec
        self.cell_tbl = stagecache.cell_table(self.vf)
        self.deg2m = _f32(spec.deg2m)
        t1 = float(farrays["grids"][vf_host.igrid]["time"][1])
        self.inv_t1 = _f32(1.0 / t1)
        self.dt = _f32(dt)
        self.repair = repair
        self.n = n = key.shape[0]
        self.kcap = max(n // KCAP_DIV, KCAP_MIN)
        # the most misses any repaired step had, kept on the device (audit())
        self._max_miss = torch.zeros((), dtype=torch.int64, device=key.device)
        # each lane's cached cell (-1 invalid): the repair's warm start
        self.cell = key[:, 0].clone()
        self.rowsT, self.uvT, self._state = self.build_resident(warm)
        # every lane of the batch shares one clock; the host keeps it in f32
        self.t = np.float32(float(warm["t"][warm["_active"]][0]))

    def _rows_planes(self, cell):
        """(32, k) row planes of cells ``cell`` (-1 = invalid)."""
        k = cell.shape[0]
        rows = stagecache._rows(self.vf, cell)
        return torch.cat([
            rows.t(),
            (cell >= 0).to(torch.float32)[None],
            torch.zeros((ROW_PLANES - stagecache.ROW_COLS - 1, k), dtype=torch.float32,
                        device=cell.device),
        ]).contiguous()

    def build_resident(self, warm):
        """Resident (rowsT, uvT, state) planes from the warm SoA."""
        cell = warm[stagecache.SC_KEY][:, 0]
        rowsT = self._rows_planes(cell)
        uvT = torch.cat([warm["_sc_u4"].t(), warm["_sc_v4"].t()]).contiguous()
        zero = torch.zeros_like(warm["x"])
        state = torch.stack([warm["x"], warm["y"], warm["t"], warm["dt"].to(torch.float32),
                             zero, zero, zero, zero]).contiguous()
        return rowsT, uvT, state

    def round_idx(self, missrow):
        """Device-side compaction of the first ``kcap`` miss lanes; pads are n."""
        cum = torch.cumsum((missrow > 0.5).to(torch.int32), 0, dtype=torch.int32)
        targets = torch.arange(1, self.kcap + 1, dtype=torch.int32, device=missrow.device)
        idx = torch.searchsorted(cum, targets)
        return torch.clamp_max(idx, self.n).to(torch.int64)

    def gather_sub(self, state, idx):
        """What the repair reads of the compacted lanes; pad lanes (idx == n)
        read lane n - 1 and are inactive."""
        g = torch.clamp_max(idx, self.n - 1)
        return {"x": state[0, g], "y": state[1, g], "dt": state[3, g], "cell": self.cell[g],
                "_active": idx < self.n}

    def repair_rk4(self, sub, t0):
        """Exact RK4 of the compacted lanes: 4 stages, each a warm-started
        curvilinear search + C-grid quad gather + blend (stagecache._full /
        _blend). Returns new positions and the stage-4 cache.

        Stage 1 warm-starts from the lane's cached cell, as the engine's miss
        rounds do. (The JAX path starts it from the warm batch's element
        index; a lane on the +-2e-4 strip where two cells both accept it
        then picks the other cell than the engine and diverges from it.)
        """
        vf, spec = self.vf, self.spec
        x0, y0 = sub["x"], sub["y"]
        K = x0.shape[0]
        dev = x0.device
        ti = torch.zeros(K, dtype=torch.int32, device=dev)
        t1i = torch.ones(K, dtype=torch.int32, device=dev)
        zc = torch.zeros(K, dtype=torch.int32, device=dev)
        zeta = torch.zeros(K, dtype=torch.float32, device=dev)
        cy, cx = max(spec.ydim, 1), max(spec.xdim, 1)
        cell = torch.clamp_min(sub["cell"], 0)
        yi_g = torch.div(cell, cx, rounding_mode="floor") % cy
        xi_g = cell % cx

        def sample(xs, ys, ts, yi_w, xi_w):
            c = stagecache._full(vf, ys, xs, ti, t1i, zc, zc, yi_w, xi_w)
            q = index_search.query_xyz(ys, xs, spec.spherical)
            _, xsi, eta = index_search.pic_from_rows(c["row"], q)
            tau = torch.clamp(ts * self.inv_t1, 0.0, 1.0)
            u, v, _ = stagecache._blend(spec, c["row"], xsi, eta, tau, zeta, c["u4"], c["v4"],
                                        None, 1, ys)
            return u, v, c

        dt = self.dt
        t0s = torch.full((K,), t0, dtype=torch.float32, device=dev)
        u1, v1, c1 = sample(x0, y0, t0s, yi_g, xi_g)
        u2, v2, c2 = sample(x0 + 0.5 * dt * u1, y0 + 0.5 * dt * v1, t0s + 0.5 * dt,
                            c1["yi"], c1["xi"])
        u3, v3, c3 = sample(x0 + 0.5 * dt * u2, y0 + 0.5 * dt * v2, t0s + 0.5 * dt,
                            c2["yi"], c2["xi"])
        u4, v4, c4 = sample(x0 + dt * u3, y0 + dt * v3, t0s + dt, c3["yi"], c3["xi"])
        xn = x0 + (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dt
        yn = y0 + (v1 + 2 * v2 + 2 * v3 + v4) / 6.0 * dt
        return {"x": xn, "y": yn, "t": t0s + dt, "dt": sub["dt"],
                "cell": c4["cell"], "u4": c4["u4"], "v4": c4["v4"]}

    def scatter_sub(self, out, rowsT, uvT, idx, sub_out):
        """Write the repaired lanes back into the planes, in place. Pad lanes
        (idx == n) are filtered out: torch has no dropping scatter, and a
        clamped pad would race a real lane's write."""
        keep = idx < self.n
        il = idx[keep]
        k = il.shape[0]
        z = torch.zeros(k, dtype=torch.float32, device=il.device)
        upd = torch.stack([sub_out["x"][keep], sub_out["y"][keep], sub_out["t"][keep],
                           sub_out["dt"][keep], z, z, z, z])
        out[:, il] = upd
        self.cell[il] = sub_out["cell"][keep]
        rowsT[:, il] = self._rows_planes(sub_out["cell"][keep])
        uvT[:, il] = torch.cat([sub_out["u4"][keep].t(), sub_out["v4"][keep].t()])
        return out, rowsT, uvT

    def audit(self):
        """Raise if a repaired step had more misses than ``kcap``: the lanes
        past it kept K3's answer from a cell they had left. One host read."""
        worst = int(self._max_miss)
        if worst > self.kcap:
            raise RuntimeError(f"repair round overflow: {worst} misses > kcap {self.kcap}")

    @property
    def state(self):
        """(8, n) planes [x, y, t, dt, miss, 0, 0, 0] after the last step;
        reading them runs ``audit``."""
        self.audit()
        return self._state

    def one_step(self):
        """K3 on every lane, then (with ``repair``) one compacted repair
        round. Advances the resident planes; returns the step's miss count as
        a device scalar (no host read)."""
        t0 = float(self.t)
        out = fused_rk4_step(self.rowsT, self.uvT, self._state, self.deg2m, self.inv_t1,
                             self.dt)
        cnt = (out[4] > 0.5).sum()
        if self.repair:
            idx = self.round_idx(out[4])
            sub_out = self.repair_rk4(self.gather_sub(self._state, idx), t0)
            out, self.rowsT, self.uvT = self.scatter_sub(out, self.rowsT, self.uvT, idx,
                                                         sub_out)
            self._max_miss = torch.maximum(self._max_miss, cnt)
        self._state = out
        self.t = np.float32(self.t + np.float32(self.dt))
        return cnt

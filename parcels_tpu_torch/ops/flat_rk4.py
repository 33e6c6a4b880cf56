"""K4: the fused flat-mesh RK4 cache-hit step.

Port of the JAX package's Pallas micro-benchmark kernel
(``scripts/micro_pallas_rk4.py``, ``_kernel`` / ``run_pallas``): every lane
runs all four RK stages from its cached cell operands (the tangent-frame
point-in-cell row and C-grid geometry, 20 of the 32 row planes), its four U
and four V face values and its state ``[x, y, t, dt]``, and returns its
displacement ``[dx, dy, 0, 0, 0, 0, 0, 0]``. It has no in-cell test and no
miss flag, and its bilinear inverse picks the root nearer 0.5 (unlike K3's).

``flat_rk4_step`` launches the CUDA kernel (``csrc/flat_rk4.cu``) for tensors
on the card and uses its plain PyTorch version, ``flat_rk4_step_plain``, only
for tensors on the CPU. ``synthetic_inputs`` builds the script's unit-cell
inputs, optionally mixed with lanes that reach every branch of the step;
``micro_bench`` times the kernel against its plain version as the script's
``main`` times the Pallas kernel against XLA.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flat_rk4_step", "flat_rk4_step_plain", "micro_bench", "synthetic_inputs"]

#: planes of the layouts: cell rows (32), face values [u4 | v4] (8), state
#: [x, y, t, dt, 0 x 4] (8) and the output [dx, dy, 0 x 6] (8)
ROW_PLANES, UV_PLANES, STATE_PLANES, OUT_PLANES = 32, 8, 8, 8
#: the row planes the step reads: origin 0-1, frame 3-4 and 6-7, projected
#: corners 9-14, geometry 16-23
ROW_PLANES_READ = (0, 1, 3, 4, 6, 7, *range(9, 15), *range(16, 24))
#: bytes a lane must move: 20 row planes, 8 uv planes and 4 state planes
#: read once, 8 output planes written once
BYTES_PER_LANE = (len(ROW_PLANES_READ) + UV_PLANES + 4 + OUT_PLANES) * 4


def _bilinear_inverse_plain(p1u, p1v, p2u, p2v, p3u, p3v, xq, yq):
    """(xsi, eta) of the query in the quad (0, p1, p2, p3), the root of the
    quadratic nearer 0.5 (``micro_pallas_rk4._bilinear_inverse``)."""
    a1 = p1u
    a2 = p3u
    a3 = -p1u + p2u - p3u
    b1 = p1v
    b2 = p3v
    b3 = p2v - p1v - p3v
    aa = a3 * b2 - a2 * b3
    bb = a1 * b2 - a2 * b1 + xq * b3 - yq * a3
    cc = xq * b1 - yq * a1
    det2 = bb * bb - 4 * aa * cc
    det = torch.sqrt(torch.clamp_min(det2, 0.0))
    sign_bb = torch.where(bb >= 0, 1.0, -1.0)
    q = -0.5 * (bb + sign_bb * det)
    r1 = q / torch.where(aa == 0.0, 1.0, aa)
    r2 = cc / torch.where(q == 0.0, 1.0, q)
    r1 = torch.where(aa == 0.0, r2, r1)
    r2 = torch.where(q == 0.0, 0.0, r2)
    pick1 = torch.abs(r1 - 0.5) <= torch.abs(r2 - 0.5)
    eta = torch.where(pick1, r1, r2)
    denx = a1 + a3 * eta
    deny = b1 + b3 * eta
    use_x = torch.abs(denx) >= torch.abs(deny)
    xsi = torch.where(
        use_x,
        (xq - a2 * eta) / torch.where(denx == 0.0, 1.0, denx),
        (yq - b2 * eta) / torch.where(deny == 0.0, 1.0, deny),
    )
    return xsi, eta


def _stage_plain(r, uv, x, y, tau):
    """One RK stage from the cached operands: (u, v) at (x, y, tau)."""
    dx = x - r[0]
    dy = y - r[1]
    qu = dx * r[3] + dy * r[4]
    qv = dx * r[6] + dy * r[7]
    xsi, eta = _bilinear_inverse_plain(r[9], r[10], r[11], r[12], r[13], r[14], qu, qv)
    dlon10, dlon23, dlon30, dlon21 = r[16], r[17], r[18], r[19]
    dlat10, dlat23, dlat30, dlat21 = r[20], r[21], r[22], r[23]
    c1 = torch.sqrt(dlon10 * dlon10 + dlat10 * dlat10)
    c2 = torch.sqrt(dlon21 * dlon21 + dlat21 * dlat21)
    c3 = torch.sqrt(dlon23 * dlon23 + dlat23 * dlat23)
    c4 = torch.sqrt(dlon30 * dlon30 + dlat30 * dlat30)
    omt = 1.0 - tau
    u_w = uv[0] * omt + uv[1] * tau
    u_e = uv[2] * omt + uv[3] * tau
    v_s = uv[4] * omt + uv[5] * tau
    v_n = uv[6] * omt + uv[7] * tau
    Uvel = (1.0 - xsi) * c4 * u_w + xsi * c2 * u_e
    Vvel = (1.0 - eta) * c1 * v_s + eta * c3 * v_n
    dxdxsi = (1.0 - eta) * dlon10 + eta * dlon23
    dxdeta = (1.0 - xsi) * dlon30 + xsi * dlon21
    dydxsi = (1.0 - eta) * dlat10 + eta * dlat23
    dydeta = (1.0 - xsi) * dlat30 + xsi * dlat21
    jac = dxdxsi * dydeta - dxdeta * dydxsi
    jac = torch.where(jac == 0.0, 1.0, jac)
    u = (Uvel * dxdxsi + Vvel * dxdeta) / jac
    v = (Uvel * dydxsi + Vvel * dydeta) / jac
    return u, v


def flat_rk4_step_plain(row, uv, scal):
    """Plain PyTorch version of K4, operation for operation
    (``micro_pallas_rk4._rk4_step`` without the barriers).

    ``tau = t * 0`` is kept as a product, so a NaN or infinite ``t`` gives a
    NaN step. The division by 6 is tensor by tensor: a division by a Python
    scalar may run as a multiplication by its reciprocal on the card.
    """
    x, y, t, dt = scal[0], scal[1], scal[2], scal[3]
    tau0 = t * 0.0  # single-bracket synthetic case
    u1, v1 = _stage_plain(row, uv, x, y, tau0)
    u2, v2 = _stage_plain(row, uv, x + 0.5 * dt * u1, y + 0.5 * dt * v1, tau0)
    u3, v3 = _stage_plain(row, uv, x + 0.5 * dt * u2, y + 0.5 * dt * v2, tau0)
    u4, v4 = _stage_plain(row, uv, x + dt * u3, y + dt * v3, tau0)
    six = torch.full_like(x, 6.0)
    ddx = (u1 + 2 * u2 + 2 * u3 + u4) / six * dt
    ddy = (v1 + 2 * v2 + 2 * v3 + v4) / six * dt
    zero = torch.zeros_like(ddx)
    return torch.stack([ddx, ddy, zero, zero, zero, zero, zero, zero])


def _check(name, t, planes, n, device):
    if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 tensor on {device}")
    if tuple(t.shape) != (planes, n):
        raise ValueError(f"{name}: expected shape {(planes, n)}, got {tuple(t.shape)}")


def flat_rk4_step(row, uv, scal):
    """One fused RK4 step of every lane: (8, n) ``[dx, dy, 0 x 6]``.

    ``row`` (32, n), ``uv`` (8, n) and ``scal`` (8, n) are f32 planes; any
    ``n``. On a CUDA tensor this launches K4 (``flat_rk4_step.launches``
    counts the launches); on a CPU tensor it runs the plain version.
    """
    if row.device.type == "cpu":
        return flat_rk4_step_plain(row, uv, scal)
    if row.device.type != "cuda":
        raise ValueError(f"flat_rk4_step: expected CUDA or CPU tensors, got {row.device}")
    n = row.shape[1]
    for name, t, planes in (("row", row, ROW_PLANES), ("uv", uv, UV_PLANES),
                            ("scal", scal, STATE_PLANES)):
        _check(name, t, planes, n, row.device)
    out = torch.empty((OUT_PLANES, n), dtype=torch.float32, device=row.device)
    if n == 0:
        return out
    from parcels_tpu_torch.ops._build import load

    launch = load("flat_rk4")
    err = launch(row.data_ptr(), uv.data_ptr(), scal.data_ptr(), out.data_ptr(), n,
                 torch.cuda.current_stream(row.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flat_rk4 kernel launch failed with cudaError {err}")
    flat_rk4_step.launches += 1
    return out


flat_rk4_step.launches = 0


def synthetic_inputs(n: int, seed: int = 0, device="cuda", branches: bool = False):
    """(row, uv, scal) planes for ``n`` lanes.

    Without ``branches``: the micro-benchmark's synthetic unit cells
    (``micro_pallas_rk4.main``): random origins, the identity tangent frame,
    the unit square and unit geometry, points inside the cell, dt 0.3. These
    cells are parallelograms (the quadratic's leading term is 0 on every
    lane), so they reach only the linear branch.

    With ``branches``, every second lane is replaced by a lane that reaches
    the other branches: random convex quads in random rotated frames (the
    quadratic, both root picks, both denominators), every 7th of those a
    collinear cell (q == 0), every 11th an all-zero cell (zero denominators
    and a zero Jacobian), and NaN positions, NaN and infinite t spread over
    them.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32
    row = np.zeros((ROW_PLANES, n), f32)
    row[0] = rng.uniform(0, 1000, n)
    row[1] = rng.uniform(0, 1000, n)
    row[3] = 1.0
    row[7] = 1.0
    row[9], row[10] = 1.0, 0.0  # p1
    row[11], row[12] = 1.0, 1.0  # p2
    row[13], row[14] = 0.0, 1.0  # p3
    row[16] = 1.0  # dlon10
    row[19 + 2] = 1.0  # the script's "dlat30 (col 22)": col 21, dlat23
    row[17 + 3] = 1.0  # the script's "dlon23": col 20, dlat10
    row[17] = 1.0  # dlon23
    row[23] = 1.0  # dlat21
    uv = rng.uniform(-0.3, 0.3, (UV_PLANES, n)).astype(f32)
    scal = np.zeros((STATE_PLANES, n), f32)
    scal[0] = row[0] + rng.uniform(0.3, 0.7, n)
    scal[1] = row[1] + rng.uniform(0.3, 0.7, n)
    scal[3] = 0.3  # dt small: stays in cell
    if branches:
        _mix_branch_lanes(rng, row, uv, scal)
    return tuple(torch.as_tensor(a, device=device) for a in (row, uv, scal))


def _mix_branch_lanes(rng, row, uv, scal):
    """Overwrite every second lane with a branch-covering lane, in place."""
    lanes = np.arange(1, row.shape[1], 2)
    m = lanes.size
    th = rng.uniform(0.0, 2.0 * np.pi, m)
    s = rng.uniform(0.5, 2.0, m)
    cos, sin = s * np.cos(th), s * np.sin(th)
    row[3, lanes], row[4, lanes] = cos, sin  # the frame: a scaled rotation
    row[6, lanes], row[7, lanes] = -sin, cos
    e = rng.uniform(-0.35, 0.35, (6, m))
    corners = np.stack([1 + e[0], e[1], 1 + e[2], 1 + e[3], e[4], 1 + e[5]])
    k = np.arange(m)
    corners[:, k % 7 == 3] = np.array([1.0, 0.0, 3.0, 0.0, 2.0, 0.0])[:, None]  # collinear
    corners[:, k % 11 == 5] = 0.0  # all-zero cell
    row[9:15, lanes] = corners
    # geometry of a perturbed unit cell, scaled: the Jacobian stays near
    # the scale squared, so f32 rounding is not amplified
    g = rng.uniform(-0.2, 0.2, (8, m))
    g[[0, 1, 6, 7]] += 1.0  # dlon10, dlon23, dlat30, dlat21
    g *= rng.uniform(0.5, 2.0, m)
    g[:, k % 11 == 5] = 0.0
    row[16:24, lanes] = g
    # points at (xsi, eta) in [-0.1, 1.1]^2 of the projected quad, mapped
    # back through the frame (its inverse is its transpose over s^2)
    xs, es = rng.uniform(-0.1, 1.1, (2, m))
    p1u, p1v, p2u, p2v, p3u, p3v = row[9:15, lanes].astype(np.float64)
    qu = xs * (1 - es) * p1u + xs * es * p2u + (1 - xs) * es * p3u
    qv = xs * (1 - es) * p1v + xs * es * p2v + (1 - xs) * es * p3v
    # off the collinear cell's line, so its two roots are not a near-tie
    qv = np.where(k % 7 == 3, es, qv)
    scal[0, lanes] = row[0, lanes] + (cos * qu - sin * qv) / (s * s)
    scal[1, lanes] = row[1, lanes] + (sin * qu + cos * qv) / (s * s)
    scal[2, lanes] = rng.uniform(0.0, 1e5, m)
    scal[3, lanes] = rng.uniform(0.05, 0.5, m)
    scal[0, lanes[k % 97 == 7]] = np.nan
    scal[2, lanes[k % 89 == 11]] = np.nan
    scal[2, lanes[k % 83 == 13]] = np.inf
    scal[2, lanes[k % 79 == 17]] = -np.inf


def micro_bench(n: int = 10_000_000, reps: int = 3, device="cuda", seed: int = 0):
    """The micro-benchmark on the card: K4 against its plain version on the
    script's unit cells at ``n`` floored to 2048 lanes. Prints the parity
    line, then each version's ms per step and lane-steps/s; returns them."""
    n = (n // 2048) * 2048
    row, uv, scal = synthetic_inputs(n, seed, device)
    out = flat_rk4_step(row, uv, scal)
    ref = flat_rk4_step_plain(row, uv, scal)
    err = float((out[:2] - ref[:2]).abs().max())
    print(f"n={n}  max |kernel - plain| = {err:.3e}", flush=True)
    nbytes = BYTES_PER_LANE * n
    times = {}
    for name, fn in (("plain", flat_rk4_step_plain), ("cuda", flat_rk4_step)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn(row, uv, scal)
        best = None
        for _ in range(reps):
            torch.cuda.synchronize()
            start.record()
            for _ in range(5):
                fn(row, uv, scal)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            best = ms if best is None else min(best, ms)
        times[name] = best
        print(f"{name:12s}: {best:7.3f} ms/step  {n / best / 1e3:8.1f} M lane-steps/s  "
              f"({nbytes / best / 1e6:5.0f} GB/s effective)", flush=True)
    return {"n": n, "max_abs_err": err, **{f"{k}_ms": v for k, v in times.items()}}

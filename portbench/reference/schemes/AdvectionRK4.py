"""Fourth-order Runge-Kutta as the program's engine takes it: the four
samples at t, t + dt/2, t + dt/2 and t + dt, the displacement
(k1 + 2 k2 + 2 k3 + k4) / 6 * dt added at the end of the step."""

from __future__ import annotations

import torch

from reference import integrate


def run(traffic: dict, sampler, lanes: dict) -> dict:
    dt = float(traffic["dt_s"])
    x, y, z, t0, steps, f32 = integrate.start(lanes)
    r = integrate.rounder(f32)
    x, y = r(x), r(y)
    n = x.numel()
    st = sampler.start(n)
    deleted = torch.zeros(n, dtype=torch.bool)
    taken = torch.zeros(n, dtype=torch.int64)

    def vel(t, xs, ys):
        u, v, oob = sampler.velocity(st, t, z, xs, ys)
        return r(u), r(v), oob

    for s in range(int(steps.max()) if n else 0):
        live = (s < steps) & ~deleted
        if not bool(live.any()):
            break
        t = t0 + s * dt
        u1, v1, o1 = vel(t, x, y)
        u2, v2, o2 = vel(t + 0.5 * dt, r(x + r(r(u1 * 0.5) * dt)), r(y + r(r(v1 * 0.5) * dt)))
        u3, v3, o3 = vel(t + 0.5 * dt, r(x + r(r(u2 * 0.5) * dt)), r(y + r(r(v2 * 0.5) * dt)))
        u4, v4, o4 = vel(t + dt, r(x + r(u3 * dt)), r(y + r(v3 * dt)))
        oob = o1 | o2 | o3 | o4
        ok = live & ~oob
        dx = r(r(r(r(r(u1 + 2 * u2) + 2 * u3) + u4) / 6.0) * dt)
        dy = r(r(r(r(r(v1 + 2 * v2) + 2 * v3) + v4) / 6.0) * dt)
        x = torch.where(ok, r(x + dx), x)
        y = torch.where(ok, r(y + dy), y)
        taken = taken + ok.to(torch.int64)
        deleted = deleted | (live & oob)
    return {"x": x, "y": y, "steps": taken, "deleted": deleted}

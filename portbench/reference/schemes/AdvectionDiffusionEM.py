"""The Euler-Maruyama step of the advection-diffusion kernel with constant
diffusivities (their central differences vanish): one velocity sample at
the step's start, and the displacement u dt + sqrt(2 Kh) dW in degrees, Kh
converted to square degrees at the particle's latitude, with the program's
counter-based draws (``reference.draws``)."""

from __future__ import annotations

import torch

from reference import draws, inputs, integrate


def run(traffic: dict, sampler, lanes: dict) -> dict:
    dt = float(traffic["dt_s"])
    kh = float(traffic["fieldset"]["diffusion"]["kh"])
    x, y, z, t0, steps, f32 = integrate.start(lanes)
    r = integrate.rounder(f32)
    x, y = r(x), r(y)
    position = torch.as_tensor(lanes["ids"], dtype=torch.int64)
    n = x.numel()
    st = sampler.start(n)
    key = draws.set_key(lanes["seed"])
    deleted = torch.zeros(n, dtype=torch.bool)
    taken = torch.zeros(n, dtype=torch.int64)
    sq = abs(dt) ** 0.5
    D = inputs.DEG2M
    for s in range(int(steps.max()) if n else 0):
        live = (s < steps) & ~deleted
        if not bool(live.any()):
            break
        t = t0 + s * dt
        dwx = r(draws.normal(key, 0, position, t) * sq)
        dwy = r(draws.normal(key, 1, position, t) * sq)
        u, v, oob = sampler.velocity(st, t, z, x, y)
        u, v = r(u), r(v)
        bx = r(torch.sqrt(2 * kh / (D * torch.cos(y * torch.pi / 180.0)) ** 2))
        by = r(torch.sqrt(torch.as_tensor(2 * kh / D**2, dtype=torch.float64)).expand(n))
        ok = live & ~oob
        x = torch.where(ok, r(x + r(r(u * dt) + r(bx * dwx))), x)
        y = torch.where(ok, r(y + r(r(v * dt) + r(by * dwy))), y)
        taken = taken + ok.to(torch.int64)
        deleted = deleted | (live & oob)
    return {"x": x, "y": y, "steps": taken, "deleted": deleted}

"""Advection kernels (reference: src/parcels/kernels/_advection.py).

Same user-facing kernel style as the reference — ``f(particles, fieldset)``
accumulating displacements into ``particles.dx/dy/dz`` — written in torch
over the whole particle batch. Where the reference uses per-particle NumPy
masking (RK45's Repeat machinery), the same logic is expressed with
``torch.where`` over the full batch.
"""

from __future__ import annotations

import torch

from parcels_tpu_torch._core.statuscodes import StatusCode

__all__ = [
    "AdvectionEE",
    "AdvectionRK2",
    "AdvectionRK2_3D",
    "AdvectionRK4",
    "AdvectionRK4_3D",
    "AdvectionRK45",
]


def AdvectionEE(particles, fieldset):
    """Explicit (forward) Euler advection."""
    u1, v1 = fieldset.UV[particles]
    particles.dx = particles.dx + u1 * particles.dt
    particles.dy = particles.dy + v1 * particles.dt


def AdvectionRK2(particles, fieldset):
    """Second-order Runge-Kutta (midpoint) advection."""
    u1, v1 = fieldset.UV[particles]
    x1 = particles.x + u1 * 0.5 * particles.dt
    y1 = particles.y + v1 * 0.5 * particles.dt
    u2, v2 = fieldset.UV[particles.t + 0.5 * particles.dt, particles.z, y1, x1, particles]
    particles.dx = particles.dx + u2 * particles.dt
    particles.dy = particles.dy + v2 * particles.dt


def AdvectionRK2_3D(particles, fieldset):
    """Second-order Runge-Kutta advection including vertical velocity."""
    u1, v1, w1 = fieldset.UVW[particles]
    x1 = particles.x + u1 * 0.5 * particles.dt
    y1 = particles.y + v1 * 0.5 * particles.dt
    z1 = particles.z + w1 * 0.5 * particles.dt
    u2, v2, w2 = fieldset.UVW[particles.t + 0.5 * particles.dt, z1, y1, x1, particles]
    particles.dx = particles.dx + u2 * particles.dt
    particles.dy = particles.dy + v2 * particles.dt
    particles.dz = particles.dz + w2 * particles.dt


def AdvectionRK4(particles, fieldset):
    """Classic fourth-order Runge-Kutta advection."""
    dt = particles.dt
    u1, v1 = fieldset.UV[particles]
    x1 = particles.x + u1 * 0.5 * dt
    y1 = particles.y + v1 * 0.5 * dt
    u2, v2 = fieldset.UV[particles.t + 0.5 * dt, particles.z, y1, x1, particles]
    x2 = particles.x + u2 * 0.5 * dt
    y2 = particles.y + v2 * 0.5 * dt
    u3, v3 = fieldset.UV[particles.t + 0.5 * dt, particles.z, y2, x2, particles]
    x3 = particles.x + u3 * dt
    y3 = particles.y + v3 * dt
    u4, v4 = fieldset.UV[particles.t + dt, particles.z, y3, x3, particles]
    particles.dx = particles.dx + (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dt
    particles.dy = particles.dy + (v1 + 2 * v2 + 2 * v3 + v4) / 6.0 * dt


def AdvectionRK4_3D(particles, fieldset):
    """Fourth-order Runge-Kutta advection including vertical velocity."""
    dt = particles.dt
    u1, v1, w1 = fieldset.UVW[particles]
    x1 = particles.x + u1 * 0.5 * dt
    y1 = particles.y + v1 * 0.5 * dt
    z1 = particles.z + w1 * 0.5 * dt
    u2, v2, w2 = fieldset.UVW[particles.t + 0.5 * dt, z1, y1, x1, particles]
    x2 = particles.x + u2 * 0.5 * dt
    y2 = particles.y + v2 * 0.5 * dt
    z2 = particles.z + w2 * 0.5 * dt
    u3, v3, w3 = fieldset.UVW[particles.t + 0.5 * dt, z2, y2, x2, particles]
    x3 = particles.x + u3 * dt
    y3 = particles.y + v3 * dt
    z3 = particles.z + w3 * dt
    u4, v4, w4 = fieldset.UVW[particles.t + dt, z3, y3, x3, particles]
    particles.dx = particles.dx + (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dt
    particles.dy = particles.dy + (v1 + 2 * v2 + 2 * v3 + v4) / 6.0 * dt
    particles.dz = particles.dz + (w1 + 2 * w2 + 2 * w3 + w4) / 6.0 * dt


# Fehlberg RK4(5) tableau
_RK45_C = (1.0 / 4, 3.0 / 8, 12.0 / 13, 1.0, 1.0 / 2)
_RK45_A = (
    (1.0 / 4, 0.0, 0.0, 0.0, 0.0),
    (3.0 / 32, 9.0 / 32, 0.0, 0.0, 0.0),
    (1932.0 / 2197, -7200.0 / 2197, 7296.0 / 2197, 0.0, 0.0),
    (439.0 / 216, -8.0, 3680.0 / 513, -845.0 / 4104, 0.0),
    (-8.0 / 27, 2.0, -3544.0 / 2565, 1859.0 / 4104, -11.0 / 40),
)
_RK45_B4 = (25.0 / 216, 0.0, 1408.0 / 2565, 2197.0 / 4104, -1.0 / 5)
_RK45_B5 = (16.0 / 135, 0.0, 6656.0 / 12825, 28561.0 / 56430, -9.0 / 50, 2.0 / 55)


def AdvectionRK45(particles, fieldset):
    """Adaptive Runge-Kutta-Fehlberg 4(5) advection with per-particle dt.

    Requires fieldset context 'RK45_tol' (m), 'RK45_min_dt', 'RK45_max_dt'
    (s) and a particle variable ``next_dt``. dt is halved when the 4th/5th
    order error estimate exceeds the tolerance (particle state -> Repeat, the
    engine resubmits), and doubled when it is below tol/10
    (reference kernels/_advection.py:85-156).
    """
    dt = particles.dt
    # not torch.sign: a dt clamped to exactly 0 at an endtime landing would
    # make sign 0 and poison the min_dt floors below into permanent zeros
    sign_dt = torch.where(dt < 0, -1.0, 1.0)

    us = []
    vs = []
    u1, v1 = fieldset.UV[particles]
    us.append(u1)
    vs.append(v1)
    for stage in range(5):
        xs = particles.x
        ys = particles.y
        for j in range(stage + 1):
            xs = xs + us[j] * _RK45_A[stage][j] * dt
            ys = ys + vs[j] * _RK45_A[stage][j] * dt
        un, vn = fieldset.UV[
            particles.t + _RK45_C[stage] * dt, particles.z, ys, xs, particles
        ]
        us.append(un)
        vs.append(vn)

    x_4th = sum(us[j] * _RK45_B4[j] for j in range(5)) * dt
    y_4th = sum(vs[j] * _RK45_B4[j] for j in range(5)) * dt
    x_5th = sum(us[j] * _RK45_B5[j] for j in range(6)) * dt
    y_5th = sum(vs[j] * _RK45_B5[j] for j in range(6)) * dt

    kappa = torch.sqrt((x_5th - x_4th) ** 2 + (y_5th - y_4th) ** 2)

    tol = fieldset.RK45_tol
    min_dt = fieldset.RK45_min_dt
    max_dt = fieldset.RK45_max_dt

    good = (kappa <= tol) | (torch.abs(dt) <= abs(min_dt))
    particles.dx = particles.dx + torch.where(good, x_5th, 0.0)
    particles.dy = particles.dy + torch.where(good, y_5th, 0.0)

    increase = good & (kappa <= tol / 10) & (torch.abs(dt * 2) <= abs(max_dt))
    next_dt = torch.where(increase, dt * 2, dt)
    next_dt = torch.where(torch.abs(next_dt) > abs(max_dt), max_dt * sign_dt, next_dt)
    particles.next_dt = next_dt
    particles.state = torch.where(good, StatusCode.Evaluate, particles.state).to(torch.int32)

    repeat = ~good
    new_dt = torch.where(repeat, dt / 2, dt)
    new_dt = torch.where(torch.abs(new_dt) < abs(min_dt), min_dt * sign_dt, new_dt)
    particles.dt = new_dt
    particles.state = torch.where(repeat, StatusCode.Repeat, particles.state).to(torch.int32)

"""CROCO terrain-following (sigma) grid kernels (torch).

Port of the JAX package's ``kernels/sigmagrids.py`` (reference
src/parcels/kernels/_sigmagrids.py): z -> sigma conversion with free
surface, omega sampling, and the dedicated CROCO RK2-3D advection. The
z -> sigma search is a fixed-shape vectorized scan over the (small) number
of sigma levels; no per-particle Python.

Required fieldset members (as in the reference): fields ``h`` (bathymetry),
``zeta`` (sea surface height), context constant ``hc`` and field ``Cs_w``
(stretching curve at w-levels, one value per sigma level); ``U.grid.depth``
holds the sigma levels themselves.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AdvectionRK2_3D_CROCO", "SampleOmegaCroco", "convert_z_to_sigma_croco"]


def _f32(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v, np.float32))


def convert_z_to_sigma_croco(fieldset, t, z, y, x, particles):
    """Local sigma coordinate of particles at depth z (reference :6-25).

    Inverts the CROCO vertical stretching z(sigma) = z0 + zeta (1 + z0/h)
    with z0 = hc sigma + (h - hc) Cs_w(sigma), linearly per sigma layer.
    Inside a kernel ``fieldset`` is the engine's view and every argument a
    tensor on its device; on a host FieldSet (interactive use, reference
    test_sigmagrids.py:43) the arguments may be numpy and the result is a
    CPU tensor.
    """
    z = _f32(z)
    zeros = torch.zeros_like(z)
    h = _f32(fieldset.h.eval(t, zeros, y, x, particles=particles))
    zeta = _f32(fieldset.zeta.eval(t, zeros, y, x, particles=particles))
    grid = fieldset.U.grid
    if hasattr(grid, "garrs"):  # the engine's view
        sigma_levels = grid.garrs["depth"]  # (nz,) sigma in [-1, 0]
    else:  # host FieldSet
        sigma_levels = _f32(grid.depth)
    cs_w = _f32(fieldset.Cs_w.data).reshape(-1).to(h.device)  # (nz,)
    sigma_levels = sigma_levels.to(h.device)
    z = z.to(h.device)
    hc = fieldset.hc

    h_ = h[:, None]
    z0 = hc * sigma_levels[None, :] + (h_ - hc) * cs_w[None, :]
    zvec = z0 + zeta[:, None] * (1.0 + z0 / h_)  # (n, nz), increasing
    nz = zvec.shape[1]

    # left bracket: number of levels with zvec <= z, minus one (clipped)
    below = (zvec <= z[:, None]).sum(dim=1)
    zi = torch.clamp(below - 1, 0, nz - 2)

    z_lo = zvec.gather(1, zi[:, None])[:, 0]
    z_hi = zvec.gather(1, zi[:, None] + 1)[:, 0]
    frac = (z - z_lo) / torch.where(z_hi == z_lo, 1.0, z_hi - z_lo)
    return sigma_levels[zi] + frac * (sigma_levels[zi + 1] - sigma_levels[zi])


def SampleOmegaCroco(particles, fieldset):
    """Sample the omega field at the particle's sigma level (reference :28-35)."""
    sigma = convert_z_to_sigma_croco(
        fieldset, particles.t, particles.z, particles.y, particles.x, particles
    )
    particles.omega = fieldset.omega[particles.t, sigma, particles.y, particles.x, particles]


def AdvectionRK2_3D_CROCO(particles, fieldset):
    """RK2 advection on CROCO sigma layers (reference :38-72).

    The vertical velocity is CROCO's ``w`` sampled linearly (not C-grid
    staggered) and advects the *relative* sigma depth z/h, which is then
    mapped back to meters at the new horizontal position.
    """
    t, dt = particles.t, particles.dt
    zeros = torch.zeros_like(particles.z)

    sigma = particles.z / fieldset.h[t, zeros, particles.y, particles.x, particles]

    sig = convert_z_to_sigma_croco(fieldset, t, particles.z, particles.y, particles.x, particles)
    u1, v1 = fieldset.UV[t, sig, particles.y, particles.x, particles]
    w1 = fieldset.W[t, sig, particles.y, particles.x, particles]
    w1 = w1 * sigma / fieldset.h[t, zeros, particles.y, particles.x, particles]
    x1 = particles.x + u1 * 0.5 * dt
    y1 = particles.y + v1 * 0.5 * dt
    sig_dep1 = sigma + w1 * 0.5 * dt
    dep1 = sig_dep1 * fieldset.h[t, zeros, y1, x1, particles]

    sig1 = convert_z_to_sigma_croco(fieldset, t + 0.5 * dt, dep1, y1, x1, particles)
    u2, v2 = fieldset.UV[t + 0.5 * dt, sig1, y1, x1, particles]
    w2 = fieldset.W[t + 0.5 * dt, sig1, y1, x1, particles]
    w2 = w2 * sig_dep1 / fieldset.h[t + 0.5 * dt, zeros, y1, x1, particles]
    x2 = particles.x + u2 * 0.5 * dt
    y2 = particles.y + v2 * 0.5 * dt
    sig_dep2 = sigma + w2 * 0.5 * dt
    dep2 = sig_dep2 * fieldset.h[t + 0.5 * dt, zeros, y2, x2, particles]

    particles.dx = particles.dx + u2 * dt
    particles.dy = particles.dy + v2 * dt
    particles.dz = particles.dz + (dep1 - particles.z) + (dep2 - particles.z)

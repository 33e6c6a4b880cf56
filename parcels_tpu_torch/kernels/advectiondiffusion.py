"""Advection-diffusion SDE kernels (reference: src/parcels/kernels/_advectiondiffusion.py).

Port of the JAX package's ``kernels/advectiondiffusion.py``. The Wiener
increments come from the engine's RNG (``particles.random_normal()``): a
counter-based draw keyed by the set's seed, the draw's place in the step,
each particle's set position and its clock, so runs repeat exactly for a
seed whatever their chunks, in place of the reference's global
``np.random``. The streams differ from the JAX package's threefry streams;
the moments of the displacement are what agree.
"""

from __future__ import annotations

import math

import torch

__all__ = ["AdvectionDiffusionEM", "AdvectionDiffusionM1", "DiffusionUniformKh"]


def meters_to_degrees_zonal(val, lat, deg2m):
    """Convert square metres to square degrees longitude at a given latitude."""
    return val / (deg2m * torch.cos(lat * math.pi / 180.0)) ** 2


def meters_to_degrees_meridional(val, deg2m):
    """Convert square metres to square degrees latitude."""
    return val / deg2m**2


def _kh_sample(particles, fieldset, which: str, dy=0.0, dx=0.0):
    field = getattr(fieldset, which)
    val = field[particles.t, particles.z, particles.y + dy, particles.x + dx, particles]
    if field.grid.spec.spherical:
        if which == "Kh_zonal":
            val = meters_to_degrees_zonal(val, particles.y, field.grid.spec.deg2m)
        else:
            val = meters_to_degrees_meridional(val, field.grid.spec.deg2m)
    return val


def AdvectionDiffusionM1(particles, fieldset):
    """2-D advection-diffusion with the first-order Milstein (M1) scheme.

    Requires fields ``Kh_zonal``/``Kh_meridional`` and context ``dres`` (the
    central-difference resolution, of the order of the local grid size).
    Strong and weak order 1.
    """
    sqdt = torch.sqrt(torch.abs(particles.dt))
    dWx = particles.random_normal() * sqdt
    dWy = particles.random_normal() * sqdt
    dres = fieldset.dres

    Kxp1 = _kh_sample(particles, fieldset, "Kh_zonal", dx=dres)
    Kxm1 = _kh_sample(particles, fieldset, "Kh_zonal", dx=-dres)
    dKdx = (Kxp1 - Kxm1) / (2 * dres)

    u, v = fieldset.UV[particles.t, particles.z, particles.y, particles.x, particles]
    kh_zonal = _kh_sample(particles, fieldset, "Kh_zonal")
    bx = torch.sqrt(2 * kh_zonal)

    Kyp1 = _kh_sample(particles, fieldset, "Kh_meridional", dy=dres)
    Kym1 = _kh_sample(particles, fieldset, "Kh_meridional", dy=-dres)
    dKdy = (Kyp1 - Kym1) / (2 * dres)
    kh_meridional = _kh_sample(particles, fieldset, "Kh_meridional")
    by = torch.sqrt(2 * kh_meridional)

    particles.dx = particles.dx + u * particles.dt + 0.5 * dKdx * (dWx**2 + particles.dt) + bx * dWx
    particles.dy = particles.dy + v * particles.dt + 0.5 * dKdy * (dWy**2 + particles.dt) + by * dWy


def AdvectionDiffusionEM(particles, fieldset):
    """2-D advection-diffusion with the Euler-Maruyama scheme (strong order 0.5)."""
    sqdt = torch.sqrt(torch.abs(particles.dt))
    dWx = particles.random_normal() * sqdt
    dWy = particles.random_normal() * sqdt
    dres = fieldset.dres

    u, v = fieldset.UV[particles.t, particles.z, particles.y, particles.x, particles]

    Kxp1 = _kh_sample(particles, fieldset, "Kh_zonal", dx=dres)
    Kxm1 = _kh_sample(particles, fieldset, "Kh_zonal", dx=-dres)
    dKdx = (Kxp1 - Kxm1) / (2 * dres)
    ax = u + dKdx
    kh_zonal = _kh_sample(particles, fieldset, "Kh_zonal")
    bx = torch.sqrt(2 * kh_zonal)

    Kyp1 = _kh_sample(particles, fieldset, "Kh_meridional", dy=dres)
    Kym1 = _kh_sample(particles, fieldset, "Kh_meridional", dy=-dres)
    dKdy = (Kyp1 - Kym1) / (2 * dres)
    ay = v + dKdy
    kh_meridional = _kh_sample(particles, fieldset, "Kh_meridional")
    by = torch.sqrt(2 * kh_meridional)

    particles.dx = particles.dx + ax * particles.dt + bx * dWx
    particles.dy = particles.dy + ay * particles.dt + by * dWy


def DiffusionUniformKh(particles, fieldset):
    """2-D diffusion with spatially uniform Kh (no gradient terms).

    Add the diffusivities with
    ``fieldset.add_constant_field("Kh_zonal", kh, mesh=...)`` etc.
    """
    sqdt = torch.sqrt(torch.abs(particles.dt))
    dWx = particles.random_normal() * sqdt
    dWy = particles.random_normal() * sqdt

    kh_zonal = fieldset.Kh_zonal[particles]
    kh_meridional = fieldset.Kh_meridional[particles]
    if fieldset.Kh_zonal.grid.spec.spherical:
        kh_zonal = meters_to_degrees_zonal(kh_zonal, particles.y, fieldset.Kh_zonal.grid.spec.deg2m)
        kh_meridional = meters_to_degrees_meridional(
            kh_meridional, fieldset.Kh_meridional.grid.spec.deg2m
        )

    particles.dx = particles.dx + torch.sqrt(2 * kh_zonal) * dWx
    particles.dy = particles.dy + torch.sqrt(2 * kh_meridional) * dWy

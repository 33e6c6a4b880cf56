"""Interpolator library of the port (structured A-grid and C-grid schemes)."""

from parcels_tpu_torch.interpolators._base import ScalarInterpolator, VectorInterpolator
from parcels_tpu_torch.interpolators.xinterp import (
    CGrid_Tracer,
    CGrid_Velocity,
    XConstantField,
    XLinear,
    XLinear_Velocity,
)

__all__ = [
    "CGrid_Tracer",
    "CGrid_Velocity",
    "ScalarInterpolator",
    "VectorInterpolator",
    "XConstantField",
    "XLinear",
    "XLinear_Velocity",
]

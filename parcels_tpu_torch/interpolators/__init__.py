"""Interpolator library of the port (structured A-grid schemes)."""

from parcels_tpu_torch.interpolators._base import ScalarInterpolator, VectorInterpolator
from parcels_tpu_torch.interpolators.xinterp import XConstantField, XLinear, XLinear_Velocity

__all__ = [
    "ScalarInterpolator",
    "VectorInterpolator",
    "XConstantField",
    "XLinear",
    "XLinear_Velocity",
]

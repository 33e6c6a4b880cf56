"""Interpolator library of the port (structured A-grid and C-grid schemes, UGRID meshes)."""

from parcels_tpu_torch.interpolators._base import ScalarInterpolator, VectorInterpolator
from parcels_tpu_torch.interpolators.uxinterp import (
    Ux_Velocity,
    UxConstantFaceConstantZC,
    UxConstantFaceLinearZF,
    UxLinearNodeConstantZC,
    UxLinearNodeLinearZF,
)
from parcels_tpu_torch.interpolators.xinterp import (
    CGrid_Tracer,
    CGrid_Velocity,
    XConstantField,
    XFreeslip,
    XLinear,
    XLinearInvdistLandTracer,
    XLinear_Velocity,
    XNearest,
    XPartialslip,
)

__all__ = [
    "CGrid_Tracer",
    "CGrid_Velocity",
    "ScalarInterpolator",
    "UxConstantFaceConstantZC",
    "UxConstantFaceLinearZF",
    "UxLinearNodeConstantZC",
    "UxLinearNodeLinearZF",
    "Ux_Velocity",
    "VectorInterpolator",
    "XConstantField",
    "XFreeslip",
    "XLinear",
    "XLinearInvdistLandTracer",
    "XLinear_Velocity",
    "XNearest",
    "XPartialslip",
]

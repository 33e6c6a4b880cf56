"""Pre-built physics kernels (torch; composable, reference-style signatures)."""

from parcels_tpu_torch.kernels.advection import (
    AdvectionEE,
    AdvectionRK2,
    AdvectionRK2_3D,
    AdvectionRK4,
    AdvectionRK4_3D,
    AdvectionRK45,
)
from parcels_tpu_torch.kernels.advectiondiffusion import (
    AdvectionDiffusionEM,
    AdvectionDiffusionM1,
    DiffusionUniformKh,
)
from parcels_tpu_torch.kernels.analytical import AdvectionAnalytical
from parcels_tpu_torch.kernels.sigmagrids import (
    AdvectionRK2_3D_CROCO,
    SampleOmegaCroco,
    convert_z_to_sigma_croco,
)

__all__ = [
    "AdvectionAnalytical",
    "AdvectionDiffusionEM",
    "AdvectionDiffusionM1",
    "AdvectionEE",
    "AdvectionRK2",
    "AdvectionRK2_3D",
    "AdvectionRK2_3D_CROCO",
    "AdvectionRK4",
    "AdvectionRK4_3D",
    "AdvectionRK45",
    "DiffusionUniformKh",
    "SampleOmegaCroco",
    "convert_z_to_sigma_croco",
]

"""parcels_tpu_torch — the PyTorch/CUDA port of parcels_tpu.

Same public names as ``parcels_tpu`` for what the port has landed so far:
structured rectilinear and curvilinear fieldsets on A- and C-grids (with
the NEMO and CROCO converters ``convert.nemo_to_sgrid`` and
``convert.croco_to_sgrid`` and the C-grid stage cache), unstructured
triangular UGRID fieldsets (``FieldSet.from_ugrid_conventions``, with the
FESOM2 and ICON converters, the fused face-row tier and the per-face stage
cache), the structured and UGRID interpolators, ``ParticleSet.execute`` with the advection, advection-diffusion,
analytical and CROCO sigma-grid kernels, Parquet trajectory output, checkpoint and restart,
and out-of-core forcing: zarr and NetCDF stores opened lazily (``io``) and streamed to the
card a time window at a time (``FieldSet.set_time_window``). Field sampling runs
through hand-written CUDA kernels for Hopper (``ops/``) on the card, and
through their plain PyTorch versions for tensors on the CPU.

Quick start::

    import numpy as np
    from parcels_tpu_torch import FieldSet, ParticleSet
    from parcels_tpu_torch.kernels import AdvectionRK4
    from parcels_tpu_torch.datasets import moving_eddy_dataset

    fs = FieldSet.from_sgrid_conventions(moving_eddy_dataset(), mesh="flat")  # on cuda
    pset = ParticleSet(fs, x=[12000.0], y=[12500.0], t=[np.timedelta64(0, "s")])
    pset.execute(AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"))

This package never imports JAX or ``parcels_tpu``.
"""

from parcels_tpu_torch import convert, io, kernels
from parcels_tpu_torch._core.basegrid import BaseGrid
from parcels_tpu_torch._core.field import Field, VectorField
from parcels_tpu_torch._core.fieldset import FieldSet
from parcels_tpu_torch._core.grid import XGrid
from parcels_tpu_torch._core.mesh import EARTH_RADIUS, FlatMesh, SphericalMesh, get_mesh
from parcels_tpu_torch._core.options import EngineOptions
from parcels_tpu_torch._core.particle import Particle, ParticleClass, Variable, get_default_particle
from parcels_tpu_torch._core.particlefile import ParticleFile, read_particlefile
from parcels_tpu_torch._core.particleset import ParticleSet, state_from_numpy
from parcels_tpu_torch._core.statuscodes import (
    AllParcelsErrorCodes,
    FieldInterpolationError,
    FieldOutOfBoundError,
    FieldOutOfBoundSurfaceError,
    FieldSamplingError,
    GridSearchingError,
    KernelError,
    OutsideTimeInterval,
    StatusCode,
)
from parcels_tpu_torch._core.timeutils import CFDatetime, TimeInterval
from parcels_tpu_torch._core.uxgrid import UxGrid
from parcels_tpu_torch._core.warnings_ import (
    FieldEvalWarning,
    FieldSetWarning,
    FileWarning,
    KernelWarning,
    ParticleSetWarning,
)
from parcels_tpu_torch._logging import logger
from parcels_tpu_torch.interpolators import (
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
from parcels_tpu_torch.io.zarrstore import open_raw_zarr
from parcels_tpu_torch.kernels import (
    AdvectionAnalytical,
    AdvectionDiffusionEM,
    AdvectionDiffusionM1,
    AdvectionEE,
    AdvectionRK2,
    AdvectionRK2_3D,
    AdvectionRK2_3D_CROCO,
    AdvectionRK4,
    AdvectionRK4_3D,
    AdvectionRK45,
    DiffusionUniformKh,
    SampleOmegaCroco,
)

__version__ = "0.1.0"

__all__ = [
    "EARTH_RADIUS",
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
    "AllParcelsErrorCodes",
    "BaseGrid",
    "CFDatetime",
    "CGrid_Tracer",
    "CGrid_Velocity",
    "DiffusionUniformKh",
    "EngineOptions",
    "Field",
    "FieldEvalWarning",
    "FieldInterpolationError",
    "FieldOutOfBoundError",
    "FieldOutOfBoundSurfaceError",
    "FieldSamplingError",
    "FieldSet",
    "FieldSetWarning",
    "FileWarning",
    "FlatMesh",
    "GridSearchingError",
    "KernelError",
    "KernelWarning",
    "OutsideTimeInterval",
    "Particle",
    "ParticleClass",
    "ParticleFile",
    "ParticleSet",
    "ParticleSetWarning",
    "SampleOmegaCroco",
    "SphericalMesh",
    "StatusCode",
    "TimeInterval",
    "UxGrid",
    "Variable",
    "VectorField",
    "XConstantField",
    "XFreeslip",
    "XGrid",
    "XLinear",
    "XLinearInvdistLandTracer",
    "XLinear_Velocity",
    "XNearest",
    "XPartialslip",
    "convert",
    "get_default_particle",
    "get_mesh",
    "io",
    "kernels",
    "logger",
    "open_raw_zarr",
    "read_particlefile",
    "state_from_numpy",
]

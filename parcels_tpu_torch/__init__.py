"""parcels_tpu_torch — the PyTorch/CUDA port of parcels_tpu.

Same public names as ``parcels_tpu`` for what the port has landed so far:
structured rectilinear and curvilinear fieldsets on A- and C-grids (with
the NEMO converter ``convert.nemo_to_sgrid`` and the C-grid stage cache),
``ParticleSet.execute`` with the advection kernels, and Parquet trajectory
output. Field sampling runs
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

from parcels_tpu_torch import convert, kernels
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
    XLinear,
    XLinear_Velocity,
)
from parcels_tpu_torch.kernels import (
    AdvectionEE,
    AdvectionRK2,
    AdvectionRK2_3D,
    AdvectionRK4,
    AdvectionRK4_3D,
    AdvectionRK45,
)

__version__ = "0.1.0"

__all__ = [
    "EARTH_RADIUS",
    "AdvectionEE",
    "AdvectionRK2",
    "AdvectionRK2_3D",
    "AdvectionRK4",
    "AdvectionRK4_3D",
    "AdvectionRK45",
    "AllParcelsErrorCodes",
    "CFDatetime",
    "CGrid_Tracer",
    "CGrid_Velocity",
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
    "SphericalMesh",
    "StatusCode",
    "TimeInterval",
    "Variable",
    "VectorField",
    "XConstantField",
    "XGrid",
    "XLinear",
    "XLinear_Velocity",
    "convert",
    "get_default_particle",
    "get_mesh",
    "kernels",
    "logger",
    "read_particlefile",
    "state_from_numpy",
]

"""Particle status codes and the error taxonomy.

Capability parity with the reference Parcels v4 status machine
(reference: src/parcels/_core/statuscodes.py:19-128). The codes are ordered so
that ``jnp.maximum`` merges of per-particle states escalate towards errors,
which is how the TPU engine combines states inside jitted kernels.
"""

from __future__ import annotations

__all__ = [
    "AllParcelsErrorCodes",
    "FieldInterpolationError",
    "FieldOutOfBoundError",
    "FieldOutOfBoundSurfaceError",
    "FieldSamplingError",
    "GeneralError",
    "GridSearchingError",
    "KernelError",
    "OutsideTimeInterval",
    "StatusCode",
]


class StatusCode:
    """Status codes for ``particles.state`` (int32 on device)."""

    Success = 0
    EndofLoop = 1
    Evaluate = 10
    Repeat = 20
    Delete = 30
    StopExecution = 40
    StopAllExecution = 41
    Error = 50
    ErrorInterpolation = 51
    ErrorGridSearching = 52
    ErrorOutOfBounds = 60
    ErrorThroughSurface = 61
    ErrorOutsideTimeInterval = 70


#: Smallest state value that is considered an error by the execution engine.
MIN_ERROR_CODE = StatusCode.Error


class FieldSamplingError(RuntimeError):
    """Field sampling failed."""


class FieldInterpolationError(RuntimeError):
    """Field interpolation returned NaN."""


class FieldOutOfBoundError(RuntimeError):
    """Field sampled out-of-bounds."""


class FieldOutOfBoundSurfaceError(RuntimeError):
    """Field sampled through the surface (z above the first depth level)."""


class GridSearchingError(RuntimeError):
    """Grid search could not locate the particle."""


class GeneralError(RuntimeError):
    """General kernel error."""


class OutsideTimeInterval(RuntimeError):
    """Field sampled outside its valid time interval."""


class KernelError(RuntimeError):
    """General particle-kernel error."""


#: Exception type -> status code (mirrors reference AllParcelsErrorCodes).
AllParcelsErrorCodes: dict[type[Exception], int] = {
    FieldInterpolationError: StatusCode.ErrorInterpolation,
    FieldOutOfBoundError: StatusCode.ErrorOutOfBounds,
    FieldOutOfBoundSurfaceError: StatusCode.ErrorThroughSurface,
    GridSearchingError: StatusCode.ErrorGridSearching,
    OutsideTimeInterval: StatusCode.ErrorOutsideTimeInterval,
    KernelError: StatusCode.Error,
    GeneralError: StatusCode.Error,
}

#: status code -> exception factory, used by the host after a jitted chunk
#: returns with error states present (reference kernel.py:31-38 ErrorsToThrow).
_STATE_TO_ERROR: dict[int, type[Exception]] = {
    StatusCode.ErrorOutsideTimeInterval: OutsideTimeInterval,
    StatusCode.ErrorOutOfBounds: FieldOutOfBoundError,
    StatusCode.ErrorThroughSurface: FieldOutOfBoundSurfaceError,
    StatusCode.ErrorInterpolation: FieldInterpolationError,
    StatusCode.ErrorGridSearching: GridSearchingError,
    StatusCode.Error: GeneralError,
}


def raise_error_from_state(code: int, z=None, y=None, x=None, t=None):
    """Raise the typed exception matching a particle error state."""
    exc = _STATE_TO_ERROR.get(int(code), GeneralError)
    if exc is OutsideTimeInterval:
        raise exc(f"Field sampled outside time domain at time {t}.")
    raise exc(f"Particle error state {code} at (z={z}, y={y}, x={x})")

"""Warning taxonomy (reference: src/parcels/_core/warnings.py)."""

from __future__ import annotations

__all__ = [
    "FieldEvalWarning",
    "FieldSetWarning",
    "FileWarning",
    "KernelWarning",
    "ParticleSetWarning",
]


class FieldSetWarning(UserWarning):
    """Warning raised when there are issues in the construction of the FieldSet."""


class ParticleSetWarning(UserWarning):
    """Warning raised when there are issues in the construction or execution of the ParticleSet."""


class FieldEvalWarning(UserWarning):
    """Warning raised during field evaluation (e.g. out-of-bounds samples zeroed)."""


class KernelWarning(UserWarning):
    """Warning raised when there are issues within kernel execution or configuration."""


class FileWarning(UserWarning):
    """Warning raised for file handling / trajectory output issues."""

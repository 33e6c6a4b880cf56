"""Flat vs. spherical mesh geometry (reference: src/parcels/_core/mesh.py)."""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

__all__ = ["EARTH_RADIUS", "BaseMesh", "FlatMesh", "SphericalMesh", "get_mesh"]

# Radius chosen such that one degree of arc is exactly 1852 * 60 metres
# (one nautical mile per arc-minute), matching the reference convention.
EARTH_RADIUS = 6366707.019493707


class BaseMesh(ABC):
    radius: float | None

    @abstractmethod
    def is_spherical(self) -> bool: ...

    @property
    def deg2m(self) -> float:
        """Metres per degree of arc (1.0 for flat meshes)."""
        if self.radius is None:
            return 1.0
        return self.radius * np.pi / 180.0

    def __eq__(self, other):
        return (
            isinstance(other, BaseMesh)
            and self.is_spherical() == other.is_spherical()
            and self.radius == other.radius
        )

    def __hash__(self):
        return hash((self.is_spherical(), self.radius))


class SphericalMesh(BaseMesh):
    """Spherical mesh; lon/lat are degrees. ``radius`` in metres."""

    def __init__(self, radius: float = EARTH_RADIUS):
        if not isinstance(radius, (int, float, np.number)):
            raise TypeError(f"radius must be a number, got {type(radius).__name__}")
        if radius <= 0:
            raise ValueError(f"radius must be positive, got {radius}")
        self.radius = float(radius)

    def is_spherical(self) -> bool:
        return True

    def __repr__(self):
        return f"SphericalMesh(radius={self.radius})"


class FlatMesh(BaseMesh):
    """Flat mesh; coordinates are metres."""

    def __init__(self):
        self.radius = None

    def is_spherical(self) -> bool:
        return False

    def __repr__(self):
        return "FlatMesh()"


def get_mesh(mesh) -> BaseMesh:
    if isinstance(mesh, BaseMesh):
        return mesh
    if mesh == "flat":
        return FlatMesh()
    if mesh == "spherical":
        return SphericalMesh(EARTH_RADIUS)
    raise ValueError(f"mesh must be 'flat', 'spherical', or a mesh object. Got {mesh!r}")

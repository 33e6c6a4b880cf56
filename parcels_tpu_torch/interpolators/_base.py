"""Interpolator ABCs (reference: src/parcels/interpolators/_base.py)."""

from __future__ import annotations

__all__ = ["ScalarInterpolator", "VectorInterpolator"]


class ScalarInterpolator:
    """Scalar field interpolator: ``interp(particle_positions, grid_positions, field)``."""

    def interp(self, particle_positions: dict, grid_positions: dict, field):
        raise NotImplementedError

    # Interpolators are stateless: equal when of one type and settings.
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items()))))


class VectorInterpolator:
    """Vector field interpolator: ``interp(...) -> (u, v, w)``."""

    def interp(self, particle_positions: dict, grid_positions: dict, vectorfield):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items()))))

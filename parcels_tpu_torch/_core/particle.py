"""Particle schema: Variable descriptors, ParticleClass, SoA creation.

Capability parity with reference src/parcels/_core/particle.py:17-222. The
particle state is a struct-of-arrays dict; on device it becomes a pytree of
jnp arrays with fixed capacity plus internal bookkeeping entries:

- ``ei``      (n, ngrids) int32 — cached raveled cell index per grid
- ``_active`` (n,) bool         — validity mask (replaces physical row
                                  deletion, which XLA's static shapes forbid)
- ``_rng``    (2,) uint32       — counter-based RNG key for SDE kernels
"""

from __future__ import annotations

import operator
from typing import Any

import numpy as np

from parcels_tpu_torch._core.statuscodes import StatusCode

__all__ = ["Particle", "ParticleClass", "Variable", "create_particle_data", "get_default_particle"]

_TO_WRITE_OPTIONS = [True, False]

INTERNAL_VARS = ("ei", "_active", "_rng", "_tc")


class _AttrNameHelper:
    """attrgetter('name')(helper) == 'name' (v3 compat, reference _compat.py:5-22)."""

    def __getattr__(self, name):
        return name


def _assert_varname(name: str):
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"Variable name must be a valid Python identifier. Got {name!r}")


class Variable:
    """Descriptor of one particle attribute (name, dtype, initial, to_write, attrs)."""

    def __init__(
        self,
        name: str,
        dtype: np.dtype[Any] | type[np.generic] = np.float32,
        initial=0,
        to_write: bool = True,
        attrs: dict | None = None,
    ):
        _assert_varname(name)
        try:
            dtype = np.dtype(dtype)
        except (TypeError, ValueError) as e:
            raise TypeError(f"Variable dtype must be a valid numpy dtype. Got {dtype!r}") from e
        if to_write not in _TO_WRITE_OPTIONS:
            raise ValueError(f"to_write must be one of {_TO_WRITE_OPTIONS!r}. Got {to_write!r}")
        if attrs is None:
            attrs = {}
        if not to_write and attrs != {}:
            raise ValueError(f"Attributes cannot be set if to_write={to_write!r}.")
        self._name = name
        self.dtype = dtype
        self.initial = initial
        self.to_write = to_write
        self.attrs = attrs

    @property
    def name(self):
        return self._name

    def __repr__(self):
        return f"Variable(name={self.name!r}, dtype={self.dtype}, to_write={self.to_write})"


class ParticleClass:
    """An ordered collection of Variables defining a particle type."""

    def __init__(self, variables: list[Variable]):
        if not isinstance(variables, list):
            raise TypeError(f"Expected list of Variable objects, got {type(variables)}")
        if not all(isinstance(v, Variable) for v in variables):
            raise ValueError(f"All items must be Variable instances. Got {variables!r}")
        self.variables = variables

    def __repr__(self):
        return f"ParticleClass({[v.name for v in self.variables]})"

    def add_variable(self, variable: Variable | list[Variable]) -> "ParticleClass":
        """Return a new ParticleClass with the extra variable(s)."""
        if isinstance(variable, Variable):
            variable = [variable]
        for var in variable:
            if not isinstance(var, Variable):
                raise TypeError(f"Expected Variable, got {type(var)}")
        existing = {v.name for v in self.variables}
        for var in variable:
            if var.name in existing:
                raise ValueError(f"Variable name already exists: {var.name}")
        return ParticleClass(variables=self.variables + list(variable))

    def var_names(self) -> list[str]:
        return [v.name for v in self.variables]


def get_default_particle(spatial_dtype: type = np.float32) -> ParticleClass:
    """Default particle: t, z/y/x, dz/dy/dx, particle_id, dt, state.

    ``t``/``dt`` are declared float64 for the output-file schema; on TPU the
    device copies run float32 (see module docstring precision note).
    """
    if spatial_dtype not in (np.float32, np.float64):
        raise ValueError(f"spatial_dtype must be np.float32 or np.float64. Got {spatial_dtype!r}")
    return ParticleClass(
        variables=[
            Variable("t", dtype=np.float64, attrs={"standard_name": "time", "units": "seconds", "axis": "T"}),
            Variable(
                "z",
                dtype=spatial_dtype,
                attrs={"standard_name": "vertical coordinate", "units": "m", "positive": "down"},
            ),
            Variable(
                "y", dtype=spatial_dtype, attrs={"standard_name": "latitude", "units": "degrees_north", "axis": "Y"}
            ),
            Variable(
                "x", dtype=spatial_dtype, attrs={"standard_name": "longitude", "units": "degrees_east", "axis": "X"}
            ),
            Variable("dz", dtype=spatial_dtype, to_write=False),
            Variable("dy", dtype=spatial_dtype, to_write=False),
            Variable("dx", dtype=spatial_dtype, to_write=False),
            Variable(
                "particle_id",
                dtype=np.int64,
                attrs={"long_name": "Unique identifier for each particle", "cf_role": "trajectory_id"},
            ),
            Variable("dt", dtype=np.float64, initial=1.0, to_write=False),
            Variable("state", dtype=np.int32, initial=StatusCode.Evaluate, to_write=False),
        ]
    )


Particle = get_default_particle(np.float32)
"""The default Particle used in parcels_tpu_torch simulations."""


def _device_dtype(dtype: np.dtype) -> np.dtype:
    """Map declared dtypes to TPU-friendly on-device dtypes (no 64-bit)."""
    if dtype == np.float64:
        return np.dtype(np.float32)
    if dtype == np.int64:
        return np.dtype(np.int32)
    return dtype


def create_particle_data(
    *,
    pclass: ParticleClass,
    nparticles: int,
    ngrids: int,
    initial: dict[str, np.ndarray] | None = None,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Create the host-side SoA dict (numpy); the ParticleSet ships it to device."""
    if initial is None:
        initial = {}
    variables = {v.name: v for v in pclass.variables}
    for k in INTERNAL_VARS:
        assert k not in initial, f"{k!r} is internal"

    data: dict[str, np.ndarray] = {
        "ei": np.zeros((nparticles, max(ngrids, 1)), dtype=np.int32),
        "_active": np.ones((nparticles,), dtype=bool),
        "_rng": np.asarray(np.random.default_rng(seed).integers(0, 2**32, size=2), dtype=np.uint32),
        # Kahan carry for the per-lane clock: t lives in f32 on device, so a
        # long run of t += dt accumulates rounding (dt effectively truncated
        # once t outgrows dt's alignment). The compensated pair (t, _tc)
        # carries the lost low bits, giving f64-grade time integration with
        # f32 arithmetic (reference keeps t float64, particle.py:129-160).
        "_tc": np.zeros((nparticles,), dtype=np.float32),
    }

    for var_name, values in initial.items():
        if var_name not in variables:
            raise ValueError(f"Variable {var_name} is not defined in the ParticleClass.")
        values = np.asarray(values)
        if values.shape != (nparticles,):
            raise ValueError(
                f"Initial value for {var_name} must have shape ({nparticles},). Got {values.shape}"
            )
        data[var_name] = values.astype(_device_dtype(variables[var_name].dtype))

    deferred = []
    for var in variables.values():
        if var.name in data:
            continue
        if isinstance(var.initial, operator.attrgetter):
            # v3 compat: ``Variable(..., initial=attrgetter("z"))`` copies the
            # initial state of another variable (reference particle.py:213-214)
            deferred.append(var)
            continue
        data[var.name] = np.full(
            (nparticles,), var.initial, dtype=_device_dtype(var.dtype)
        )
    for var in deferred:
        name_to_copy = var.initial(_AttrNameHelper())
        data[var.name] = data[name_to_copy].astype(_device_dtype(var.dtype))
    return data

"""Typing aliases (capability parity with reference _typing.py:20-48).

Public type vocabulary for user code and the mypy config in pyproject.toml.
cftime is not a dependency here; calendar datetimes are covered by
``parcels_tpu_torch._core.calendars.CFDatetime``.
"""

from __future__ import annotations

import os
from collections.abc import Callable
from datetime import datetime
from typing import Literal

import numpy as np

from parcels_tpu_torch._core.calendars import CFDatetime
from parcels_tpu_torch._sgrid import Padding

__all__ = [
    "CfAxis",
    "CfAxisSpatial",
    "GridPosition",
    "InterpMethod",
    "InterpMethodOption",
    "KernelFunction",
    "PathLike",
    "TMesh",
    "TimeLike",
    "VectorFields",
    "VectorType",
]

InterpMethodOption = Literal[
    "linear",
    "nearest",
    "freeslip",
    "partialslip",
    "cgrid_velocity",
    "linear_invdist_land_tracer",
    "cgrid_tracer",
]
InterpMethod = InterpMethodOption | dict[str, InterpMethodOption]
PathLike = str | os.PathLike
VectorType = Literal["3D", "3DSigma", "2D"] | None
TMesh = Literal["flat", "spherical"]
TimeLike = datetime | np.datetime64 | CFDatetime
KernelFunction = Callable[..., None]
CfAxisSpatial = Literal["X", "Y", "Z"]
CfAxis = CfAxisSpatial | Literal["T"]
GridPosition = Literal["face"] | Padding
VectorFields = dict[str, "tuple[str, str] | tuple[str, str, str]"]

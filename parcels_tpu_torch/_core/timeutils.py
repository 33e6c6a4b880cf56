"""Time interval / clock utilities.

Internal simulation clock is float seconds since the left edge of the
fieldset's time interval (reference: src/parcels/_core/utils/time.py).
On device the clock is float32 (TPUs have no fast float64); the host keeps
float64 bookkeeping for chunk boundaries.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Literal

import numpy as np

try:
    import cftime
except ImportError:  # cftime is not in this environment; CFDatetime replaces it
    cftime = None

from parcels_tpu_torch._core.calendars import CFDatetime

__all__ = ["CFDatetime", "TimeInterval", "float_to_datelike", "timedelta_to_float"]

_DATETIME_TYPES: tuple = (np.timedelta64, datetime, np.datetime64, CFDatetime)
if cftime is not None:  # pragma: no cover
    _DATETIME_TYPES = _DATETIME_TYPES + (cftime.datetime,)


class TimeInterval:
    """Closed time interval between two datetime-like or timedelta64 endpoints."""

    def __init__(self, left, right):
        for name, val in (("left", left), ("right", right)):
            if not isinstance(val, _DATETIME_TYPES):
                raise ValueError(
                    f"Expected {name} to be a np.timedelta64, datetime, cftime.datetime "
                    f"or np.datetime64. Got {type(val)}."
                )
        if left >= right:
            raise ValueError(f"Expected left < right, got left={left} right={right}.")
        if not is_compatible(left, right):
            raise ValueError(f"left and right are incompatible: {left!r}, {right!r}")
        self.left = left
        self.right = right

    @property
    def time_length_as_flt(self) -> float:
        delta = self.right - self.left
        return timedelta_to_float(delta)

    def __contains__(self, item) -> bool:
        return self.left <= item <= self.right

    def is_all_time_in_interval(self, time) -> bool:
        item = np.atleast_1d(time)
        return bool((0 <= item).all() and (item <= self.time_length_as_flt).all())

    def __repr__(self):
        return f"TimeInterval(left={self.left!r}, right={self.right!r})"

    def __eq__(self, other):
        if not isinstance(other, TimeInterval):
            return False
        return self.left == other.left and self.right == other.right

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((str(self.left), str(self.right)))

    def intersection(self, other: "TimeInterval") -> "TimeInterval | None":
        if not is_compatible(self.left, other.left):
            raise ValueError("TimeIntervals are not compatible.")
        start = max(self.left, other.left)
        end = min(self.right, other.right)
        return TimeInterval(start, end) if start < end else None

    def get_cf_attrs(self) -> dict[Literal["units", "calendar"], str]:
        """CF attrs describing 'seconds since left edge'."""
        return _get_cf_attrs(self.left)


def _get_cf_attrs(dt) -> dict:
    if isinstance(dt, CFDatetime):
        return {"units": f"seconds since {dt.isoformat()}", "calendar": dt.calendar}
    if cftime is not None and isinstance(dt, cftime.datetime):  # pragma: no cover
        return {"units": f"seconds since {dt.strftime(dt.format)}", "calendar": dt.calendar}
    if isinstance(dt, np.timedelta64):
        return {"units": "seconds"}
    if isinstance(dt, np.datetime64):
        ts = dt.astype("datetime64[us]").item()
        return _get_cf_attrs_pydatetime(ts)
    if isinstance(dt, datetime):
        return _get_cf_attrs_pydatetime(dt)
    raise NotImplementedError(f"Not implemented for time object {type(dt)!r}")


def _get_cf_attrs_pydatetime(dt: datetime) -> dict:
    if cftime is None:  # pragma: no cover
        return {"units": f"seconds since {dt.isoformat(sep=' ')}", "calendar": "gregorian"}
    dt_cf = cftime.datetime(
        year=dt.year,
        month=dt.month,
        day=dt.day,
        hour=dt.hour,
        minute=dt.minute,
        second=dt.second,
        microsecond=dt.microsecond,
        calendar="gregorian",
    )
    return _get_cf_attrs(dt_cf)


def is_compatible(t1, t2) -> bool:
    """Whether two time endpoints can form an interval (both timedeltas or both datetimes)."""
    if isinstance(t1, np.timedelta64) ^ isinstance(t2, np.timedelta64):
        return False
    try:
        t1 - t2
    except Exception:
        return False
    return True


def timedelta_to_float(dt) -> float:
    """Convert a timedelta-like (or float seconds) to float seconds."""
    if isinstance(dt, timedelta):
        return dt.total_seconds()
    if isinstance(dt, np.timedelta64):
        return float(dt / np.timedelta64(1, "s"))
    if hasattr(dt, "dtype"):
        if np.issubdtype(dt.dtype, np.timedelta64):
            return (dt / np.timedelta64(1, "s")).astype(np.float64)
        if np.issubdtype(dt.dtype, np.object_):
            return np.vectorize(lambda x: x.total_seconds())(dt)
    return float(dt)


def float_to_datelike(dt: float, time_interval: TimeInterval | None):
    """Convert float seconds since interval start back to a datetime/timedelta."""
    if time_interval:
        if isinstance(time_interval.left, CFDatetime):
            return time_interval.left + timedelta(seconds=float(dt))
        result = np.timedelta64(int(dt), "s") + time_interval.left
        if cftime is not None and isinstance(result, cftime.datetime):  # pragma: no cover
            return result
        if isinstance(result, np.datetime64):
            return result.astype("datetime64[s]")
        return result
    return np.timedelta64(int(dt), "s")


def datetimes_to_float_seconds(times: np.ndarray, left) -> np.ndarray:
    """Convert an array of datetime64/timedelta64/cftime values to float64 seconds since ``left``."""
    times = np.asarray(times)
    if np.issubdtype(times.dtype, np.datetime64):
        return timedelta_to_float(times - np.datetime64(left, "ns"))
    if np.issubdtype(times.dtype, np.timedelta64):
        return timedelta_to_float(times - left)
    # cftime object arrays
    return np.asarray([(t - left).total_seconds() for t in times], dtype=np.float64)

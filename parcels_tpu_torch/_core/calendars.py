"""CF-convention calendar datetimes without a cftime dependency.

The reference supports non-standard model calendars through cftime
(reference _core/utils/time.py:122-163 and the cftime round-trip in
_core/particlefile.py:224-286): ocean/climate model output is frequently on
360_day / 365_day (noleap) / 366_day (all_leap) / julian calendars, where
np.datetime64 cannot represent the time axis at all. cftime is not in this
environment, and the arithmetic is plain integer date math, so it is
implemented here directly.

``CFDatetime`` is an immutable calendar-aware datetime supporting exactly
the operations the framework needs:

- subtraction of two same-calendar instants -> ``datetime.timedelta``
- addition/subtraction of ``datetime.timedelta`` / ``np.timedelta64``
- total ordering within a calendar
- CF metadata round-trip (``units`` origin string + ``calendar`` attr)

Calendars: ``360_day``, ``365_day``/``noleap``, ``366_day``/``all_leap``,
``proleptic_gregorian``, ``julian``, and ``standard``/``gregorian`` (the
mixed Julian/Gregorian civil calendar with the 1582-10-15 cutover, matching
cftime/UDUNITS semantics).
"""

from __future__ import annotations

import re
from datetime import timedelta

import numpy as np

__all__ = ["CFDatetime", "CALENDARS", "parse_cf_origin"]

_ALIASES = {
    "noleap": "365_day",
    "all_leap": "366_day",
    "standard": "gregorian",
}

CALENDARS = (
    "gregorian",
    "proleptic_gregorian",
    "julian",
    "360_day",
    "365_day",
    "366_day",
)

_MDAYS_365 = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
_MDAYS_366 = (31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _cum(mdays):
    out, s = [], 0
    for n in mdays:
        out.append(s)
        s += n
    return tuple(out)


_CUM_365 = _cum(_MDAYS_365)
_CUM_366 = _cum(_MDAYS_366)


def _is_leap(y: int, julian: bool) -> bool:
    if julian:
        return y % 4 == 0
    return y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)


# -- day counts since 1970-01-01 of the respective calendar ------------------


def _days_gregorian(y: int, m: int, d: int) -> int:
    """Proleptic-Gregorian days since 1970-01-01 (Hinnant's civil algorithm)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _gregorian_from_days(z: int) -> tuple[int, int, int]:
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


def _days_julian_raw(y: int, m: int, d: int) -> int:
    """Proleptic-Julian day count on an arbitrary epoch (calibrated below)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 3) // 4
    yoe = y - era * 4
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    return era * 1461 + yoe * 365 + doy


def _julian_raw_from_days(z: int) -> tuple[int, int, int]:
    era = (z if z >= 0 else z - 1460) // 1461
    doe = z - era * 1461
    yoe = min(doe // 365, 3)
    y = yoe + era * 4
    doy = doe - 365 * yoe
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


# Calibrate the Julian epoch so the historical cutover lines up: Julian
# 1582-10-04 (Thursday) was followed by Gregorian 1582-10-15 (Friday).
_JULIAN_OFFSET = _days_gregorian(1582, 10, 15) - _days_julian_raw(1582, 10, 15) + 10
#: first Gregorian day (days since 1970-01-01) of the mixed civil calendar
_CUTOVER_DAYS = _days_gregorian(1582, 10, 15)


def _days_julian(y: int, m: int, d: int) -> int:
    return _days_julian_raw(y, m, d) + _JULIAN_OFFSET


def _julian_from_days(z: int) -> tuple[int, int, int]:
    return _julian_raw_from_days(z - _JULIAN_OFFSET)


def _month_days(calendar: str, y: int, m: int) -> int:
    if calendar == "360_day":
        return 30
    if calendar == "365_day":
        return _MDAYS_365[m - 1]
    if calendar == "366_day":
        return _MDAYS_366[m - 1]
    julian = calendar == "julian" or (
        calendar == "gregorian" and _days_julian(y, m, 1) < _CUTOVER_DAYS
    )
    if m == 2 and _is_leap(y, julian):
        return 29
    return _MDAYS_365[m - 1]


def _to_days(calendar: str, y: int, m: int, d: int) -> int:
    """Days since the calendar's 1970-01-01 (all calendars share that anchor)."""
    if calendar == "360_day":
        return (y - 1970) * 360 + (m - 1) * 30 + (d - 1)
    if calendar == "365_day":
        return (y - 1970) * 365 + _CUM_365[m - 1] + (d - 1)
    if calendar == "366_day":
        return (y - 1970) * 366 + _CUM_366[m - 1] + (d - 1)
    if calendar == "proleptic_gregorian":
        return _days_gregorian(y, m, d)
    if calendar == "julian":
        return _days_julian(y, m, d)
    # mixed civil calendar ("standard"/"gregorian"): julian before the
    # cutover, gregorian from 1582-10-15 onward
    g = _days_gregorian(y, m, d)
    if g >= _CUTOVER_DAYS:
        return g
    j = _days_julian(y, m, d)
    if j >= _CUTOVER_DAYS:
        raise ValueError(
            f"{y:04d}-{m:02d}-{d:02d} falls in the 1582 Julian->Gregorian cutover gap"
        )
    return j


def _from_days(calendar: str, z: int) -> tuple[int, int, int]:
    if calendar == "360_day":
        y, rem = divmod(z, 360)
        m, d = divmod(rem, 30)
        return 1970 + y, m + 1, d + 1
    if calendar == "365_day":
        y, rem = divmod(z, 365)
        m = 1
        while m < 12 and rem >= _CUM_365[m]:
            m += 1
        return 1970 + y, m, rem - _CUM_365[m - 1] + 1
    if calendar == "366_day":
        y, rem = divmod(z, 366)
        m = 1
        while m < 12 and rem >= _CUM_366[m]:
            m += 1
        return 1970 + y, m, rem - _CUM_366[m - 1] + 1
    if calendar == "proleptic_gregorian":
        return _gregorian_from_days(z)
    if calendar == "julian":
        return _julian_from_days(z)
    if z >= _CUTOVER_DAYS:
        return _gregorian_from_days(z)
    return _julian_from_days(z)


class CFDatetime:
    """Immutable calendar-aware datetime (cftime.datetime equivalent)."""

    __slots__ = ("year", "month", "day", "hour", "minute", "second", "microsecond", "calendar")

    def __init__(
        self, year, month, day=1, hour=0, minute=0, second=0, microsecond=0, calendar="gregorian"
    ):
        calendar = str(calendar).lower()
        calendar = _ALIASES.get(calendar, calendar)
        if calendar not in CALENDARS:
            raise ValueError(f"Unsupported calendar {calendar!r}; known: {CALENDARS + tuple(_ALIASES)}")
        if not 1 <= month <= 12:
            raise ValueError(f"month must be in 1..12, got {month}")
        ndays = _month_days(calendar, int(year), int(month))
        if not 1 <= day <= ndays:
            raise ValueError(f"day must be in 1..{ndays} for {calendar} {year}-{month:02d}, got {day}")
        if not (0 <= hour < 24 and 0 <= minute < 60 and 0 <= second < 60 and 0 <= microsecond < 10**6):
            raise ValueError("time-of-day component out of range")
        for name, val in zip(self.__slots__[:-1], (year, month, day, hour, minute, second, microsecond)):
            object.__setattr__(self, name, int(val))
        object.__setattr__(self, "calendar", calendar)
        if calendar == "gregorian":
            _to_days(calendar, self.year, self.month, self.day)  # cutover-gap check

    def __setattr__(self, name, value):
        raise AttributeError("CFDatetime is immutable")

    # -- arithmetic ---------------------------------------------------------
    def _total_microseconds(self) -> int:
        days = _to_days(self.calendar, self.year, self.month, self.day)
        secs = self.hour * 3600 + self.minute * 60 + self.second
        return (days * 86400 + secs) * 10**6 + self.microsecond

    @classmethod
    def _from_total_microseconds(cls, us: int, calendar: str) -> "CFDatetime":
        days, rem = divmod(us, 86400 * 10**6)
        y, m, d = _from_days(calendar, days)
        secs, micro = divmod(rem, 10**6)
        hh, rs = divmod(secs, 3600)
        mm, ss = divmod(rs, 60)
        return cls(y, m, d, hh, mm, ss, micro, calendar=calendar)

    @staticmethod
    def _delta_us(other) -> int | None:
        if isinstance(other, timedelta):
            return round(other.total_seconds() * 10**6)
        if isinstance(other, np.timedelta64):
            return int(other.astype("timedelta64[us]").astype(np.int64))
        return None

    def __add__(self, other):
        us = self._delta_us(other)
        if us is None:
            return NotImplemented
        return self._from_total_microseconds(self._total_microseconds() + us, self.calendar)

    __radd__ = __add__

    def __sub__(self, other):
        us = self._delta_us(other)
        if us is not None:
            return self._from_total_microseconds(self._total_microseconds() - us, self.calendar)
        if isinstance(other, CFDatetime):
            if other.calendar != self.calendar:
                raise TypeError(
                    f"Cannot subtract datetimes on different calendars: "
                    f"{self.calendar!r} vs {other.calendar!r}"
                )
            return timedelta(microseconds=self._total_microseconds() - other._total_microseconds())
        return NotImplemented

    def _cmp_key(self, other):
        if not isinstance(other, CFDatetime) or other.calendar != self.calendar:
            raise TypeError(f"Cannot compare {self!r} with {other!r}")
        return other._total_microseconds()

    def __eq__(self, other):
        if not isinstance(other, CFDatetime):
            return NotImplemented
        return self.calendar == other.calendar and (
            self._total_microseconds() == other._total_microseconds()
        )

    def __lt__(self, other):
        return self._total_microseconds() < self._cmp_key(other)

    def __le__(self, other):
        return self._total_microseconds() <= self._cmp_key(other)

    def __gt__(self, other):
        return self._total_microseconds() > self._cmp_key(other)

    def __ge__(self, other):
        return self._total_microseconds() >= self._cmp_key(other)

    def __hash__(self):
        return hash((self.calendar, self._total_microseconds()))

    # -- formatting ---------------------------------------------------------
    def isoformat(self, sep: str = " ") -> str:
        s = f"{self.year:04d}-{self.month:02d}-{self.day:02d}{sep}{self.hour:02d}:{self.minute:02d}:{self.second:02d}"
        if self.microsecond:
            s += f".{self.microsecond:06d}"
        return s

    def strftime(self, fmt: str | None = None) -> str:
        if fmt is None:
            return self.isoformat()
        out = fmt
        for code, val in (
            ("%Y", f"{self.year:04d}"),
            ("%m", f"{self.month:02d}"),
            ("%d", f"{self.day:02d}"),
            ("%H", f"{self.hour:02d}"),
            ("%M", f"{self.minute:02d}"),
            ("%S", f"{self.second:02d}"),
        ):
            out = out.replace(code, val)
        return out

    def __repr__(self):
        return f"CFDatetime({self.isoformat()!r}, calendar={self.calendar!r})"


_ORIGIN_RE = re.compile(
    r"^\s*(-?\d{1,5})-(\d{1,2})-(\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d{1,6}))?)?)?\s*$"
)


def parse_cf_origin(origin: str, calendar: str) -> CFDatetime:
    """Parse the origin of a CF ``"<unit> since <origin>"`` string onto ``calendar``."""
    m = _ORIGIN_RE.match(origin)
    if m is None:
        raise ValueError(f"Unparseable CF time origin {origin!r}")
    y, mo, d, hh, mm, ss, frac = m.groups()
    micro = int((frac or "0").ljust(6, "0"))
    return CFDatetime(
        int(y), int(mo), int(d), int(hh or 0), int(mm or 0), int(ss or 0), micro, calendar=calendar
    )

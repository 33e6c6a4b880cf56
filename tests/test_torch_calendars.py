"""The JAX package's calendar tier (``tests/test_calendars.py``) through both
packages.

The end-to-end ``360_day`` case (``test_calendars.py:132``), a ``noleap``
twin of it, and ``TimeInterval`` over ``CFDatetime`` endpoints (:122) run
the same inputs through ``parcels_tpu`` and the port (on the CPU): the
JAX test's own assertions on both, equal particle sets (rtol 1e-6, its
tolerance), equal trajectory files with equal decoded ``CFDatetime`` times,
and equal interval lengths and CF attributes. The other calendar cases
(:43-111) exercise ``_core/calendars.py``, which the port holds as a
byte-for-byte copy (``tests/test_torch_copies.py``).
"""

from datetime import timedelta

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu._core import calendars as jcal
from parcels_tpu._core import timeutils as jtime
from parcels_tpu_torch._core import calendars as tcal
from parcels_tpu_torch._core import timeutils as ttime
from torch_twins import PACKAGES, assert_same_files, assert_same_sets, sgrid

CAL = {jp: jcal, tp: tcal}


def _calendar_fieldset(m, calendar, t0):
    """``test_calendars.py:132``'s 8 x 8 flat field, U = 1 m/s, four levels
    10 days apart from ``t0`` on ``calendar``."""
    from importlib import import_module

    structured = import_module(f"{m.__name__}.datasets.structured")
    xdim = ydim = 8
    lon = np.linspace(0, 1e6, xdim)
    lat = np.linspace(0, 1e6, ydim)
    start = CAL[m].CFDatetime(*t0, calendar=calendar)
    time = np.asarray([start + timedelta(days=10 * i) for i in range(4)], dtype=object)
    U = np.full((4, 1, ydim, xdim), 1.0, np.float32)
    V = np.zeros((4, 1, ydim, xdim), np.float32)
    ds = m.xrlite.Dataset(
        {"U": (["time", "depth", "YG", "XG"], U), "V": (["time", "depth", "YG", "XG"], V)},
        coords=structured._coords_2d(lon, lat, time=time, depth=np.array([0.0]), mesh="flat"),
    )
    return sgrid(m, structured._wrap_sgrid(ds, xdim, ydim)), start


@pytest.mark.parametrize("calendar, t0", [("360_day", (2000, 2, 25)), ("noleap", (2000, 2, 28))])
def test_calendar_fieldset_end_to_end(calendar, t0, tmp_path):
    """A ``360_day`` fieldset (``test_calendars.py:132``) and a ``noleap``
    one whose day crosses the absent 29 February: both packages advect,
    and both files round-trip the calendar through the CF metadata."""
    sets, paths = {}, {}
    for m in PACKAGES:
        fs, start = _calendar_fieldset(m, calendar, t0)
        assert isinstance(fs.time_interval.left, CAL[m].CFDatetime)
        pset = m.ParticleSet(fs, x=[1e5], y=[5e5], t=[0.0])
        paths[m] = tmp_path / f"cal_{m.__name__}.parquet"
        pf = m.ParticleFile(paths[m], outputdt=np.timedelta64(6, "h"), mode="w")
        pset.execute(m.AdvectionEE, dt=np.timedelta64(1, "h"), runtime=np.timedelta64(1, "D"),
                     output_file=pf)
        pf.close()
        np.testing.assert_allclose(pset.x, 1e5 + 86400.0, rtol=1e-6)
        times = m.read_particlefile(paths[m])["t"].to_numpy()
        assert all(isinstance(t, CAL[m].CFDatetime) for t in times)
        assert all(t.calendar == start.calendar for t in times)  # noleap reads 365_day
        assert min(times) == start
        assert max(times) == start + timedelta(days=1)
        sets[m] = pset
    assert_same_sets(sets[jp], sets[tp], rtol=1e-6)
    jdec, tdec = assert_same_files(paths[jp], paths[tp], rtol=1e-6)
    if calendar == "noleap":
        assert max(tdec["t"]).isoformat() == "2000-03-01 00:00:00"


cf_calendar = st.sampled_from(list(tcal.CALENDARS) + ["noleap", "all_leap", "standard"])


@st.composite
def cf_fields(draw):
    """The fields of a ``CFDatetime`` (``test_calendars.py:28``'s strategy)."""
    return (draw(st.integers(1900, 2100)), draw(st.integers(1, 12)), draw(st.integers(1, 28)),
            draw(st.integers(0, 23)), draw(st.integers(0, 59)), draw(st.integers(0, 59)),
            draw(cf_calendar))


@given(cf_fields(), st.integers(60, 60 * 60 * 24 * 365))
@settings(max_examples=50, deadline=None)
def test_time_interval_with_cf_datetimes(fields, secs):
    """``TimeInterval`` over ``CFDatetime`` endpoints in both packages: the
    JAX test's assertions on each, equal lengths and CF attributes."""
    *ymdhms, calendar = fields
    out = []
    for cal, timeutils in ((jcal, jtime), (tcal, ttime)):
        dt = cal.CFDatetime(*ymdhms, calendar=calendar)
        iv = timeutils.TimeInterval(dt, dt + timedelta(seconds=secs))
        assert iv.time_length_as_flt == pytest.approx(secs)
        attrs = iv.get_cf_attrs()
        assert attrs["calendar"] == dt.calendar
        assert attrs["units"].startswith("seconds since ")
        out.append((iv.time_length_as_flt, attrs, iv.left.isoformat(), iv.right.isoformat()))
    assert out[1] == out[0]

"""``ParticleSet.execute``'s set-up, reduced on the lanes' device, against
the numpy set-up it replaced.

The set-up reads one small tensor back (``execute.setup``): the live count,
the finite active release clocks' count, min and max, whether any clock is
NaN, the z-levels the active lanes occupy and, in sort mode, whether the
``ei`` cache holds a cell. Each case runs ``execute`` up to its first chunk
and holds what the set-up produced (start and end time, the filled clocks
bit for bit, the occupied z-levels and their quantized share, the sort
seeding, the ``outputdt`` warning) equal to the reference below, which
copies the numpy set-up over the host columns.
"""

import warnings

import numpy as np
import pytest
import torch

import parcels_tpu_torch as tp
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._core import particleset as psmod
from parcels_tpu_torch._core.timeutils import timedelta_to_float
from parcels_tpu_torch._core.warnings_ import ParticleSetWarning
from parcels_tpu_torch.datasets.structured import _coords_2d, _wrap_sgrid
from parcels_tpu_torch.ops.binned_sample import quantize_z_occupancy

torch.set_num_threads(1)

F32 = np.float32
E07 = float(np.float32(0.7))  # 0.7's float32 lies below 0.7
DEPTH = np.array([0.0, 0.7, 1.0, 2.5, 7.0])  # 0.7 is no float32, the rest are


def _down(v):
    return float(np.nextafter(F32(v), F32(-np.inf)))


def _up(v):
    return float(np.nextafter(F32(v), F32(np.inf)))


# -- the reference: the numpy set-up over the host columns ------------------

def _reference_times(time_interval, release_times, runtime, endtime, sign_dt):
    """The start and end time as resolved from the whole release column."""
    release_times = np.asarray(release_times, dtype=np.float64)
    finite = release_times[np.isfinite(release_times)]
    if sign_dt == 1:
        first_release = finite.min() if finite.size else np.nan
    else:
        first_release = finite.max() if finite.size else np.nan
    if time_interval is not None and endtime is not None:
        endtime = timedelta_to_float(endtime - time_interval.left)
    if time_interval is None:
        fieldset_start = 0.0 if sign_dt == 1 else float(runtime)
    else:
        fieldset_start = (
            0.0 if sign_dt == 1 else timedelta_to_float(time_interval.right - time_interval.left)
        )
    start_time = float(first_release) if np.isfinite(first_release) else fieldset_start
    if endtime is None:
        endtime = start_time + sign_dt * float(runtime)
    return start_time, float(endtime)


def _reference_levels(fieldset, z, act):
    depth = max((np.asarray(g.depth) for g in fieldset.gridset), key=lambda d: d.size, default=None)
    if depth is not None and depth.ndim == 1 and depth.size > 2 and bool(np.all(np.diff(depth) > 0)):
        z = z[act] if act.any() else z
        zi = np.clip(np.searchsorted(depth, z, side="right") - 1, 0, depth.size - 2)
        return np.unique(zi).size, np.unique(zi).size / max(depth.size - 1, 1)
    return None, 1.0


def _reference(pset, dt, runtime, endtime=None, outputdt=None):
    cols = {k: v.numpy().copy() for k, v in pset._data.items() if k != "_rng"}
    active, tarr = cols["_active"], cols["t"]
    if not active.sum():
        return None
    sign_dt = int(np.sign(timedelta_to_float(dt)))
    release_t = tarr[active]
    start, end = _reference_times(pset.fieldset.time_interval, release_t,
                                  timedelta_to_float(runtime) if runtime is not None else None,
                                  endtime, sign_dt)
    if np.isnan(tarr).any():
        tarr = tarr.copy()
        tarr[np.isnan(tarr)] = start
    desync = False
    if outputdt:
        rt = np.asarray(release_t)
        desync = bool(np.any(np.mod(rt[np.isfinite(rt)] - start, outputdt) != 0))
    levels, frac = _reference_levels(pset.fieldset, cols["z"], active)
    seeded = bool(cols["ei"].any()) if psmod._sort_mode_enabled(pset.fieldset) else None
    return dict(start=start, end=end, t=tarr, desync=desync, levels=levels,
                z_occ=quantize_z_occupancy(frac), seeded=seeded)


# -- the set-up as ``execute`` runs it ------------------------------------

class _FirstChunk(Exception):
    pass


def _setup(pset, monkeypatch, dt, runtime, endtime=None, output_file=None):
    got = {"populated": False}
    times, read, populate = (psmod._get_simulation_start_and_end_times,
                             psmod.ParticleSet._setup_read, psmod.ParticleSet.populate_indices)

    def record_times(*args):
        got["times"] = times(*args)
        return got["times"]

    def record_read(self, *args):
        got["read"] = read(self, *args)
        return got["read"]

    def record_populate(self):
        got["populated"] = True
        return populate(self)

    def first_chunk(fieldset, kernels, farrays, dev, endtime, dt, **kw):
        got["t"], got["z_occ"] = dev["t"].clone(), kw["z_occ"]
        raise _FirstChunk

    monkeypatch.setattr(psmod, "_get_simulation_start_and_end_times", record_times)
    monkeypatch.setattr(psmod.ParticleSet, "_setup_read", record_read)
    monkeypatch.setattr(psmod.ParticleSet, "populate_indices", record_populate)
    monkeypatch.setattr(psmod, "run_chunk", first_chunk)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            pset.execute(tp.AdvectionRK4, dt=dt, runtime=runtime, endtime=endtime,
                         output_file=output_file)
            got["ran"] = False
        except _FirstChunk:
            got["ran"] = True
    got["desync"] = any(issubclass(w.category, ParticleSetWarning) and "outputdt" in str(w.message)
                        for w in caught)
    return got


# -- fieldsets and cases ----------------------------------------------------

def _fieldset(depth=DEPTH, t_end=86400 * 4):
    T, X, Y = 2, 8, 6
    taxis = np.array([np.datetime64("2000-01-01"), np.datetime64("2000-01-01") +
                      np.timedelta64(int(t_end), "s")])
    dims = ["time", "depth", "YG", "XG"]
    shape = (T, len(depth), Y, X)
    ds = xr.Dataset({"U": (dims, np.zeros(shape, np.float32)), "V": (dims, np.zeros(shape, np.float32))},
                    coords=_coords_2d(np.linspace(0.0, 7e3, X), np.linspace(0.0, 5e3, Y),
                                      time=taxis, depth=np.asarray(depth), mesh="flat"))
    return tp.FieldSet.from_sgrid_conventions(_wrap_sgrid(ds, X, Y), mesh="flat", device="cpu")


def _k2_fieldset():
    """A (2, 1, 16, 2200) field: sort mode is on."""
    shape = (2, 1, 16, 2200)
    T, _, Y, X = shape
    dims = ["time", "depth", "YG", "XG"]
    data = {c: (dims, np.zeros(shape, np.float32)) for c in ("U", "V")}
    taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s") for i in range(T)])
    coords = _coords_2d(np.linspace(0.0, 1000.0 * (X - 1), X), np.linspace(0.0, 1000.0 * (Y - 1), Y),
                        time=taxis, depth=np.zeros(1), mesh="flat")
    return tp.FieldSet.from_sgrid_conventions(_wrap_sgrid(xr.Dataset(data, coords=coords), X, Y),
                                              mesh="flat", device="cpu")


def _pset(fs, z, t, **kw):
    n = len(z)
    return tp.ParticleSet(fs, x=np.full(n, 3e3), y=np.full(n, 2e3), z=z, t=t, **kw)


# a structured grid refuses such axes when it is built: set them after
def _depth_2d(monkeypatch, fs):
    monkeypatch.setattr(fs.gridset[0], "depth", np.tile(DEPTH, (3, 1)))


def _depth_reversed(monkeypatch, fs):
    monkeypatch.setattr(fs.gridset[0], "depth", DEPTH[::-1].copy())


def _remove_first_two(pset):
    pset.remove_indices([0, 1])


def _seed_ei(pset):
    pset._data["ei"][3, 0] = 7


def _z_as_float64(pset):
    pset._data["z"] = pset._data["z"].double()


MIN10, HOUR = np.timedelta64(10, "m"), np.timedelta64(6, "h")
CASES = {
    # z at 0.7's float32 (below 0.7: level 0 with its anchor) and one ulp up (level 1)
    "z_below_inexact_edge": dict(z=[0.35, E07], t=[0.0, 0.0], expect=dict(levels=1)),
    "z_above_inexact_edge": dict(z=[0.85, _up(0.7)], t=[0.0, 0.0], expect=dict(levels=1)),
    "z_ulp_below_inexact_edge": dict(z=[0.35, _down(0.7)], t=[0.0, 0.0], expect=dict(levels=1)),
    # 1.0 is a float32: on it is level 2, one ulp below level 1
    "z_on_exact_edge": dict(z=[1.7, 1.0], t=[0.0, 0.0], expect=dict(levels=1)),
    "z_ulp_below_exact_edge": dict(z=[0.85, _down(1.0)], t=[0.0, 0.0], expect=dict(levels=1)),
    "z_ulp_above_exact_edge": dict(z=[1.7, _up(1.0)], t=[0.0, 0.0], expect=dict(levels=1)),
    "z_outside_axis": dict(z=[-3.0, 9.0, 0.35], t=[0.0, 0.0, 0.0], expect=dict(levels=2)),
    "z_nan_sorts_last": dict(z=[5.0, np.nan], t=[0.0, 0.0], expect=dict(levels=1)),
    # the removed lanes' z (other levels) and t (earlier) must not count
    "inactive_lanes": dict(z=[0.1, 5.0, 1.7, 1.8], t=[-600.0, 1.0, 1200.0, 600.0],
                           prepare=_remove_first_two, expect=dict(levels=1, start=600.0)),
    "nan_clocks_filled": dict(z=[0.35, 0.35, 0.35], t=[np.nan, 1200.0, 600.0]),
    "nan_clocks_filled_dt_negative": dict(z=[0.35, 0.35], t=[np.nan, 3000.0], dt=-MIN10),
    # no finite clock: the fieldset's start; backward, its length 2^24 + 1 s,
    # which the float32 fill rounds
    "all_clocks_nan": dict(z=[0.35, 0.35], t=[np.nan, np.nan]),
    "all_clocks_nan_dt_negative": dict(z=[0.35, 0.35], t=[np.nan, np.nan], dt=-MIN10,
                                       fieldset=lambda: _fieldset(t_end=2**24 + 1),
                                       expect=dict(start=2.0**24 + 1)),
    "dt_negative_takes_max": dict(z=[0.35, 1.7], t=[600.0, 4800.0], dt=-MIN10,
                                  expect=dict(start=4800.0)),
    "no_live_lanes": dict(z=[0.35, 0.35], t=[0.0, 0.0], prepare=lambda p: p.remove_indices([0, 1])),
    "endtime_given": dict(z=[0.35], t=[600.0], runtime=None,
                          endtime=np.datetime64("2000-01-02")),
    "depth_size_2": dict(z=[0.35, 5.0], t=[0.0, 0.0], fieldset=lambda: _fieldset(depth=[0.0, 7.0])),
    "depth_not_increasing": dict(z=[0.35, 5.0], t=[0.0, 0.0], patch=_depth_reversed),
    "depth_2d": dict(z=[0.35, 5.0], t=[0.0, 0.0], patch=_depth_2d),
    "spatial_dtype_float64": dict(z=[0.35, E07, _up(0.7)], t=[0.0, 0.0, 0.0],
                                  pclass=tp.get_default_particle(np.float64)),
    "z_column_float64": dict(z=[0.35, 0.7, np.nextafter(0.7, 1.0)], t=[0.0, 0.0, 0.0],
                             prepare=_z_as_float64),
    "sort_seeds_an_empty_cache": dict(z=[0.0] * 4, t=[0.0] * 4, fieldset=_k2_fieldset,
                                      expect=dict(seeded=False)),
    "sort_keeps_a_seeded_cache": dict(z=[0.0] * 4, t=[0.0] * 4, fieldset=_k2_fieldset,
                                      prepare=_seed_ei, expect=dict(seeded=True)),
    "outputdt_desync_warns": dict(z=[0.35, 0.35], t=[0.0, 600.0], outputdt=1800.0,
                                  expect=dict(desync=True)),
    # the off-grid clock is on a removed lane, the other NaN
    "outputdt_in_step_is_quiet": dict(z=[0.35, 0.35, 0.35, 0.35], t=[700.0, 0.0, 3600.0, np.nan],
                                      outputdt=1800.0, prepare=lambda p: p.remove_indices([0]),
                                      expect=dict(desync=False)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_setup_equals_the_numpy_setup(name, monkeypatch, tmp_path):
    case = CASES[name]
    fs = case.get("fieldset", _fieldset)()
    if "patch" in case:
        case["patch"](monkeypatch, fs)
    pset = _pset(fs, np.asarray(case["z"], dtype=np.float64), np.asarray(case["t"]),
                 **({"pclass": case["pclass"]} if "pclass" in case else {}))
    case.get("prepare", lambda p: None)(pset)
    dt, runtime, endtime = case.get("dt", MIN10), case.get("runtime", HOUR), case.get("endtime")
    ref = _reference(pset, dt, runtime, endtime, case.get("outputdt"))
    for key, value in case.get("expect", {}).items():  # the case tests what its name says
        assert ref[key] == value, key
    pf = None
    if "outputdt" in case:
        pf = tp.ParticleFile(str(tmp_path / "out.parquet"), outputdt=case["outputdt"], mode="w")
    n = pset._data["t"].shape[0]
    got = _setup(pset, monkeypatch, dt, runtime, endtime, pf)
    if ref is None:  # no live lane: execute returns after the one read
        assert not got["ran"] and got["read"].live == 0
        return
    assert got["ran"]
    assert got["times"] == (ref["start"], ref["end"])
    assert got["t"][:n].numpy().view(np.int32).tolist() == ref["t"].view(np.int32).tolist()
    assert got["read"].z_levels == ref["levels"]
    assert got["z_occ"] == ref["z_occ"]
    assert got["read"].seeded == ref["seeded"]
    assert got["populated"] == (ref["seeded"] is False)
    assert got["desync"] == ref["desync"]


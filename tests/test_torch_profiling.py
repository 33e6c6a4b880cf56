"""The program's spans and counters (``parcels_tpu_torch.profiling``).

A span calls ``torch.profiler.record_function`` only while a profiler
records; under ``profiling.trace`` the engine's spans nest from the
``execute`` call down to each kernel call; every synchronizing host
transfer of a run goes through ``profiling.sync``, so the counter holds
exactly the reads the engine's loop implies for the run's steps, blocks,
kernels and chunks (a new read on the main path fails here); and
``last_run_stats`` counts each lane's steps from its own clock.
"""

import json

import numpy as np
import pytest
import torch

import parcels_tpu_torch as tp
from parcels_tpu_torch import profiling
from parcels_tpu_torch import xrlite as xr
from parcels_tpu_torch._core.statuscodes import StatusCode
from parcels_tpu_torch.datasets import moi_like_fieldset, moving_eddy_dataset
from parcels_tpu_torch.datasets.structured import _coords_2d, _wrap_sgrid

torch.set_num_threads(1)


def _eddy_pset(n=1):
    fs = tp.FieldSet.from_sgrid_conventions(moving_eddy_dataset(), mesh="flat", device="cpu")
    return tp.ParticleSet(fs, x=np.linspace(12000.0, 13000.0, n), y=np.full(n, 12500.0),
                          t=np.zeros(n))


def _run_eddy(pset, kernels=tp.AdvectionRK4):
    pset.execute(kernels, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"),
                 options=tp.EngineOptions(max_chunk_steps=4, chunk_target_seconds=0))


class _Counting:
    """Stands in for ``torch.profiler.record_function`` and counts calls."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, name):
        self.calls += 1
        return self.real(name)


def test_spans_call_nothing_while_no_profiler_records(monkeypatch):
    counting = _Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    pset = _eddy_pset()
    _run_eddy(pset)
    assert counting.calls == 0
    # one shared no-op context, whatever the name
    assert profiling.span("a") is profiling.span("b") is profiling.annotate("c")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run_eddy(pset)
    assert counting.calls > 0


def test_trace_nests_the_program_spans(tmp_path):
    pset = _eddy_pset()
    with profiling.trace(str(tmp_path)):
        _run_eddy(pset)
    with open(tmp_path / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and str(e.get("name", "")).startswith("parcels.")]
    ranges = {}
    for e in events:
        ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    chain = ["parcels.execute", "parcels.execute.chunk", "parcels.engine.block",
             "parcels.engine.step", "parcels.kernel.AdvectionRK4"]
    assert len(ranges["parcels.execute"]) == 1
    assert len(ranges["parcels.execute.chunk"]) == 3  # 12 steps in chunks of 4
    assert len(ranges["parcels.engine.step"]) == 12
    for outer, inner in zip(chain, chain[1:]):
        for a, b in ranges[inner]:
            assert any(a0 - 1e-3 <= a and b <= b0 + 1e-3 for a0, b0 in ranges[outer]), inner
    for name in ("parcels.engine.update", "parcels.sample.k1", "parcels.sync.engine.loop",
                 "parcels.sync.engine.repeat", "parcels.sync.execute.drain"):
        assert name in ranges


def _reads(run):
    before, steps0 = dict(profiling.host_reads), profiling.block_steps
    run()
    delta = {k: v - before.get(k, 0) for k, v in profiling.host_reads.items()
             if v != before.get(k, 0)}
    return delta, profiling.block_steps - steps0


def _execute_reads(chunks):
    """The reads of one ``execute`` call outside the engine: the set-up's
    one read (live count, release clocks, NaN check, z occupancy, sort
    seeding), dt's upload, then each chunk's endtime upload and deferred
    flag read, and the run's statistics."""
    return {"execute.setup": 1, "execute.dt": 1, "execute.endtime": chunks,
            "execute.drain": chunks, "execute.stats": 1}


def test_host_reads_of_a_run_with_output(tmp_path):
    """12 steps in chunks of 4 with a snapshot every 30 min: the chunks end
    at 20, 30, 50 and 60 min, and the release clocks' test against outputdt
    reads one flag."""
    pset = _eddy_pset(2)
    pf = tp.ParticleFile(str(tmp_path / "out.parquet"), outputdt=np.timedelta64(30, "m"), mode="w")
    reads, block_steps = _reads(lambda: pset.execute(
        tp.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"), output_file=pf,
        options=tp.EngineOptions(max_chunk_steps=4, chunk_target_seconds=0)))
    pf.close()
    steps, chunks = 12, 4
    assert block_steps == steps
    assert reads == {**_execute_reads(chunks), "execute.outputdt": 1,
                     "engine.loop": steps + chunks, "engine.repeat": steps}


def _k2_fieldset():
    """A (2, 1, 16, 2200) field: past K1's fold, so the binned sampler
    (forced) runs K2's plain version over the sorted set."""
    shape = (2, 1, 16, 2200)
    T, _, Y, X = shape
    rng = np.random.default_rng(0)
    dims = ["time", "depth", "YG", "XG"]
    data = {c: (dims, rng.uniform(-0.3, 0.3, shape).astype(np.float32)) for c in ("U", "V")}
    taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s")
                      for i in range(T)])
    coords = _coords_2d(np.linspace(0.0, 1000.0 * (X - 1), X),
                        np.linspace(0.0, 1000.0 * (Y - 1), Y), time=taxis, depth=np.zeros(1),
                        mesh="flat")
    ds = _wrap_sgrid(xr.Dataset(data, coords=coords), X, Y)
    return tp.FieldSet.from_sgrid_conventions(ds, mesh="flat", device="cpu")


def test_host_reads_of_a_sorted_run_are_the_engine_loops():
    """6 RK4 steps in chunks of 4 and 2, one block: a loop condition a step
    and one at each chunk's end, a Repeat check a step (the sort's seeding
    check is part of the set-up's read); K2's plans (4 a step) read nothing
    back."""
    rng = np.random.default_rng(1)
    n = 300
    pset = tp.ParticleSet(_k2_fieldset(), x=rng.uniform(5e3, 2.1e6, n),
                          y=rng.uniform(3e3, 12e3, n), t=np.zeros(n))
    c0 = profiling.counters()
    reads, block_steps = _reads(lambda: pset.execute(
        tp.AdvectionRK4, dt=np.timedelta64(300, "s"), runtime=np.timedelta64(1800, "s"),
        options=tp.EngineOptions(sampler="binned", max_chunk_steps=4, chunk_target_seconds=0)))
    steps, chunks = 6, 2
    assert block_steps == steps
    assert reads == {**_execute_reads(chunks),
                     "engine.loop": steps + chunks, "engine.repeat": steps}
    assert "k2.plan" not in reads
    lanes = pset._data["state"].shape[0]
    c1 = profiling.counters()
    # a K2 call each for U and V at each of the 4 stages a step
    k2_lanes = c1["k2_lanes"] - c0["k2_lanes"]
    assert k2_lanes == 2 * 4 * steps * lanes
    assert 0 <= c1["k2_overflow_lanes"] - c0["k2_overflow_lanes"] <= k2_lanes


def test_host_reads_of_a_cgrid_run_are_the_engine_loops():
    """10 RK4 steps in chunks of 4, 4 and 2 through the C-grid stage cache
    (its plain version, forced) with a second kernel after RK4: a loop
    condition a step and one at each chunk's end, a Repeat check after each
    kernel; the occupancy of the 3 depth levels is part of the set-up's
    read."""
    fs = moi_like_fieldset(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")

    def Idle(particles, fieldset):  # noqa: N802
        pass

    pset = tp.ParticleSet(fs, x=[-30.0, 40.0, 10.0], y=[10.0, -20.0, 0.0], t=np.zeros(3))
    reads, block_steps = _reads(lambda: pset.execute(
        [tp.AdvectionRK4, Idle], dt=np.timedelta64(30, "m"), runtime=np.timedelta64(5, "h"),
        options=tp.EngineOptions(stagecache="force", max_chunk_steps=4, chunk_target_seconds=0)))
    steps, chunks, kernels = 10, 3, 2
    assert block_steps == steps
    assert reads == {**_execute_reads(chunks),
                     "engine.loop": steps + chunks, "engine.repeat": kernels * steps}
    assert pset.last_run_stats["z_occupancy_hint"] == 0.5


def test_run_stats_count_each_lanes_own_steps():
    """Lane 0 is deleted at 30 min of a 1 h run at dt 5 min: it counts its
    6 steps, the other 3 lanes their 12 each."""

    def DeleteFirstLane(particles, fieldset):  # noqa: N802
        gone = (particles.particle_id == 0) & (particles.t >= 1800.0)
        particles.state = torch.where(gone, StatusCode.Delete, particles.state)

    pset = _eddy_pset(4)
    _run_eddy(pset, [tp.AdvectionRK4, DeleteFirstLane])
    stats = pset.last_run_stats
    assert stats["particles"] == 3
    assert stats["particle_steps_per_s"] * stats["wall_s"] == pytest.approx(6 + 3 * 12, rel=0.01)

"""Each cell at a tiny size through the harness's functions on the CPU: the
run is correct, and its particle-steps are what the lanes' clocks say."""

import time

import numpy as np
import pytest
import torch

import run
from conftest import TINY, limits
from harness.window import Run


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_runs_correct_at_a_tiny_size(bench, name):
    res = run.measure(bench, name, 2**31 + 5, 0.5, False, "cpu", time.perf_counter(),
                      overrides=TINY[name], limits=limits(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert set(res["metrics"]) == {"particle_steps_per_s", "peak_device_gib", "setup_s"}
    assert res["compared"]["lanes_compared"] > 0


@pytest.mark.parametrize("name", ["cmems-glo-phy-024.global-rk4"])
def test_traced_run_reports_per_layer_metrics_it_can_read(bench, name):
    """On the CPU no device interval exists: the trace's readers report
    nothing rather than 0, and the run still checks its answers."""
    res = run.measure(bench, name, 11, 0.5, True, "cpu", time.perf_counter(),
                      overrides=TINY[name], limits=limits(name))
    assert res["correct"]
    assert res["metrics"] == {}
    assert res["extra"]["window_s"] > 0


def test_particle_steps_count_from_the_lanes_clocks(bench):
    """A release whose lanes are deleted part-way counts each lane's own
    steps: every lane of a release in a band where they leave the grid."""
    name = "cmems-glo-phy-024.global-rk4"
    r = Run(bench, name, 3, "cpu", dict(TINY[name]))
    # a narrow box by the last column of nodes (179.5 at this size): lanes
    # that cross it are deleted
    r.traffic["release"] = {"lon": [179.45, 179.4999], "lat": [0.0, 1.0], "z": 0.494025,
                            "ocean_only": False}
    r.setup()
    pset = r._release(0.0)
    r._execute(pset, 6 * 3600.0)
    d = pset._data
    real = d["particle_id"] >= 0
    clocks = ((d["t"].double() + d["_tc"].double()) / r.dt).round()[real]
    gone = int((~d["_active"][real]).sum())
    r._record(pset, 0.0, 6 * 3600.0)
    assert 0 < gone < int(real.sum()), "the box should lose some lanes, not all"
    assert r.work_steps == int(clocks.sum())
    assert r.work_steps < int(real.sum()) * 24
    assert np.isfinite(r.answers[0]["x"]).all()
    assert torch.equal(torch.as_tensor(r.answers[0]["steps"]).long() <= 24,
                       torch.ones(r.answers[0]["steps"].shape, dtype=torch.bool))

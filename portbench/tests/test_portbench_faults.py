"""The check on the timed path fails where the timed path is broken, and
the control (the reference's float32 twin with the velocity sampled in
bfloat16, in the program's place) fails it.

Each fault drives the rest of a run on the CPU (``measure`` skips the look
for a card) with the timed path broken underneath: a step that leaves the
particles where they were; half of the particles left out of the step; an
answer altered where it is produced, in one lane of 8 and in one of 32.
"""

import time

import pytest
import torch

import control
import parcels_tpu_torch as tp
import run
from conftest import TINY, limits


def _still(step):
    def still(particles, fieldset):
        """A step that returns the particles' state unchanged."""
    return still


def _half(step):
    def half(particles, fieldset):
        """The step on the particles of even id only: half of the batch left out."""
        dx0, dy0 = particles.dx, particles.dy
        step(particles, fieldset)
        keep = (particles.particle_id % 2) == 0
        particles.dx = torch.where(keep, particles.dx, dx0)
        particles.dy = torch.where(keep, particles.dy, dy0)
    return half


FAULTS = {"state_unchanged": _still, "half_the_batch": _half}


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(bench, name, fault, monkeypatch):
    from harness import registry

    step = registry.traffic(registry.workload(bench, name)["traffic"])["kernels"][0]
    monkeypatch.setattr(tp, step, FAULTS[fault](getattr(tp, step)))
    res = run.measure(bench, name, 21, 0.5, False, "cpu", time.perf_counter(),
                      overrides=TINY[name], limits=limits(name))
    assert not res["correct"], res["checks"]


def _alter(every: int):
    def alter(pset, k):
        # one particle in ``every`` moved 0.01 degree east where the step left it
        d = pset._data
        hit = (d["particle_id"] % every) == 0
        d["x"] = torch.where(hit, d["x"] + 0.01, d["x"])
    return alter


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("every", [8, 32])
def test_an_altered_answer_is_not_correct(bench, name, every):
    """One lane in 8, and one in 32 (about 3 %, fewer than the 5 % a 95th
    percentile leaves out), moved where the step left them."""
    res = run.measure(bench, name, 22, 0.5, False, "cpu", time.perf_counter(),
                      overrides=TINY[name], limits=limits(name),
                      after_piece=_alter(every))
    assert not res["correct"], res["checks"]


#: steps the control runs in each cell: the steps a run's longest release
#: reaches, where the cell's limits were set
CONTROL_STEPS = {"nemo-orca12.global-rk4": 288, "cmems-glo-phy-024.global-rk4": 336}


@pytest.mark.parametrize("name", sorted(CONTROL_STEPS))
def test_the_bfloat16_control_is_not_correct(bench, name):
    """At the cell's own grid and steps, on 256 of its lanes."""
    from harness import check

    r = control.reading(bench, name, 31, steps=CONTROL_STEPS[name], lanes=256)
    assert not check.judge(r, check.limits(name))[0], r

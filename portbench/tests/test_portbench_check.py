"""The check's numbers on hand-made answers, and the window's host report."""

import numpy as np
import pytest

from harness import check, host


def _cols(x, y, deleted=None):
    n = len(x)
    return {"x": np.asarray(x, float), "y": np.asarray(y, float),
            "deleted": np.zeros(n, bool) if deleted is None else np.asarray(deleted)}


def test_numbers_of_a_program_equal_to_the_reference_are_nought():
    ref = _cols(np.linspace(0, 10, 200), np.zeros(200))
    prog = {"x": ref["x"].copy(), "y": ref["y"].copy(), "alive": np.ones(200, bool),
            "steps": np.full(200, 24)}
    n = check.numbers(prog, ref, ref, np.full(200, 24))
    assert n["gap_p95_m"] == n["gap_p99_m"] == n["calm_gap_max_m"] == 0.0
    assert n["calm_share"] == 1.0
    assert n["lanes_state_differ"] == n["clocks_differ"] == 0


def test_calm_lanes_hold_a_fault_in_a_few_lanes_and_not_a_restless_one():
    """A lane whose float32 twin parts from the reference is left out of
    the calm widest gap; a lane moved where its twin stays calm is not."""
    n = 200
    ref = _cols(np.linspace(0, 10, n), np.zeros(n))
    twin = _cols(ref["x"].copy(), ref["y"].copy())
    twin["x"][0] += 0.01                       # float32 carries lane 0 1.1 km off
    prog = {"x": ref["x"].copy(), "y": ref["y"].copy(), "alive": np.ones(n, bool),
            "steps": np.full(n, 24)}
    prog["x"][0] += 0.01                       # so the program's lane 0 is off too
    got = check.numbers(prog, ref, twin, np.full(n, 24))
    assert got["calm_gap_max_m"] == 0.0 and got["gap_max_m"] > 1000
    assert got["calm_share"] == pytest.approx((n - 1) / n)
    prog["y"][7] += 0.001                      # a calm lane moved 111 m
    got = check.numbers(prog, ref, twin, np.full(n, 24))
    assert got["calm_gap_max_m"] == pytest.approx(111.12, rel=1e-3)
    assert got["calm_gap_p99_m"] < 1.0         # one lane in 200 is under the 99th
    prog["y"][[20, 40, 60]] += 0.001           # four calm lanes in 200 moved
    got = check.numbers(prog, ref, twin, np.full(n, 24))
    assert got["calm_gap_p99_m"] == pytest.approx(111.12, rel=1e-3)


def test_a_deleted_lane_and_a_short_clock_are_counted():
    n = 10
    ref = _cols(np.zeros(n), np.zeros(n), deleted=[True] + [False] * (n - 1))
    prog = {"x": np.zeros(n), "y": np.zeros(n), "alive": np.ones(n, bool),
            "steps": np.array([24] * (n - 1) + [23])}
    got = check.numbers(prog, ref, ref, np.full(n, 24))
    assert got["lanes_state_differ"] == 1 and got["clocks_differ"] == 1


def test_the_window_reports_the_host():
    with host.Window(probe=False) as w:
        sum(range(100000))
    assert w.report["launch_us"] == (None, None)
    assert 0 < w.report["process_cores"] and w.report["gc_collections"] >= 0

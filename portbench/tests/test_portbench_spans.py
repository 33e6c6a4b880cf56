"""The readers of the program's spans and counters, on a synthetic traced
piece with known answers: gaps, sync ranges, launch calls, counter deltas."""

from types import SimpleNamespace

import numpy as np
import pytest

from harness import registry, spans

NAMES = ("host_syncs_per_step", "idle_after_sync_pct", "k2_plan_launches_per_step",
         "cgrid_stage_launches_per_step", "k2_overflow_pct")


def _piece(**changes):
    """A piece of 1000 ns on the card, 2^23 lanes (4 engine blocks), 48
    block-steps (12 set steps)."""
    host = [
        ("parcels.k2.plan", 5, 50), ("cudaLaunchKernel", 10, 11), ("cudaLaunchKernel", 20, 21),
        ("cudaMemcpyAsync", 30, 31), ("cudaLaunchKernel", 60, 61),
        ("parcels.sync.k2.plan", 90, 150),
        ("parcels.sample.cgrid", 195, 265), ("parcels.cgrid.stage", 200, 260),
        ("cudaLaunchKernel", 210, 211), ("cuLaunchKernel", 220, 221),
        ("parcels.cgrid.flush", 270, 280), ("cudaLaunchKernel", 275, 276),
        ("parcels.sync.engine.loop", 500, 600),
        ("parcels.k2.fixup", 800, 900), ("cuLaunchKernel", 820, 821),
    ]
    ctx = SimpleNamespace(
        span=(0, 1000), busy=[(0, 100), (300, 400), (700, 1000)],
        device=[("kernel", 0, 100), ("kernel", 300, 400), ("kernel", 700, 1000)],
        host=sorted(host, key=lambda h: h[1]),
        counters={"host_reads": 96, "block_steps": 48, "k2_lanes": 1000,
                  "k2_overflow_lanes": 25},
        run=SimpleNamespace(pos={"x": np.zeros(2**23)}))
    for k, v in changes.items():
        setattr(ctx, k, v)
    return ctx


def _read(name, ctx):
    return registry.module("metrics", name).read(ctx)


def test_the_readers_give_the_known_answers():
    ctx = _piece()
    assert spans.set_steps(ctx) == 12
    assert spans.idle_gaps(ctx) == [(100, 300), (400, 700)]
    assert _read("host_syncs_per_step", ctx) == 8.0
    # of 500 ns idle, the gap at 100 opens inside a read; the one at 400 does not
    assert _read("idle_after_sync_pct", ctx) == pytest.approx(40.0)
    # launch calls in the plan and the fix-up (not the copy, not the one at 60)
    assert _read("k2_plan_launches_per_step", ctx) == pytest.approx(3 / 12)
    assert _read("cgrid_stage_launches_per_step", ctx) == pytest.approx(3 / 12)
    assert _read("k2_overflow_pct", ctx) == pytest.approx(2.5)


def test_a_program_without_spans_or_counters_reports_nothing():
    ctx = _piece(counters={}, host=[h for h in _piece().host if not h[0].startswith("parcels.")])
    assert all(_read(name, ctx) is None for name in NAMES)
    # a piece with no device interval (on the CPU) reports nothing either
    ctx = _piece(device=[], busy=[])
    assert all(_read(name, ctx) is None for name in NAMES)


def test_the_program_counts_what_the_readers_read():
    counters = spans.program_counters()
    assert set(counters) == {"host_reads", "block_steps", "k2_lanes", "k2_overflow_lanes"}
    for name in NAMES:
        mod = registry.module("metrics", name)
        assert not hasattr(mod, "counters") or set(mod.counters()) == set(counters)

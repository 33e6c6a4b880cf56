"""Cells, mixes and metrics are found by name; a new one is only new files
and new BENCHMARK.json entries."""

import json
import shutil
import subprocess
import sys

from conftest import BENCH_DIR
from harness import registry


def test_every_name_in_benchmark_json_has_its_files():
    bench = registry.benchmark()
    for wl in bench["workloads"]:
        assert registry.config(bench, wl["config"])["name"] == wl["config"]
        assert registry.traffic(wl["traffic"])["kernels"]
        for kind in ("configs", "reference"):
            assert hasattr(registry.module(kind, wl["config"]), "build" if kind == "configs"
                           else "sampler")
        assert (BENCH_DIR / "limits" / f"{wl['name']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(registry.module("metrics", m["name"]), "read")


def test_metrics_of_a_cell_follow_their_workload_lists(bench):
    names = [m["name"] for m in registry.metrics(bench, "nemo-orca12.global-rk4", True)]
    assert "k5_roofline_pct" in names and "k2_roofline_pct" not in names
    names = [m["name"] for m in registry.metrics(bench, "nemo-orca12.global-rk4", False)]
    assert names == [m["name"] for m in bench["end_to_end"]]


def test_a_new_cell_is_new_files_only(tmp_path):
    """Copy the benchmark, add a mix, a metric, a cell, a kind of schedule
    and a reference scheme as new files and new entries, and find them all
    without touching an existing file."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    mix = json.loads((BENCH_DIR / "traffic" / "global-rk4-15min.json").read_text())
    mix["particles"] = 1 << 20
    (root / "portbench" / "traffic" / "global-rk4-small.json").write_text(json.dumps(mix))
    (root / "portbench" / "metrics" / "lanes_per_release.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    # a new kind of schedule and a new kernel's reference scheme, as files
    mix["schedule"] = {"kind": "once"}
    mix["kernels"] = ["AdvectionEE", "delete_oob"]
    (root / "portbench" / "traffic" / "global-ee-once.json").write_text(json.dumps(mix))
    (root / "portbench" / "harness" / "schedules" / "once.py").write_text(
        "def schedule(traffic, field_end_s):\n    yield 0.0, 3600.0, 3600.0\n")
    (root / "portbench" / "reference" / "schemes" / "AdvectionEE.py").write_text(
        "def run(traffic, sampler, lanes):\n    return {'scheme': 'EE'}\n")
    (root / "portbench" / "limits" / "cmems-glo-phy-024.global-rk4-small.json").write_text(
        '{"gap_p95_m": 1.0, "lanes_state_differ": 0, "clocks_differ": 0}')
    bench["workloads"].append({"name": "cmems-glo-phy-024.global-rk4-small",
                               "config": "cmems-glo-phy-024", "traffic": "global-rk4-small",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "lanes_per_release", "unit": "lanes", "better": "higher",
                               "source": "program_counter", "layer": "engine loop",
                               "moves": "particle_steps_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import sys
sys.path[:0] = [{str(root / 'portbench')!r}]
from harness import registry
b = registry.benchmark()
wl = registry.workload(b, "cmems-glo-phy-024.global-rk4-small")
assert registry.traffic(wl["traffic"])["particles"] == 1 << 20
names = [m["name"] for m in registry.metrics(b, wl["name"], True)]
assert "lanes_per_release" in names, names
assert registry.module("metrics", "lanes_per_release").read(None) == 1.0
from harness import release
from reference import integrate
ee = registry.traffic("global-ee-once")
assert next(release.schedule(ee, 1e6)) == (0.0, 3600.0, 3600.0)
assert integrate.for_mix(ee, None, {{}}) == {{"scheme": "EE"}}
print("found")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "found", out.stderr
    after = {p: p.read_bytes() for p in before}
    assert after == before

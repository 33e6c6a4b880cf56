"""Finds everything of a cell by the names in BENCHMARK.json.

A configuration is ``configs/<name>.json`` (its sizes, as run) with the
builder ``configs/<name>.py`` and the reference ``reference/<name>.py``
beside it; a traffic mix is ``traffic/<name>.json``; a metric is
``metrics/<name>.py``. What a mix names is found the same way: its
schedule (``harness/schedules/<kind>.py``), what it adds to the fieldset
(``harness/prepare/<key>.py``) and its reference scheme
(``reference/schemes/<first kernel>.py``). A later cell adds files and
entries; it edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder (``kind`` may be a
    path such as ``harness/schedules``), loaded by path."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        re.sub(r"[^0-9A-Za-z_]", "_", f"portbench_{kind}_{name}"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics(bench: dict, workload_name: str, traced: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if workload_name in m.get("workloads", [workload_name])]

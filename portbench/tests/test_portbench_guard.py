"""The check on loaded modules compares whole top-level names."""

import json
import subprocess
import sys

from conftest import BENCH_DIR, TINY
from harness import guard


def test_banned_names_are_compared_whole():
    assert guard.banned_modules(["parcels_tpu_torch", "parcels_tpu_torch.ops", "numpy"]) == []
    assert guard.banned_modules(["parcels_tpu", "parcels_tpu.ops"]) == ["parcels_tpu"]
    assert guard.banned_modules(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    """A whole run of a cell (on the CPU, in a fresh process) leaves neither
    JAX nor the JAX package in sys.modules."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(BENCH_DIR.parent)!r}]
import run
from harness import guard, registry
name = "cmems-glo-phy-024.global-rk4"
res = run.measure(registry.benchmark(), name, 7, 0.5, False, "cpu", time.perf_counter(),
                  overrides={json.dumps(TINY["cmems-glo-phy-024.global-rk4"])})
print(json.dumps({{"banned": guard.banned_modules(), "correct": res["correct"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout.strip().splitlines()[-1]
    assert json.loads(out) == {"banned": [], "correct": True}


def test_run_refuses_without_a_card():
    """Without a card a run exits with an error and prints no result."""
    proc = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                           "nemo-orca12.global-rk4", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

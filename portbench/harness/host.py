"""What the host did around a run's window, for standard error.

The cells are bound by the host's launches and reads (PERF.md), so a
window's rate follows the speed of the host's core. ``launch_us`` times the
host's side of a run of tiny launches just before and just after the
window: the speed of the host as the program's eager loop meets it. Beside
it: the cores the process kept busy, its threads, the garbage collector's
collections, the clock the host reports and the card's clocks, power and
throttle reasons as the window closes.
"""

from __future__ import annotations

import gc
import os
import time


def launch_us(n: int = 4000):
    """Host microseconds a launch over ``n`` launches of a one-element add
    on the card (None without one)."""
    import torch

    if not torch.cuda.is_available():
        return None
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return round(us, 3)


def card_state():
    """The card's clocks, power, temperature and active throttle reasons
    as nvidia-smi reads them (None where it cannot)."""
    import subprocess

    q = "clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active"
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _mhz():
    try:
        with open("/proc/cpuinfo") as f:
            vals = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        return round(sum(vals) / len(vals), 1) if vals else None
    except OSError:
        return None


def _gcs():
    return sum(s["collections"] for s in gc.get_stats())


class Window:
    """Context manager around the measured window; ``report`` after it."""

    def __init__(self, probe: bool = True):
        self.probe = probe
        self.report = {}

    def __enter__(self):
        self.us0 = launch_us() if self.probe else None
        self.gc0, self.mhz0 = _gcs(), _mhz()
        self.t0, self.cpu0 = time.perf_counter(), time.process_time()
        return self

    def __exit__(self, *exc):
        cpu, wall = time.process_time() - self.cpu0, time.perf_counter() - self.t0
        self.report = {
            "launch_us": (self.us0, launch_us() if self.probe else None),
            "process_cores": round(cpu / max(wall, 1e-9), 3),
            "threads": len(os.listdir("/proc/self/task")) if os.path.isdir("/proc/self/task")
            else None,
            "gc_collections": _gcs() - self.gc0,
            "mhz": (self.mhz0, _mhz()),
            "card": card_state() if self.probe else None,
        }
        return False

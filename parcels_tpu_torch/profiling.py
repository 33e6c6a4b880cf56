"""Profiling / tracing hooks, mapped to ``torch.profiler``.

The JAX package exposes ``jax.profiler``; the port keeps its two names:

- ``trace(logdir)``: context manager profiling the enclosed block (CPU
  activity, and CUDA activity where a card is present) and writing a
  Chrome/Perfetto trace (``trace.json``) into ``logdir``.
- ``annotate(name)``: named region (``torch.profiler.record_function``)
  that shows up inside the trace.
- ``ParticleSet.last_run_stats``: per-execute dict with wall time, chunk
  count and particle-steps/s (populated by every ``execute`` call).
- ``FieldSet.window_stats``: windowed-streaming load/byte counters.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["annotate", "trace"]


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profile the enclosed block and write ``logdir/trace.json``.

    The trace file opens in Perfetto or ``chrome://tracing`` as it is;
    ``create_perfetto_link`` keeps the JAX package's signature, and True
    raises ``NotImplementedError``: the port serves no link. The profiler
    object is yielded, so callers can read ``key_averages()``.
    """
    if create_perfetto_link:
        raise NotImplementedError(
            "create_perfetto_link: no link is served; open logdir/trace.json in Perfetto"
        )
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named trace region: ``with annotate("rk4 chunk"): ...``."""
    return torch.profiler.record_function(name)

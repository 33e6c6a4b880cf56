"""Profiling / tracing hooks, mapped to ``torch.profiler``.

The JAX package exposes ``jax.profiler``; the port keeps its two names:

- ``trace(logdir)``: context manager profiling the enclosed block (CPU
  activity, and CUDA activity where a card is present) and writing a
  Chrome/Perfetto trace (``trace.json``) into ``logdir``. The trace holds
  the program's own ``parcels.*`` spans (below) beside torch's operations
  and the card's kernels.
- ``annotate(name)``: named region that shows up inside the trace; the
  same as ``span``.
- ``ParticleSet.last_run_stats``: per-execute dict with wall time, chunk
  count and particle-steps/s (counted from the lanes' own clocks).
- ``FieldSet.window_stats``: windowed-streaming load/byte counters.

Spans. ``span(name)`` records a ``torch.profiler.record_function`` range
only while a torch profiler is recording (under ``trace``, or any other
``torch.profiler.profile``); otherwise it returns one shared no-op context
and calls nothing. A range sits on the profiler's host timeline, the clock
the card's kernels are stamped on, so an idle gap of the card can be set
against the span open at its start; the enclosing range is its parent.
The program's spans, from the entry point down:

- ``parcels.execute`` (one ``ParticleSet.execute`` call) >
  ``parcels.execute.chunk`` (one output-interval chunk), with
  ``parcels.execute.drain`` (the deferred error-flag read),
  ``parcels.execute.output`` (a snapshot queued for the file),
  ``parcels.window.load`` and ``parcels.window.prefetch`` (time windows);
- ``parcels.engine.setup`` (field views, cell tables, the sort decision),
  ``parcels.engine.sort``, ``parcels.engine.unsort``,
  ``parcels.engine.block`` > ``parcels.engine.step`` >
  ``parcels.kernel.<kernel name>`` (each call of the chain, Repeat rounds
  included) and ``parcels.engine.update`` (position, clock and state);
- ``parcels.sample.<tier>``: the interpolator's dispatch, ``k1``, ``k2``,
  ``gather``, ``cgrid`` (the C-grid stage cache) or ``ux`` (the UGRID
  cache);
- ``parcels.k2.plan``, ``parcels.k2.kernel``: K2's plan (when built) and
  its kernel;
- ``parcels.cgrid.stage``, ``parcels.cgrid.flush``: a C-grid stage
  (brackets, the K5 call, the blend) and the cache's write-back;
- ``parcels.rng.draw``: one counter-based random draw;
- ``parcels.sync.<site>``: one synchronizing read (or upload) of the host.

Counters, plain integers that are always on and never reset (read them
before and after the work of interest):

- ``host_reads``: synchronizing host transfers on the main path, by site
  (``sync``); a site's span is ``parcels.sync.<site>``;
- ``block_steps``: ``engine_step`` calls (a set step of B blocks counts B);
- ``k2_lanes``, ``k2_overflow_lanes``: each K2 call's lanes, and those of
  them that K2 read partly from device memory (a corner outside their
  window). K2 adds the overflow lanes in place to a counter on its device
  (``k2_overflow_counter``), with no host read; ``counters()`` reads them.

The launch counters of the kernel wrappers (``fold_sample.launches``,
``slab_sample.launches``, ``cgrid_repair.launches``, ...) and the stage
caches' (``stagecache.cgrid_cached_eval``, ``uxcache.ux_cached_eval``) stay
where they are.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["annotate", "counters", "k2_overflow_counter", "span", "sync", "trace"]

#: synchronizing host transfers on the main path, by site
host_reads: dict[str, int] = {}
#: engine_step calls
block_steps = 0
#: lanes of every K2 call
k2_lanes = 0
#: by device, the one-element int64 tensor K2 adds its overflow lanes to
_k2_overflow: dict = {}

_OFF = contextlib.nullcontext()


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


def span(name: str, suffix: str = ""):
    """Named range ``name + suffix`` on the profiler's host timeline while a
    torch profiler records; a shared no-op context otherwise (the name is
    then not even joined)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name + suffix)


def annotate(name: str):
    """Named trace region: ``with annotate("rk4 chunk"): ...``."""
    return span(name)


def sync(site: str):
    """Count one synchronizing host transfer at ``site`` and return the
    ``parcels.sync.<site>`` span to do it in:
    ``with profiling.sync("engine.loop"): go = bool(flag)``."""
    host_reads[site] = host_reads.get(site, 0) + 1
    return span("parcels.sync.", site)


def k2_overflow_counter(device) -> torch.Tensor:
    """The counter on ``device`` that K2 adds the lanes it reads partly from
    device memory to (a one-element int64 tensor, made at first use)."""
    counter = _k2_overflow.get(device)
    if counter is None:
        counter = _k2_overflow[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return counter


def counters() -> dict:
    """The counters now: ``host_reads`` (all sites), ``block_steps``,
    ``k2_lanes``, ``k2_overflow_lanes`` (reading K2's counters on their
    devices)."""
    return {"host_reads": sum(host_reads.values()), "block_steps": block_steps,
            "k2_lanes": k2_lanes,
            "k2_overflow_lanes": sum(int(c) for c in _k2_overflow.values())}

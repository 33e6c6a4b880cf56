"""The traced piece: a torch.profiler window over one steady ``execute``
call, the counters the metrics read before and after it, and the reduction
of its events to intervals.

Device activity is the union of kernel, copy and set intervals (so
overlapping streams count once), clipped to the host-clock span of the
benchmark's own ``portbench.traced`` annotation around the call.
"""

from __future__ import annotations

import bisect
import time

import torch

ANNOTATION = "portbench.traced"


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class Session:
    """Context manager over one traced piece; metric modules read it."""

    def __init__(self, metric_mods: dict, run, piece_s: float):
        self.mods = metric_mods
        self.run = run
        self.steps = int(round(piece_s / run.dt))
        self.extra = {}

    def _counters(self):
        vals = {}
        for mod in self.mods.values():
            if hasattr(mod, "counters"):
                vals.update(mod.counters())
        return vals

    def __enter__(self):
        self.c0 = self._counters()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.ann = torch.profiler.record_function(ANNOTATION)
        self.ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self.t0
        self.ann.__exit__(*exc)
        self.prof.__exit__(*exc)
        c1 = self._counters()
        self.counters = {k: c1[k] - self.c0[k] for k in c1}
        self._reduce()
        return False

    def after(self, run, pset):
        """Per-metric work on the state the traced piece left, after the
        profiler has stopped."""
        for name, mod in self.mods.items():
            if hasattr(mod, "after"):
                self.extra[name] = mod.after(run, pset)

    def _reduce(self):
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            s = _ns(e, "start")
            rec = (e.name(), s, s + _ns(e, "duration"))
            (host if e.device_type() == torch.autograd.DeviceType.CPU else dev).append(rec)
        # the profiler mirrors host annotations onto the device timeline;
        # they are ranges, not device work
        names = {h[0] for h in host}
        dev = [d for d in dev if d[0] not in names]
        spans = [h for h in host if h[0] == ANNOTATION]
        self.span = (spans[0][1], spans[0][2]) if spans else (0, 0)
        s0, s1 = self.span
        self.device = sorted((n, max(a, s0), min(b, s1)) for n, a, b in dev if b > s0 and a < s1)
        self.device.sort(key=lambda r: r[1])
        self.host = sorted(host, key=lambda r: r[1])
        self.busy = union(self.device)

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernels(self, *names):
        """Device intervals whose names contain any of ``names``."""
        return [r for r in self.device if any(n in r[0] for n in names)]

    def breakdown(self, top: int = 10) -> dict:
        ops = {}
        for n, a, b in self.device:
            ops[n] = ops.get(n, 0) + (b - a)
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.span[0]
        for a, b in self.busy + [(self.span[1], self.span[1])]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, ns / 1e9] for n, ns in device_ops],
                "idle_gaps": [[self.label(g0), (g1 - g0) / 1e9] for g0, g1 in gaps]}

    def label(self, t_ns) -> str:
        """The innermost host annotation or op open at ``t_ns``: of the host
        events that contain it, the one that started last."""
        if not hasattr(self, "_starts"):
            self._starts = [a for _, a, _ in self.host]
        k = bisect.bisect_right(self._starts, t_ns) - 1
        while k >= 0:
            name, a, b = self.host[k]
            if b > t_ns and name != ANNOTATION:
                return name
            k -= 1
        return "outside any host op"

def union(intervals):
    merged = []
    for _, a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]

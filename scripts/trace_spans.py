"""Break one steady ``execute`` of a benchmark cell down by the program's
own ``parcels.*`` spans, on the card.

    python3 scripts/trace_spans.py --workload <cell> --seed <n> [--out chiprun_out]

The cell is set up as ``portbench/run.py`` sets it up (same configuration,
mix, seed and warm-up). Its first release then runs three pieces (one
``execute`` call each): the cold first, then

1. a steady piece under ``torch.cuda.set_sync_debug_mode("warn")``: the
   synchronizing calls torch reports, by the program's call site, against
   the program's ``profiling.host_reads`` over the same call;
2. a steady piece traced as ``--trace 1`` traces it
   (``harness.tracing.Session``): for each span name its calls, host ms a
   set step (whole and self), kernel launches and synchronizing transfers
   a set step (each charged to the innermost span around it), and the
   device-idle ms a step in gaps opening inside it; whether every K2 and
   K5 kernel was launched inside its span; the longest idle gaps with the
   innermost span open at their start; the cell's per-layer metrics;
3. the host cost of a span, and of a counted transfer, with no profiler
   recording, and of a span while one records.

Prints a summary and writes ``<out>/trace_spans.<cell>.json``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import timeit
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "portbench")]

#: device kernels and the span each must be launched in
LAUNCHED_IN = {"slab_sample_kernel": "parcels.k2.kernel",
               "check_kernel": "parcels.cgrid.stage", "search_kernel": "parcels.cgrid.stage",
               "stage_prologue_kernel": "parcels.cgrid.stage",
               "stage_epilogue_kernel": "parcels.cgrid.stage"}
OUTSIDE = "outside any parcels span"


def innermost(spans, points):
    """For each time in ``points``, the index of the innermost span of
    ``spans`` ((name, start, end), properly nested) open at it, or None."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    out, stack, k = [None] * len(points), [], 0
    for i in order:
        t = points[i]
        while k < len(spans) and spans[k][1] <= t:
            while stack and spans[stack[-1]][2] <= spans[k][1]:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and spans[stack[-1]][2] <= t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def sync_sites(torch, run, pset, piece):
    """One ``execute`` under the sync debug mode "warn": (torch's count,
    the program's host_reads delta, torch's count by call site)."""
    from parcels_tpu_torch import profiling

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1] if "parcels_tpu_torch" in f.filename]
        where = frames[::-1][:3] or traceback.extract_stack()[:-1][::-1][:6]
        sites[" < ".join(f"{Path(f.filename).name}:{f.lineno}:{f.name}" for f in where)] += 1

    before = dict(profiling.host_reads)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run._execute(pset, piece)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    delta = {k: v - before.get(k, 0) for k, v in profiling.host_reads.items()
             if v != before.get(k, 0)}
    return sum(sites.values()), delta, dict(sites.most_common())


def program_spans(ctx):
    """The program's ``parcels.*`` spans (name, start, end), in start order,
    an enclosing span before the spans it holds."""
    return sorted((h for h in ctx.host if h[0].startswith("parcels.")),
                  key=lambda s: (s[1], -s[2]))


def breakdown(ctx, steps):
    """Per span name: calls and, a set step, host ms (whole, self), launches
    and synchronizing transfers (self and whole) and idle ms (self)."""
    from harness import spans as hs

    spans = program_spans(ctx)
    # the parent of a span: the innermost span opened before it and still open
    parent, stack = [], []
    for k, (_, a, b) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= a:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(k)
    rows = collections.defaultdict(lambda: collections.Counter())
    child_ns = collections.Counter()
    for k, (name, a, b) in enumerate(spans):
        rows[name]["calls"] += 1
        rows[name]["ns"] += b - a
        if parent[k] is not None:
            child_ns[parent[k]] += b - a
    for k, (name, a, b) in enumerate(spans):
        rows[name]["self_ns"] += (b - a) - child_ns[k]

    def ancestors(k):
        while k is not None:
            yield k
            k = parent[k]

    launches = [a for n, a, _ in ctx.host if n.startswith(hs.LAUNCH)]
    for k in innermost(spans, launches):
        name = spans[k][0] if k is not None else OUTSIDE
        rows[name]["launches_self"] += 1
        for j in ancestors(k):
            rows[spans[j][0]]["launches"] += 1
    for k, (name, a, b) in enumerate(spans):
        if name.startswith(hs.SYNC):
            for j in ancestors(parent[k]):
                rows[spans[j][0]]["syncs"] += 1
    gaps = hs.idle_gaps(ctx)
    for (g0, g1), k in zip(gaps, innermost(spans, [g[0] for g in gaps])):
        rows[spans[k][0] if k is not None else OUTSIDE]["idle_ns"] += g1 - g0
    table = {}
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["self_ns"]):
        table[name] = {"calls": r["calls"], "ms": r["ns"] / 1e6 / steps,
                       "self_ms": r["self_ns"] / 1e6 / steps,
                       "launches": r["launches"] / steps,
                       "self_launches": r["launches_self"] / steps,
                       "syncs": r["syncs"] / steps, "idle_after_ms": r["idle_ns"] / 1e6 / steps}
    longest = sorted(zip(gaps, innermost(spans, [g[0] for g in gaps])),
                     key=lambda gk: gk[0][0] - gk[0][1])[:5]
    named_gaps = [[spans[k][0] if k is not None else OUTSIDE, (g1 - g0) / 1e9]
                  for (g0, g1), k in longest]
    return table, named_gaps, len(spans)


def launched_in(torch, ctx):
    """For each kernel of LAUNCHED_IN: (device launches, launches found on
    the host, found inside the span named for it)."""
    from harness import spans as hs
    from harness.tracing import _ns

    events = list(ctx.prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    host_launch = {e.correlation_id(): _ns(e, "start") for e in events
                   if e.device_type() == cpu and e.name().startswith(hs.LAUNCH)}
    out = {}
    for kernel, span in LAUNCHED_IN.items():
        within = hs.named(ctx, span)
        dev = [e for e in events if e.device_type() != cpu and kernel in e.name()]
        ids = [next((i for i in (e.correlation_id(), e.linked_correlation_id())
                     if i in host_launch), None) for e in dev]
        found = [host_launch[i] for i in ids if i is not None]
        out[kernel] = {"span": span, "device": len(dev), "host_launch_found": len(found),
                       "inside": sum(hs.inside(within, t) for t in found)}
    return out


def device_ops_by_span(torch, ctx, top=6):
    """For each span name: the device seconds of the ops launched with it
    as the innermost span, the ``top`` longest by op name (each device
    event found by its host launch's correlation id)."""
    from harness import spans as hs
    from harness.tracing import _ns

    events = list(ctx.prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    host_launch = {e.correlation_id(): _ns(e, "start") for e in events
                   if e.device_type() == cpu and e.name().startswith(hs.LAUNCH)}
    s0, s1 = ctx.span
    annotations = {h[0] for h in ctx.host}  # mirrored onto the device timeline
    dev = []
    for e in events:
        if e.device_type() == cpu or e.name() in annotations:
            continue
        a = _ns(e, "start")
        b = a + _ns(e, "duration")
        t = next((host_launch[i] for i in (e.correlation_id(), e.linked_correlation_id())
                  if i in host_launch), None)
        if t is not None and b > s0 and a < s1:
            dev.append((e.name(), (min(b, s1) - max(a, s0)) / 1e9, t))
    spans = program_spans(ctx)
    acc = collections.defaultdict(collections.Counter)
    for (name, sec, _), k in zip(dev, innermost(spans, [d[2] for d in dev])):
        acc[spans[k][0] if k is not None else OUTSIDE][name] += sec
    return {span: {"device_s": sum(ops.values()),
                   "top": [[n, s] for n, s in ops.most_common(top)]}
            for span, ops in sorted(acc.items(), key=lambda kv: -sum(kv[1].values()))}


def span_cost(torch):
    """Microseconds of ``with span(...)`` and ``with sync(...)`` with no
    profiler recording, and of ``with span(...)`` while one records."""
    from parcels_tpu_torch import profiling

    def span():
        with profiling.span("parcels.engine.step"):
            pass

    def sync():
        with profiling.sync("cost.probe"):
            pass

    n = 200_000
    us = [timeit.timeit(f, number=n) / n * 1e6 for f in (span, sync)]
    profiling.host_reads.pop("cost.probe", None)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = timeit.timeit(span, number=n // 10) / (n // 10) * 1e6
    return {"span_us": us[0], "sync_us": us[1], "span_on_us": on}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)

    import torch

    from harness import registry, release, tracing
    from harness import spans as hs
    from harness.window import Run

    if not torch.cuda.is_available():
        sys.exit("trace_spans: no CUDA card")
    bench = registry.benchmark()
    t0 = time.perf_counter()
    run = Run(bench, args.workload, args.seed, "cuda")
    run.setup()
    setup_s = time.perf_counter() - t0
    entries = registry.metrics(bench, args.workload, True)
    mods = {m["name"]: registry.module("metrics", m["name"]) for m in entries}
    start, _, piece = next(release.schedule(run.traffic, run.field_end_s))
    pset = run._release(start)
    run._execute(pset, piece)
    torch.cuda.synchronize()
    warned, reads, sites = sync_sites(torch, run, pset, piece)
    torch.cuda.synchronize()
    with tracing.Session(mods, run, piece) as ctx:
        run._execute(pset, piece)
    ctx.after(run, pset)
    steps = hs.set_steps(ctx) or ctx.steps
    table, gaps, n_spans = breakdown(ctx, steps)
    cost = span_cost(torch)
    res = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "setup_s": setup_s,
        "sync_check": {"torch_warned": warned, "host_reads": sum(reads.values()),
                       "host_reads_by_site": reads, "torch_by_call_site": sites},
        "traced": {"host_s": ctx.host_s, "window_s": ctx.window_s, "busy_s": ctx.busy_s,
                   "set_steps": steps, "piece_steps": ctx.steps, "counters": ctx.counters},
        "metrics": {m["name"]: mods[m["name"]].read(ctx) for m in entries},
        "launched_in_span": launched_in(torch, ctx),
        "device_ops_by_span": device_ops_by_span(torch, ctx),
        "longest_idle_gaps": gaps,
        "span_cost": {**cost, "spans_per_step": n_spans / steps,
                      "off_us_per_step": n_spans / steps * cost["span_us"],
                      "on_us_per_step": n_spans / steps * cost["span_on_us"]},
        "spans": table,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"trace_spans.{args.workload}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "spans"}, indent=1))
    print(f"{'span':48s} {'calls':>6s} {'ms/step':>9s} {'self ms':>9s} {'launch':>8s} "
          f"{'self':>8s} {'syncs':>6s} {'idle ms':>8s}")
    for name, r in table.items():
        print(f"{name:48s} {r['calls']:6d} {r['ms']:9.3f} {r['self_ms']:9.3f} "
              f"{r['launches']:8.1f} {r['self_launches']:8.1f} {r['syncs']:6.2f} "
              f"{r['idle_after_ms']:8.3f}")


if __name__ == "__main__":
    main()

"""Runs one cell of the benchmark of parcels_tpu_torch once and prints its
result as the last line of standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiler trace of one
steady ``execute`` call. Every run checks what its timed path produced
against the plain reference (``portbench/reference``) and prints each
number compared beside its limit, last on standard error and last in the
result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(BENCH_DIR)]

from harness import guard  # noqa: E402

#: lanes the check compares at most, over all the window's releases
CHECK_CAP = 4096


class WindowContext:
    """What the end-to-end metrics read."""

    def __init__(self, run, window_s, setup_s, peak_bytes):
        self.work_steps, self.window_s = run.work_steps, window_s
        self.setup_s, self.peak_bytes = setup_s, peak_bytes


def measure(bench, name, seed, seconds, traced, device, t_process, overrides=None,
            after_piece=None, cap=CHECK_CAP, limits=None):
    """Set up, measure and check one run of cell ``name``; returns the
    result dict (without the card-specific ``device`` entries). ``limits``
    replaces the cell's own (``limits/<name>.json``)."""
    import torch

    from harness import check, registry, tracing
    from harness.window import Run

    cuda = torch.device(device).type == "cuda"
    run = Run(bench, name, seed, device, overrides)
    run.setup()
    setup_s = time.perf_counter() - t_process
    entries = registry.metrics(bench, name, traced)
    mods = {m["name"]: registry.module("metrics", m["name"]) for m in entries}
    session = (lambda piece: tracing.Session(mods, run, piece)) if traced else None
    window_s = run.window(seconds, session, after_piece)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = run.traced if traced else WindowContext(run, window_s, setup_s, peak)
    metrics = {}
    for m in entries:
        value = mods[m["name"]].read(ctx) if ctx is not None else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = {}
    if traced and ctx is not None:
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s,
                 "breakdown": ctx.breakdown()}
    # the program's state goes before the reference runs (on the host)
    del run.fs, ctx
    run.traced = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(run, cap)
    check_s = time.perf_counter() - t_check
    correct, checks = check.judge(numbers, limits or check.limits(name))
    n = int(run.pos["x"].size)
    return {
        "correct": correct,
        "attempted": n * len(run.answers),
        "failed": int(run.failed),
        "metrics": metrics,
        "peak": peak,
        "extra": extra,
        "compared": numbers,
        "checks": checks,
        "piece_s": run.piece_s,
        "host": run.host,
        "check_s": check_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    found = guard.banned_modules()
    if found:
        sys.exit(f"modules of JAX or the JAX package are loaded: {found}")
    import torch

    from harness import registry

    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    guard.require_cards(torch, wl["chips"])
    torch.cuda.reset_peak_memory_stats()
    print(f"card: {guard.card_line(torch)}", flush=True)

    res = measure(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                  T_PROCESS)
    found = guard.banned_modules()
    if found:
        sys.exit(f"modules of JAX or the JAX package were loaded by the run: {found}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": wl["chips"],
              "memory_peak_bytes": int(res["peak"])}
    device.update({k: res["extra"][k] for k in ("busy_s", "window_s") if k in res["extra"]})
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if "breakdown" in res["extra"]:
        out["breakdown"] = res["extra"]["breakdown"]
    out["compared"] = res["compared"]
    out["checks"] = res["checks"]
    print(f"execute calls (s): {res['piece_s']}", file=sys.stderr)
    print(f"host around the window: {json.dumps(res['host'])}", file=sys.stderr)
    print(f"reference check (s): {res['check_s']:.1f}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

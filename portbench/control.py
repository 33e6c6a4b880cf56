"""The control of the correctness check, kept apart from the benchmark's
runs: the plain reference with the velocity sampled in bfloat16 (the
field's node or face values, the interpolation weights and their blend),
put in the program's place and judged by the same numbers against the
float64 reference and its float32 twin. bfloat16 is the step below the
configurations' float32 that the check is held against (the type a field
would be stored in to halve its bytes); ``--dtype float16`` reads the same
with the velocity sampled in float16.

    python3 portbench/control.py --workload <name> --steps <n> --seeds <s1> <s2> ...

It runs the cell's own release, at the cell's own size, on the lanes the
cell's check draws (``harness.cell``), for ``--steps`` steps (the steps a
run's longest release reaches), and prints one JSON line a seed. The
reference runs on the host, as in the benchmark's runs. Where the run is
correct the control is not: its numbers are the upper readings of the
cell's limits.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, registry  # noqa: E402
from harness.cell import Cell  # noqa: E402


def reading(bench, workload_name, seed, steps, lanes=None, overrides=None,
            dtype=torch.bfloat16) -> dict:
    from harness import release

    cell = Cell(bench, workload_name, overrides)
    pos = cell.positions(seed)
    ids = cell.check_lanes(pos["x"].size, seed, lanes)
    end_s = (cell.cfg["frames"] - 1) * cell.cfg["frame_hours"] * 3600.0
    start = next(release.schedule(cell.traffic, end_s))[0]
    out = check.reference(cell, pos, seed, ids, start, steps, dtypes=(torch.float64, dtype))
    low = out[str(dtype).split(".")[-1]]
    prog = {"x": low["x"], "y": low["y"], "steps": low["steps"], "alive": ~low["deleted"]}
    target = np.full(ids.size, steps)
    return {"seed": seed, "steps": steps, "dtype": str(dtype).split(".")[-1],
            **check.numbers(prog, out["ref"], out["twin"], target)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16"))
    args = ap.parse_args()
    bench = registry.benchmark()
    lim = check.limits(args.workload)
    for seed in args.seeds:
        r = reading(bench, args.workload, seed, args.steps, dtype=getattr(torch, args.dtype))
        r["correct"] = check.judge(r, lim)[0]
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

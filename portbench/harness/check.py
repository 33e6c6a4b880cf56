"""The comparison that decides ``correct``.

After the window has closed, the sampled lanes of the release the window
ran longest (and, up to ``cap``, of the others) are integrated again by the
plain reference from their release positions and times, for the steps
their release reached, and compared with what the program's timed path
left in them. The program holds positions in float32, as the
configurations state: the reference starts from the release positions
rounded to float32. It works out its grid, coast and currents itself and
reads nothing the program made but these answers.

Each lane is integrated twice in one batch: in float64, the reference,
and as its float32 twin (``reference.integrate``), the same scheme with
the particle state held in float32. Where the twin parts from the float64
run, float32 state alone carries the lane that far: a lane that rides a
C-grid cell edge, where the tangential velocity jumps, a slow lane whose
displacement float32 rounds the same way step after step, or a lane in
strong strain. Those lanes are the tail of the program's gaps.

Numbers compared, each with its limit in ``limits/<workload>.json``:

- ``calm_gap_p99_m``: the 99th percentile of the distance between the
  program's and the reference's positions over the calm lanes, those alive
  in both whose float32 twin ends within ``CALM_M`` of the reference: a
  fault in one lane of a hundred or more shows here, whatever float32
  does to the restless lanes;
- ``lanes_state_differ``: lanes alive in one and deleted (or in an error
  state) in the other;
- ``clocks_differ``: lanes alive in both whose clocks did not reach the
  release's last time.

Reported beside them: the widest gap over the calm lanes and over all
lanes, the 95th and 99th percentiles over all lanes, the share of calm
lanes and the twin's own gaps. None of these separates sound runs from
the control by the factor of three a limit needs (PERF.md).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from harness import registry
from reference import inputs, integrate

#: a lane is calm where its float32 twin ends this close to the reference
CALM_M = 10.0


def limits(workload_name: str) -> dict:
    with open(registry.BENCH_DIR / "limits" / f"{workload_name}.json") as f:
        return json.load(f)


def pairs(answers: list, seed: int, cap: int):
    """(release index, lane index into the release) pairs to compare: every
    sampled lane of the release that ran longest, then, up to ``cap``, a
    share drawn from the seed of the others."""
    order = sorted(range(len(answers)),
                   key=lambda k: -(answers[k]["reached_s"] - answers[k]["start_s"]))
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 4]))
    out = [(order[0], j) for j in range(answers[order[0]]["particle_id"].size)]
    rest = [(k, j) for k in order[1:] for j in range(answers[k]["particle_id"].size)]
    room = max(cap - len(out), 0)
    if rest and room:
        pick = rng.choice(len(rest), min(room, len(rest)), replace=False)
        out += [rest[p] for p in np.sort(pick)]
    return out


def reference(cell, pos: dict, seed: int, ids, start_s, steps, dtypes=(torch.float64,)):
    """The reference over lanes ``ids`` of a release at ``pos`` (float64
    positions; started from their float32 roundings) released at
    ``start_s`` and run ``steps``: {"ref": float64, "twin": its float32
    twin} and, for each further dtype of ``dtypes``, the float32 twin with
    the velocity sampled in that type (the control), all as numpy
    columns."""
    ids = np.asarray(ids)
    n = ids.size
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32).astype(np.float64)
    lanes = {"x": f32(pos["x"][ids]), "y": f32(pos["y"][ids]), "z": pos["z"][ids],
             "t0": np.broadcast_to(np.asarray(start_s, np.float64), (n,)),
             "steps": np.broadcast_to(np.asarray(steps), (n,)), "ids": ids, "seed": seed % 2**63}
    out = {}
    for dtype in dtypes:
        twins = dtype == torch.float64
        run = {k: (np.concatenate([v, v]) if twins and isinstance(v, np.ndarray) else v)
               for k, v in lanes.items()}
        # the twins' half, and a control's every lane, hold their state in
        # float32 as the program does
        run["f32"] = np.arange(2 * n) >= n if twins else np.ones(n, bool)
        res = integrate.for_mix(cell.traffic, cell.ref.sampler(cell.cfg, seed, dtype), run)
        res = {k: v.numpy() for k, v in res.items()}
        if twins:
            out["ref"] = {k: v[:n] for k, v in res.items()}
            out["twin"] = {k: v[n:] for k, v in res.items()}
        else:
            out[str(dtype).split(".")[-1]] = res
    return out


def gap_m(x1, y1, x2, y2):
    dx = (np.asarray(x1, np.float64) - x2) * inputs.DEG2M * np.cos(np.deg2rad(y2))
    dy = (np.asarray(y1, np.float64) - y2) * inputs.DEG2M
    return np.hypot(dx, dy)


def numbers(prog: dict, ref: dict, twin: dict, target) -> dict:
    """The numbers of the comparison of ``prog`` (columns x, y, alive,
    steps) with the reference ``ref`` and its twin over the same lanes."""
    ref_alive = ~ref["deleted"]
    both = ref_alive & prog["alive"]
    gaps = gap_m(prog["x"], prog["y"], ref["x"], ref["y"])
    twin_gaps = gap_m(twin["x"], twin["y"], ref["x"], ref["y"])
    calm = both & ~twin["deleted"] & (twin_gaps <= CALM_M)

    def q(a, p):
        return float(np.quantile(a, p)) if a.size else 0.0

    return {
        "calm_gap_p99_m": q(gaps[calm], 0.99),
        "calm_gap_max_m": q(gaps[calm], 1.0),
        "gap_p95_m": q(gaps[both], 0.95),
        "gap_p99_m": q(gaps[both], 0.99),
        "gap_median_m": q(gaps[both], 0.5),
        "gap_max_m": q(gaps[both], 1.0),
        "calm_share": float(calm.sum() / max(both.sum(), 1)),
        "twin_gap_p99_m": q(twin_gaps[both], 0.99),
        "twin_gap_max_m": q(twin_gaps[both], 1.0),
        "lanes_state_differ": int((ref_alive != prog["alive"]).sum()),
        "clocks_differ": int((prog["steps"][both] != np.asarray(target)[both]).sum()),
        "lanes_compared": int(both.size),
        "steps_longest": int(np.max(target)) if np.size(target) else 0,
    }


def compare(run, cap: int):
    """The numbers compared, as {name: value}."""
    chosen = pairs(run.answers, run.seed, cap)
    col = lambda c: np.array([run.answers[k][c][j] for k, j in chosen])
    ids = col("particle_id").astype(np.int64)
    start = np.array([run.answers[k]["start_s"] for k, _ in chosen])
    target = np.array([round((run.answers[k]["reached_s"] - run.answers[k]["start_s"]) / run.dt)
                       for k, _ in chosen])
    out = reference(run.cell, run.pos, run.seed, ids, start, target)
    prog = {"x": col("x"), "y": col("y"), "steps": col("steps"),
            "alive": col("_active").astype(bool) & (col("state") < 50)}
    return numbers(prog, out["ref"], out["twin"], target)


def judge(numbers: dict, lim: dict):
    """(correct, the compared numbers each beside its limit)."""
    checks = {name: {"value": numbers[name], "limit": lim[name]} for name in lim}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok), checks

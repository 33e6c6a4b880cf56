#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's first slice, on one CUDA card.

Runs the two end-to-end paths of ``chip_smoke.py`` under ``torch.profiler``
(CPU and CUDA activities) after one warm-up run each, and prints for each:
particle-steps per second, the wall time of ``execute`` per step, the device
busy share (sum of kernel and copy time over that wall time, the profiler's
own cost included), the host reads per step
(``aten::_local_scalar_dense``, one per ``.item()``/``bool()`` of a device
tensor) and the device time by kernel name.

    python3 scripts/profile_torch_slice.py [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_path(torch, tp, cs, fs, n, kernel, steps, seed, zrange=None):
    from torch.profiler import ProfilerActivity, profile

    cs.run_path(torch, tp, fs, n, kernel, 2 * 60, seed=seed, zrange=zrange)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, launches, stats = cs.run_path(torch, tp, fs, n, kernel, steps * 60, seed=seed,
                                         zrange=zrange)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, by_name, syncs = 0.0, {}, 0
    for ev in prof.key_averages():
        d = getattr(ev, "device_time_total", None)
        if d is None:
            d = getattr(ev, "cuda_time_total", 0.0)
        if ev.key == "aten::_local_scalar_dense":
            syncs = ev.count
        if getattr(ev, "device_type", None) is not None and str(ev.device_type).endswith("CUDA"):
            dev_us += ev.self_device_time_total if hasattr(ev, "self_device_time_total") else d
            by_name[ev.key] = by_name.get(ev.key, 0.0) + (
                ev.self_device_time_total if hasattr(ev, "self_device_time_total") else d
            )
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "particles": n,
        "steps": steps,
        "launches": launches,
        "particle_steps_per_s": stats["particle_steps_per_s"],
        "wall_s_profiled": wall,
        "execute_wall_s": stats["wall_s"],
        "ms_per_step": 1e3 * stats["wall_s"] / steps,
        "device_busy_share": dev_us * 1e-6 / stats["wall_s"],
        "host_reads_per_step": syncs / steps,
        "device_ms_per_step_by_kernel": {k: v * 1e-3 / steps for k, v in top},
    }


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import parcels_tpu_torch as tp
    from parcels_tpu_torch.ops import _build

    _build.build_all()
    card = cs.nvidia_smi()
    res = {"card": card, "torch": torch.__version__}
    ds_a = cs.flat_dataset((24, 1, 256, 1000), extent=(255e3, 999e3), seed=3)
    fs_a = tp.FieldSet.from_sgrid_conventions(ds_a, mesh="flat")
    res["a_k1_rk4_1M"] = profile_path(torch, tp, cs, fs_a, 1 << 20, tp.AdvectionRK4, 60, seed=4)
    ds_b = cs.flat_dataset((2, 50, 500, 500), extent=(1e6, 1e6), seed=5, w_scale=3e-4)
    fs_b = tp.FieldSet.from_sgrid_conventions(ds_b, mesh="flat")
    res["b_k2_rk4_3d_2M"] = profile_path(torch, tp, cs, fs_b, 2_000_000, tp.AdvectionRK4_3D, 20,
                                         seed=6, zrange=(10.0, 490.0))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

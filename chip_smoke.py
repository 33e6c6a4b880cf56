#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to their plain versions.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; there is no CPU fallback):

0. the card's name and power limit (nvidia-smi);
1. build every CUDA kernel of the port from ``parcels_tpu_torch/csrc`` (nvcc, sm_90a);
2. K1 (fold sampler) against its plain version at the K1 end-to-end shape,
   1M lanes including edge, out-of-range and NaN positions;
3. K2 (slab sampler) against its plain version and the plain gather, at
   the 3-D end-to-end shape with 2M lanes sorted by the port's key; then
   both kernels on small edge shapes (degenerate axes, K2's scalar
   staging path, dead chunks);
4. end to end through ``ParticleSet.execute``:
   (a) a regional hourly surface-current field (24, 1, 256, 1000) with 1M
       particles, AdvectionRK4, dt 60 s for 1 h (K1);
   (b) a regional 3-D model (2, 50, 500, 500) U/V/W with 2M particles,
       AdvectionRK4_3D, dt 60 s for 20 steps (K2 on the engine-sorted SoA);
   each launch counter is set to 0 just before a run and read just after;
5. run 4(b) at 64K particles on the card and on the CPU: positions agree to
   rtol 1e-5, states and activity are identical;
6. the moving-eddy closed form on the card.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Field data and
particle seeds are random, made from fixed seeds. Exits non-zero without a
result when CUDA is absent or the port cannot be imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks used for the bounds (dense fp32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: f32 operations per lane of a 16-corner hat sample: 8 hat weights (3 each)
#: and 16 corners (3 weight products, 1 multiply, 1 add)
OPS_PER_LANE = 8 * 3 + 16 * 5
#: 2M particles padded to the engine's lane count (multiples of 8192)
K2_LANES = -(-2_000_000 // 8192) * 8192


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, reps=20, warmup=3) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def touched_field_bytes(torch, shape, pos) -> int:
    """Bytes of the distinct field elements the lanes' 16-corner stencils
    read: what this run's data needs from the field."""
    from parcels_tpu_torch.ops.interp_kernels import hat_stencil

    T, Z, Y, X = shape
    st = [hat_stencil(p, d) for p, d in zip(pos, shape)]
    lins = []
    for ct, _, vt in st[0]:
        for cz, _, vz in st[1]:
            for cy, _, vy in st[2]:
                for cx, _, vx in st[3]:
                    ok = vt & vz & vy & vx
                    lins.append((((ct * Z + cz) * Y + cy) * X + cx)[ok])
    return 4 * int(torch.unique(torch.cat(lins)).numel())


def bound(nbytes, nops):
    b, o = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return 1e3 * max(b, o), ("bytes" if b >= o else "operations")


def flat_dataset(shape, extent, seed, w_scale=None):
    """A flat rectilinear U/V(/W) dataset with random velocities."""
    from parcels_tpu_torch import xrlite as xr
    from parcels_tpu_torch.datasets.structured import _coords_2d, _wrap_sgrid

    T, Z, Y, X = shape
    lon = np.linspace(0.0, extent[1], X)
    lat = np.linspace(0.0, extent[0], Y)
    depth = np.linspace(0.0, 500.0, Z) if Z > 1 else np.array([0.0])
    taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s") for i in range(T)])
    rng = np.random.default_rng(seed)
    dims = ["time", "depth", "YG", "XG"]
    data = {c: (dims, rng.uniform(-0.3, 0.3, shape).astype(np.float32)) for c in ("U", "V")}
    if w_scale is not None:
        data["W"] = (dims, (rng.uniform(-1, 1, shape) * w_scale).astype(np.float32))
    ds = xr.Dataset(data, coords=_coords_2d(lon, lat, time=taxis, depth=depth, mesh="flat"))
    return _wrap_sgrid(ds, X, Y)


def k1_phase(torch, dev):
    from parcels_tpu_torch.ops import interp_kernels as ik

    shape = (24, 1, 256, 1000)
    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(1)
    data = torch.rand(shape, generator=g, device=dev) * 2 - 1
    pos = [torch.rand(n, generator=g, device=dev) * (d + 1.0) - 1.0 for d in shape]
    pos[1] = torch.zeros(n, device=dev)  # degenerate axis pinned to 0
    pos[0][::97] = float("nan")
    pos[3][::101] = -10.0
    pos[2][::103] = 1e30
    out = ik.fold_sample(data, *pos)
    torch.cuda.synchronize()
    ref = ik.fold_sample_plain(data, *pos)
    nan_k, nan_p = torch.isnan(out), torch.isnan(ref)
    if not torch.equal(nan_k, nan_p):
        raise AssertionError("K1: NaN lanes differ from the plain version")
    diff = (out - ref).abs()[~nan_k]
    err = float(diff.max())
    rel = float((diff / ref.abs()[~nan_k].clamp_min(1e-30)).max())
    # tolerance: both round every product and sum in f32 in one order
    if err > 1e-6:
        raise AssertionError(f"K1 disagrees with its plain version: max abs err {err}")

    ms = cuda_ms(torch, lambda: ik.fold_sample(data, *pos))
    plain_ms = cuda_ms(torch, lambda: ik.fold_sample_plain(data, *pos), reps=5)
    # yardstick only: one library call computing the same (t, y, x) function
    T, _, Y, X = shape
    grid = torch.stack([2 * pos[3] / (X - 1) - 1, 2 * pos[2] / (Y - 1) - 1,
                        2 * pos[0] / (T - 1) - 1], dim=-1).view(1, n, 1, 1, 3)
    inp = data.view(1, 1, T, Y, X)
    gs = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    lib = gs().view(n)
    lib_err = float((lib - out).abs()[~nan_k].max())
    library_ms = cuda_ms(torch, gs)
    nbytes = touched_field_bytes(torch, shape, pos) + n * 20
    bound_ms, bound_by = bound(nbytes, n * OPS_PER_LANE)
    log(f"[K1] shape {shape} lanes {n}: max abs err {err:.3g} max rel err {rel:.3g} "
        f"(grid_sample differs by {lib_err:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"grid_sample {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def k2_phase(torch, dev):
    from parcels_tpu_torch.ops import binned_sample as bs

    shape = (2, 50, 500, 500)
    n = K2_LANES
    g = torch.Generator(device=dev).manual_seed(2)
    data = (torch.rand(shape, generator=g, device=dev) - 0.5) * 0.6
    gpos = {}
    for ax, d in zip("TZYX", shape):
        gpos[ax] = {
            "index": torch.randint(0, max(d - 1, 1), (n,), generator=g, device=dev, dtype=torch.int32),
            "bcoord": torch.rand(n, generator=g, device=dev),
        }
    order = torch.sort(bs.sort_key_for(None, gpos, shape, n), stable=True).indices
    for ax in "TZYX":
        for k in ("index", "bcoord"):
            gpos[ax][k] = gpos[ax][k][order].contiguous()
    gpos["_sorted"] = True
    geom = bs.slab_geometry(shape, n)
    feasible = bs.plan_feasible(shape, n)
    if not feasible:
        raise AssertionError(f"K2: plan for {shape} at {n} lanes is not feasible")
    plan = bs._build_plan(shape, gpos)
    out = bs.slab_sample(data, plan)
    torch.cuda.synchronize()
    ref = bs.slab_sample_plain(data, plan)
    err = float((out - ref).abs().max())
    if err > 1e-6:  # same rounding order as the plain version
        raise AssertionError(f"K2 disagrees with its plain version: max abs err {err}")
    vals = bs.binned_linear_sample(data, gpos)
    g16 = bs._gather16(data, bs._gather_lanes(gpos))
    err16 = float((vals - g16).abs().max())
    # tolerance of the reference's own tests (rtol 2e-4 / atol 2e-5): K2
    # carries each slab-relative position as one f32
    if not torch.allclose(vals, g16, rtol=2e-4, atol=2e-5):
        raise AssertionError(f"K2 + fix-up disagrees with the plain gather: {err16}")
    share = plan["count"] / n
    ms = cuda_ms(torch, lambda: bs.slab_sample(data, plan))
    plain_ms = cuda_ms(torch, lambda: bs.slab_sample_plain(data, plan), reps=5)
    fixed_ms = cuda_ms(torch, lambda: bs.binned_linear_sample(data, gpos), reps=5)
    pos = [gpos[ax]["index"].float() + gpos[ax]["bcoord"] for ax in "TZYX"]
    plan_bytes = sum(a.numel() * 4 for a in (plan["t0"], plan["shalf"], plan["z0w"], plan["live"]))
    plan_bytes += sum(a.numel() * 4 for a in plan["origins"].values())
    nbytes = touched_field_bytes(torch, shape, pos) + plan["npad"] * 20 + plan_bytes
    bound_ms, bound_by = bound(nbytes, plan["npad"] * OPS_PER_LANE)
    log(f"[K2] shape {shape} lanes {n}: geometry (WT,SZ,SY,SX,bz,by,bx)={geom} feasible {feasible}, "
        f"window {4 * geom[0] * min(4, geom[1]) * geom[2] * geom[3]} B, overflow share {share:.4f}; "
        f"max abs err vs plain {err:.3g}, K2+fix-up vs gather {err16:.3g}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, K2+plan fix-up {fixed_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {nbytes} B); no single library call computes a 4-D (t,z,y,x) sample")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def edge_phase(torch, dev):
    """Both kernels against their plain versions, bit for bit, on shapes the
    end-to-end paths do not reach: degenerate T/Z axes, an X that rules out
    16-byte loads (K2's scalar staging path) and dead chunks."""
    from parcels_tpu_torch.ops import binned_sample as bs
    from parcels_tpu_torch.ops import interp_kernels as ik

    g = torch.Generator(device=dev).manual_seed(9)
    for shape in ((1, 1, 8, 8), (3, 4, 10, 130)):
        data = torch.rand(shape, generator=g, device=dev)
        pos = [torch.rand(5000, generator=g, device=dev) * (d + 1.0) - 1.0 for d in shape]
        if not torch.equal(ik.fold_sample(data, *pos), ik.fold_sample_plain(data, *pos)):
            raise AssertionError(f"K1 disagrees with its plain version at {shape}")
    for shape in ((2, 6, 40, 1101), (1, 1, 64, 1024)):
        n = 20 * bs.CHUNK
        data = torch.rand(shape, generator=g, device=dev)
        gpos = {ax: {"index": torch.randint(0, max(d - 1, 1), (n,), generator=g, device=dev,
                                            dtype=torch.int32),
                     "bcoord": torch.rand(n, generator=g, device=dev)} for ax, d in zip("TZYX", shape)}
        order = torch.sort(bs.sort_key_for(None, gpos, shape, n), stable=True).indices
        gpos = {ax: {k: v[order].contiguous() for k, v in d.items()} for ax, d in gpos.items()}
        gpos["active"] = torch.arange(n, device=dev) < n - 3 * bs.CHUNK  # three dead chunks
        plan = bs._build_plan(shape, gpos)
        if not torch.equal(bs.slab_sample(data, plan), bs.slab_sample_plain(data, plan)):
            raise AssertionError(f"K2 disagrees with its plain version at {shape}")
    torch.cuda.synchronize()
    log("[edges] K1 at (1,1,8,8), (3,4,10,130) and K2 at (2,6,40,1101) (scalar staging), "
        "(1,1,64,1024) with dead chunks: equal to their plain versions")


def counts():
    from parcels_tpu_torch.ops.binned_sample import slab_sample
    from parcels_tpu_torch.ops.interp_kernels import fold_sample

    return {"fold_sample": fold_sample.launches, "slab_sample": slab_sample.launches}


def zero_counts():
    from parcels_tpu_torch.ops.binned_sample import slab_sample
    from parcels_tpu_torch.ops.interp_kernels import fold_sample

    fold_sample.launches = 0
    slab_sample.launches = 0


def run_path(torch, tp, fs, n, kernel, runtime_s, seed, zrange=None):
    """One ParticleSet.execute at dt 60 s; returns (pset, launches, stats)."""
    rng = np.random.default_rng(seed)
    g = fs.gridset[0]
    lon, lat = g.lon, g.lat
    span = lambda a: (a[0] + 0.1 * (a[-1] - a[0]), a[-1] - 0.1 * (a[-1] - a[0]))  # noqa: E731
    kw = dict(x=rng.uniform(*span(lon), n), y=rng.uniform(*span(lat), n), t=np.zeros(n))
    if zrange is not None:
        kw["z"] = rng.uniform(*zrange, n)
    pset = tp.ParticleSet(fs, **kw)
    zero_counts()
    pset.execute(kernel, dt=np.timedelta64(60, "s"), runtime=np.timedelta64(runtime_s, "s"))
    launches = counts()
    x, y, z = pset.x, pset.y, pset.z
    if not (x.shape == y.shape == z.shape == (n,)):
        raise AssertionError(f"positions have shape {x.shape}, expected ({n},)")
    if not (np.isfinite(x).all() and np.isfinite(y).all() and np.isfinite(z).all()):
        raise AssertionError("non-finite positions after execute")
    if int((pset.state >= tp.StatusCode.Error).sum()):
        raise AssertionError("particles ended in an error state")
    return pset, launches, pset.last_run_stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import parcels_tpu_torch as tp
    from parcels_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    build_s = _build.build_all()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln] for k, v in _build.BUILD_LOG.items()}
    log(f"[build] {sorted(_build.KERNEL_SOURCES)} in {build_s:.2f} s (nvcc, parallel); ptxas: {regs}")

    k1 = k1_phase(torch, dev)
    k2 = k2_phase(torch, dev)
    edge_phase(torch, dev)

    # 4(a): K1 path
    ds_a = flat_dataset((24, 1, 256, 1000), extent=(255e3, 999e3), seed=3)
    fs_a = tp.FieldSet.from_sgrid_conventions(ds_a, mesh="flat")
    _, la, sa = run_path(torch, tp, fs_a, 1 << 20, tp.AdvectionRK4, 3600, seed=4)
    log(f"[e2e a] (24,1,256,1000) 1M particles RK4 dt 60 s 1 h: launches {la}; "
        f"particle_steps_per_s {sa['particle_steps_per_s']} wall_s {sa['wall_s']}")
    if la["fold_sample"] == 0:
        raise AssertionError("K1 was not launched on the K1 path")

    # 4(b): K2 path
    ds_b = flat_dataset((2, 50, 500, 500), extent=(1e6, 1e6), seed=5, w_scale=3e-4)
    fs_b = tp.FieldSet.from_sgrid_conventions(ds_b, mesh="flat")
    from parcels_tpu_torch.ops.binned_sample import plan_feasible

    log(f"[e2e b] plan feasible at {K2_LANES} lanes: {plan_feasible((2, 50, 500, 500), K2_LANES)}")
    _, lb, sb = run_path(torch, tp, fs_b, 2_000_000, tp.AdvectionRK4_3D, 20 * 60, seed=6,
                         zrange=(10.0, 490.0))
    log(f"[e2e b] (2,50,500,500) 2M particles RK4_3D dt 60 s 20 steps: launches {lb}; "
        f"particle_steps_per_s {sb['particle_steps_per_s']} wall_s {sb['wall_s']}")
    if lb["slab_sample"] == 0:
        raise AssertionError("K2 was not launched on the K2 path")

    # 5: card against CPU, 4(b) at 64K particles
    fs_cpu = tp.FieldSet.from_sgrid_conventions(ds_b, mesh="flat", device="cpu")
    runs = {}
    for name, fs in (("cuda", fs_b), ("cpu", fs_cpu)):
        runs[name], _, _ = run_path(torch, tp, fs, 1 << 16, tp.AdvectionRK4_3D, 20 * 60, seed=7,
                                    zrange=(10.0, 490.0))
    a, b = runs["cuda"], runs["cpu"]
    for var in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(a, var), getattr(b, var), rtol=1e-5)
    np.testing.assert_array_equal(a._data["state"].cpu().numpy(), b._data["state"].numpy())
    np.testing.assert_array_equal(a._data["_active"].cpu().numpy(), b._data["_active"].numpy())
    dmax = max(float(np.abs(getattr(a, v) - getattr(b, v)).max()) for v in ("x", "y", "z"))
    log(f"[card vs cpu] 64K particles, 20 RK4_3D steps: max |position difference| {dmax:.3g} m")

    # 6: moving eddy closed form on the card
    from parcels_tpu_torch.datasets import moving_eddy_dataset

    ds_e = moving_eddy_dataset()
    fs_e = tp.FieldSet.from_sgrid_conventions(ds_e, mesh="flat")
    pset = tp.ParticleSet(fs_e, x=[12000.0], y=[12500.0], t=[np.timedelta64(0, "s")])
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(5, "m"), runtime=np.timedelta64(1, "h"))
    u0, ug, f = ds_e.attrs["u_0"], ds_e.attrs["u_g"], ds_e.attrs["f"]
    exp = 12000.0 + ug * 3600 + (u0 - ug) / f * np.sin(f * 3600)
    rel = abs(pset.x[0] - exp) / exp
    if rel >= 1e-5:
        raise AssertionError(f"moving eddy: x {pset.x[0]} vs closed form {exp}")
    log(f"[eddy] x {pset.x[0]:.3f} closed form {exp:.3f} rel err {rel:.3g}")

    kernels = [
        dict(name="fold_sample", route="cuda", source="parcels_tpu_torch/csrc/fold_sample.cu",
             replaces="parcels_tpu/ops/interp_kernels.py:77", launches=la["fold_sample"], **k1),
        dict(name="slab_sample", route="cuda", source="parcels_tpu_torch/csrc/slab_sample.cu",
             replaces="parcels_tpu/ops/binned_sample.py:489", launches=lb["slab_sample"], **k2),
    ]
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

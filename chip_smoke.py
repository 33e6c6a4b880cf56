#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to their plain versions.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; there is no CPU fallback; every launch
counter is set to 0 just before a path runs and read just after):

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
6. the moving-eddy closed form on the card;
7. K3 (fused C-grid RK4 step) against its plain version at 2^23 lanes on
   rows of the config-5 grid (a MOi-shaped global curvilinear C-grid,
   (T, Z, Y, X) = (2, 50, 1500, 2000), U/V filled on the card), NaN lanes
   and invalid rows included;
8. the C-grid engine path end to end: 2^23 particles at z = 1 m through
   ``ParticleSet.execute(AdvectionRK4)`` at dt 600 s for 6 steps on the
   config-5 fieldset (curvilinear search, stage cache);
9. the K3 hit-and-repair stepper from the SoA cache of one engine step: one
   warm-up and 24 timed steps with the repair, 24 without, against the
   engine advancing the same warm batch 25 steps;
10. card against CPU: phase 8 at 64K particles (stage cache forced on the
    CPU), and the rectilinear C-grid peninsula, which launches K1 on the
    card.

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


#: f32 operations per lane of one K3 step, counting each add, multiply,
#: compare, select, division, square root and trig call as one: per stage
#: about 162 adds/multiplies/compares, 9 divisions, 5 square roots and 9 trig
#: calls, plus about 30 for the RK4 combination
K3_OPS_PER_LANE = 4 * (162 + 9 + 5 + 9) + 30
#: bytes a K3 lane must move: row planes 0-14 and 16-25 (plane 15 is the cell
#: table's zero pad column, which no stage reads), uv planes 0-7 and state
#: planes 0-3 read once, 8 output planes written once
K3_BYTES_PER_LANE = (25 + 8 + 4) * 4 + 8 * 4


def k3_inputs(torch, fs, n, seed, dt=600.0):
    """K3 planes for ``n`` lanes on the C-grid of ``fs``: random cells, points
    at random (xsi, eta) in [-0.02, 1.02]^2 of their cell (so some stages
    leave it), random face values, every 97th lane NaN and every 101st row
    invalid."""
    from parcels_tpu_torch.ops import stagecache
    from parcels_tpu_torch.ops.fused_rk4 import ROW_PLANES

    dev = torch.device("cuda")
    g = fs.gridset[0]
    vf = fs.build_views(fs.device_arrays()).UV
    rng = np.random.default_rng(seed)
    ny, nx = g.lon.shape
    yi = rng.integers(0, ny - 1, n)
    xi = rng.integers(0, nx - 1, n)
    a = rng.uniform(-0.02, 1.02, n)
    b = rng.uniform(-0.02, 1.02, n)

    def bilinear(arr):
        return ((1 - a) * (1 - b) * arr[yi, xi] + a * (1 - b) * arr[yi, xi + 1]
                + a * b * arr[yi + 1, xi + 1] + (1 - a) * b * arr[yi + 1, xi])

    x = torch.as_tensor(bilinear(g.lon).astype(np.float32), device=dev)
    y = torch.as_tensor(bilinear(g.lat).astype(np.float32), device=dev)
    x[::97] = float("nan")
    cell = torch.as_tensor(yi * (nx - 1) + xi, device=dev)
    rows = stagecache._rows(vf, cell)
    valid = torch.ones(n, device=dev)
    valid[::101] = 0.0
    rowsT = torch.cat([rows.t(), valid[None],
                       torch.zeros((ROW_PLANES - rows.shape[1] - 1, n), device=dev)]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(seed)
    uvT = (torch.rand((8, n), generator=gen, device=dev) - 0.5) * 0.6
    z = torch.zeros(n, device=dev)
    state = torch.stack([x, y, torch.full_like(x, dt), torch.full_like(x, dt), z, z, z, z])
    return rowsT, uvT, state.contiguous()


def k3_phase(torch, fs, n, seed=11, dt=600.0):
    """K3 against its plain version on the card; returns the kernel line."""
    from parcels_tpu_torch.ops.fused_rk4 import fused_rk4_step, fused_rk4_step_plain

    rowsT, uvT, state = k3_inputs(torch, fs, n, seed, dt)
    spec = fs.gridset[0].spec
    t1 = float(fs.gridset[0].time[1])
    args = (spec.deg2m, 1.0 / t1, dt)
    out = fused_rk4_step(rowsT, uvT, state, *args)
    torch.cuda.synchronize()
    ref = fused_rk4_step_plain(rowsT, uvT, state, *args)
    xy_k, xy_p = out[:2], ref[:2]
    if not torch.equal(torch.isnan(xy_k), torch.isnan(xy_p)):
        raise AssertionError("K3: NaN lanes differ from the plain version")
    fin = ~torch.isnan(xy_p)
    err = float((xy_k - xy_p).abs()[fin].max())
    same = ((out == ref) | (torch.isnan(out) & torch.isnan(ref))).all(dim=0)
    bitwise = int(same.sum())
    miss_diff = int((out[4] != ref[4]).sum())
    miss_share = float(ref[4].mean())
    # acceptance: within 2e-5 deg, miss flags differing on at most 1e-5 of
    # the lanes (the target, equal rounding order, is bit for bit)
    if err > 2e-5 or miss_diff > 1e-5 * n:
        raise AssertionError(f"K3 disagrees with its plain version: max abs err {err} deg, "
                             f"{miss_diff} miss flags differ")
    del ref
    ms = cuda_ms(torch, lambda: fused_rk4_step(rowsT, uvT, state, *args))
    plain_ms = cuda_ms(torch, lambda: fused_rk4_step_plain(rowsT, uvT, state, *args),
                       reps=3, warmup=1)
    bound_ms, bound_by = bound(n * K3_BYTES_PER_LANE, n * K3_OPS_PER_LANE)
    log(f"[K3] lanes {n}: max abs err x/y {err:.3g} deg, bitwise-equal lanes {bitwise} of {n}, "
        f"miss flags differing {miss_diff}, miss share {miss_share:.4f}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{K3_BYTES_PER_LANE} B and {K3_OPS_PER_LANE} ops a lane); no single library call "
        f"computes this step")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _wrappers():
    from parcels_tpu_torch.ops.binned_sample import slab_sample
    from parcels_tpu_torch.ops.fused_rk4 import fused_rk4_step
    from parcels_tpu_torch.ops.interp_kernels import fold_sample

    return {"fold_sample": fold_sample, "slab_sample": slab_sample, "fused_rk4": fused_rk4_step}


def counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def zero_cache_counts():
    from parcels_tpu_torch.ops.stagecache import cgrid_cached_eval as ce

    ce.full_evals = ce.miss_rounds = ce.checked_lanes = ce.misses = 0


def cache_counts():
    from parcels_tpu_torch.ops.stagecache import cgrid_cached_eval as ce

    share = ce.misses / ce.checked_lanes if ce.checked_lanes else 0.0
    return dict(full_evals=ce.full_evals, miss_rounds=ce.miss_rounds, miss_share_per_stage=share)


#: the JAX package's config 5: global 1/12-degree-like MOi C-grid, (T, Z, Y, X)
CONFIG5 = (2, 50, 1500, 2000)
#: config-5 particle count: 2^23
CONFIG5_LANES = 1 << 23


def config5_fieldset(torch, tp, device, shape=CONFIG5):
    """MOi-shaped curvilinear C-grid fieldset at ``shape`` on ``device``,
    built through nemo_to_sgrid from zero data (the velocities are filled
    on the card afterwards)."""
    from parcels_tpu_torch.convert import nemo_to_sgrid
    from parcels_tpu_torch.datasets import moi_like_inputs

    T, Z, Y, X = shape
    fields, coords = moi_like_inputs(xdim=X, ydim=Y, zdim=Z, tdim=T, zero_data=True)
    return tp.FieldSet.from_sgrid_conventions(nemo_to_sgrid(fields=fields, coords=coords),
                                              device=device)


def fill_velocities(torch, fs, seed=3):
    """U/V uniform in +-0.3 m/s from a seeded generator on the card."""
    farrays = fs.device_arrays()
    g = torch.Generator(device=fs.device).manual_seed(seed)
    for name in ("U", "V"):
        farrays["fields"][name].uniform_(-0.3, 0.3, generator=g)


def config5_seeds(n, seed=1):
    """Particles at z = 1 m, lon uniform in +-170, lat uniform in -60..70."""
    rng = np.random.default_rng(seed)
    return dict(x=rng.uniform(-170.0, 170.0, n), y=rng.uniform(-60.0, 70.0, n),
                z=np.full(n, 1.0), t=np.zeros(n))


def run_cgrid(tp, fs, seeds, steps, dt=600):
    pset = tp.ParticleSet(fs, **seeds)
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(dt, "s"),
                 runtime=np.timedelta64(steps * dt, "s"))
    x, y = pset.x, pset.y
    n = seeds["x"].size
    if not (x.shape == y.shape == (n,) and np.isfinite(x).all() and np.isfinite(y).all()):
        raise AssertionError("C-grid path: positions are not finite of the expected shape")
    if int((pset.state >= tp.StatusCode.Error).sum()):
        raise AssertionError("C-grid path: particles ended in an error state")
    return pset


def k3_path_phase(torch, tp, fs, seeds, dt=600.0, steps=24):
    """Phase 9: the fused hit-and-repair stepper from one engine step's SoA
    cache, against the engine advancing the same warm batch."""
    from parcels_tpu_torch.ops.fused_rk4 import FusedRK4Stepper

    pset = run_cgrid(tp, fs, seeds, 1, int(dt))  # the warm batch
    warm = dict(pset._data)
    n = seeds["x"].size
    out = {}
    for repair in (True, False):
        stepper = FusedRK4Stepper(fs, warm, dt, repair=repair)
        if repair:
            zero_counts()
        first = stepper.one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cnts = [stepper.one_step() for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cnts = [int(first)] + [int(c) for c in cnts]
        if repair:
            launches = counts()["fused_rk4"]
            # reading the state raises if a step overflowed its repair round
            xy = stepper.state[:2].cpu().numpy()
        out["repair" if repair else "norepair"] = dict(
            rate=n * steps / wall, wall=wall, miss_share=float(np.mean(cnts)) / stepper.n,
            miss_max=max(cnts), kcap=stepper.kcap)
        del stepper
    torch.cuda.empty_cache()
    # the engine advances the same warm batch as many steps
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(int(dt), "s"),
                 runtime=np.timedelta64(int(dt) * (steps + 1), "s"))
    act = warm["_active"].cpu().numpy()
    d = np.maximum(np.abs(xy[0][act] - pset.x), np.abs(xy[1][act] - pset.y))
    over = float((d > 1e-4).mean())
    # acceptance: at most 1 % of lanes beyond 1e-4 deg, none beyond 0.08 deg
    # (under one cell of the 2000 x 1500 grid)
    if over > 0.01 or d.max() > 0.08:
        raise AssertionError(f"K3 path vs engine: {over:.4%} of lanes beyond 1e-4 deg, "
                             f"max {d.max():.3g} deg")
    out.update(launches=launches, max_dxy=float(d.max()), share_over_1e4=over,
               engine_rate=pset.last_run_stats["particle_steps_per_s"],
               engine_wall=pset.last_run_stats["wall_s"])
    return out


def compare_runs(a, b, tol):
    """(share of lanes beyond ``tol``, max difference, states equal on the rest)."""
    d = np.maximum(np.abs(a.x - b.x), np.abs(a.y - b.y))
    near = d <= tol
    return float((~near).mean()), float(d.max()), bool(np.array_equal(a.state[near],
                                                                      b.state[near]))


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

    # 7: K3 against its plain version at the config-5 lane count, on rows of
    # the config-5 grid
    t_fs = time.perf_counter()
    fs5 = config5_fieldset(torch, tp, "cuda")
    fill_velocities(torch, fs5)
    torch.cuda.synchronize()
    log(f"[config5] fieldset {CONFIG5} built and filled in {time.perf_counter() - t_fs:.1f} s")
    k3 = k3_phase(torch, fs5, CONFIG5_LANES)
    torch.cuda.empty_cache()

    # 8: the C-grid engine path end to end at config 5: 6 steps, as the
    # first step (every persistent cache entry starts invalid) and 5 more
    seeds5 = config5_seeds(CONFIG5_LANES)
    zero_counts()
    zero_cache_counts()
    p8 = run_cgrid(tp, fs5, seeds5, 1)
    c8a, s8a = cache_counts(), p8.last_run_stats
    zero_cache_counts()
    p8.execute(tp.AdvectionRK4, dt=np.timedelta64(600, "s"), runtime=np.timedelta64(3000, "s"))
    l8, c8b, s8b = counts(), cache_counts(), p8.last_run_stats
    if not (np.isfinite(p8.x).all() and np.isfinite(p8.y).all()) or int(
            (p8.state >= tp.StatusCode.Error).sum()):
        raise AssertionError("C-grid path: non-finite positions or error states after 6 steps")
    del p8
    torch.cuda.empty_cache()
    wall8 = s8a["wall_s"] + s8b["wall_s"]
    log(f"[e2e cgrid] {CONFIG5} {CONFIG5_LANES} particles RK4 dt 600 s 6 steps: "
        f"particle_steps_per_s {6 * CONFIG5_LANES / wall8:.1f} wall_s {wall8:.4f}; step 1: "
        f"wall_s {s8a['wall_s']} stage cache {c8a}; steps 2-6: particle_steps_per_s "
        f"{s8b['particle_steps_per_s']} wall_s {s8b['wall_s']} stage cache {c8b}; "
        f"launches {l8}")

    # 9: the K3 hit-and-repair path from the same seeds
    k9 = k3_path_phase(torch, tp, fs5, seeds5)
    log(f"[K3 path] {CONFIG5_LANES} lanes, 24 timed steps: with repair "
        f"{k9['repair']['rate']:.1f} particle-steps/s (wall {k9['repair']['wall']:.4f} s, "
        f"miss share/step {k9['repair']['miss_share']:.5f}, max {k9['repair']['miss_max']} "
        f"of kcap {k9['repair']['kcap']}); without repair {k9['norepair']['rate']:.1f} "
        f"particle-steps/s (wall {k9['norepair']['wall']:.4f} s); engine on the same warm "
        f"batch, 25 steps: {k9['engine_rate']} particle-steps/s (wall {k9['engine_wall']} s); "
        f"after 25 steps max |dx|,|dy| {k9['max_dxy']:.3g} deg, share over 1e-4 deg "
        f"{k9['share_over_1e4']:.5f}; launches {k9['launches']}")
    if k9["launches"] < 25:
        raise AssertionError("K3 was not launched on every step of its path")

    # 10: card against CPU: phase 8 at 64K particles, and the rectilinear
    # C-grid peninsula (K1 on the card)
    seeds10 = config5_seeds(1 << 16, seed=5)
    fs5_cpu = config5_fieldset(torch, tp, "cpu")
    for name in ("U", "V"):
        fs5_cpu.device_arrays()["fields"][name].copy_(fs5.device_arrays()["fields"][name].cpu())
    a10 = run_cgrid(tp, fs5, seeds10, 6)
    os.environ["PARCELS_TPU_STAGECACHE"] = "force"
    try:
        b10 = run_cgrid(tp, fs5_cpu, seeds10, 6)
    finally:
        del os.environ["PARCELS_TPU_STAGECACHE"]
    over, dmax, same_state = compare_runs(a10, b10, 1e-4)
    # tolerance-edge lanes (a (xsi, eta) on the +-2e-4 in-cell edge) may pick
    # the neighbouring cell: at most 0.1 % of lanes
    if over > 1e-3 or not same_state:
        raise AssertionError(f"C-grid card vs CPU: {over:.4%} of lanes beyond 1e-4 deg, "
                             f"states equal elsewhere: {same_state}")
    log(f"[card vs cpu cgrid] 64K particles, 6 RK4 steps at {CONFIG5} (stage cache on both): "
        f"max |difference| {dmax:.3g} deg, share beyond 1e-4 deg {over:.5f}, states equal")
    del fs5_cpu, a10, b10

    from parcels_tpu_torch.datasets import peninsula_dataset

    ds_p = peninsula_dataset(grid_type="C")
    rng = np.random.default_rng(8)
    pen = dict(x=np.full(4096, 3e3), y=rng.uniform(5e3, 45e3, 4096), t=np.zeros(4096))
    runs = {}
    for dev_name in ("cuda", "cpu"):
        fs_p = tp.FieldSet.from_sgrid_conventions(ds_p, mesh="flat", device=dev_name)
        zero_counts()
        runs[dev_name] = tp.ParticleSet(fs_p, **pen)
        runs[dev_name].execute(tp.AdvectionRK4, dt=np.timedelta64(60, "s"),
                               runtime=np.timedelta64(3600, "s"))
        if dev_name == "cuda":
            lp = counts()
    if lp["fold_sample"] == 0:
        raise AssertionError("K1 was not launched on the C-grid peninsula")
    for var in ("x", "y"):
        np.testing.assert_allclose(getattr(runs["cuda"], var), getattr(runs["cpu"], var),
                                   rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(runs["cuda"].state, runs["cpu"].state)
    log(f"[peninsula cgrid] 4096 particles, 60 RK4 steps, card vs CPU within rtol 1e-5; "
        f"launches {lp}")

    kernels = [
        dict(name="fold_sample", route="cuda", source="parcels_tpu_torch/csrc/fold_sample.cu",
             replaces="parcels_tpu/ops/interp_kernels.py:77", launches=la["fold_sample"],
             launches_by_path={"e2e_a": la["fold_sample"], "cgrid_peninsula": lp["fold_sample"]},
             **k1),
        dict(name="slab_sample", route="cuda", source="parcels_tpu_torch/csrc/slab_sample.cu",
             replaces="parcels_tpu/ops/binned_sample.py:489", launches=lb["slab_sample"], **k2),
        dict(name="fused_rk4", route="cuda", source="parcels_tpu_torch/csrc/fused_rk4.cu",
             replaces="scripts/bench_fused_rk4.py:134", launches=k9["launches"], **k3),
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

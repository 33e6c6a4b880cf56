#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels to their plain versions.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 chip_smoke.py

``python3 chip_smoke.py --k3-ab PATH`` runs instead K3 of this checkout
against an earlier ``csrc/fused_rk4.cu`` copied to PATH (``k3_ab``): both
held to the plain version, timed in turns, with their SASS counts.

Phases (each raises on failure; there is no CPU fallback; every launch
counter is set to 0 just before a path runs and read just after):

0. the card's name and power limit (nvidia-smi);
1. build every CUDA kernel of the port from ``parcels_tpu_torch/csrc`` (nvcc, sm_90a);
2. K1 (fold sampler) against its plain version at the K1 end-to-end shape,
   1M lanes including edge, out-of-range and NaN positions; K1's and
   ``F.grid_sample``'s times there, with every lane at one shared t (path
   (a)'s lockstep step) and with the lanes sorted by cell;
3. K2 (slab sampler) against its plain version and the plain gather, at
   the 3-D end-to-end shape with 2M lanes sorted by the port's key, with
   the bytes it stages a call beside its bound (counted by the kernel, and
   held to ``staged_bytes``, the host's count of its rule), and K1's
   kernel timed as a direct gather over the same sorted lanes (a reading);
   then both kernels on edge cases (``edge_phase``);
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
   and invalid rows included, then bit for bit on ragged last blocks and
   unaligned planes; with its hit-path SASS count a lane and the lanes it
   redid with the exact division and square root;
8. the C-grid engine path end to end: 2^23 particles at z = 1 m through
   ``ParticleSet.execute(AdvectionRK4)`` at dt 600 s for 6 steps on the
   config-5 fieldset (curvilinear search, stage cache);
9. the K3 hit-and-repair stepper from the SoA cache of one engine step: one
   warm-up and 24 timed steps with the repair, 24 without, against the
   engine advancing the same warm batch 25 steps;
10. card against CPU: phase 8 at 64K particles (stage cache forced on the
    CPU), and the rectilinear C-grid peninsula, which launches K1 on the
    card;
11. K4 (fused flat-mesh RK4 step) against its plain version at the JAX
    micro-benchmark's size, 10M lanes floored to 2048 (9,998,336): its
    unit cells mixed with lanes that reach every branch, NaN positions and
    NaN or infinite t; then the micro-benchmark itself (K4's path);
12. BASELINE config 3 end to end: quickstart 03 at 1M particles
    (Euler-Maruyama advection-diffusion with out-of-bounds deletion, Kh
    100 m^2/s, dt 10 min for 24 h) with its survival and spread asserts (K1);
13. Euler-Maruyama on 4(b)'s field with 2M particles, 20 steps (K2 under an
    RNG kernel); with Kh = 0 it equals AdvectionEE;
14. card against CPU for the kernels of this slice: EM and M1 with Kh = 0,
    XFreeslip/XPartialslip on 4(a)'s field with a land band (K1), the
    analytical scheme on a 3-D C-grid with W (and its closed form), the
    CROCO sigma-grid RK2 on an idealized CROCO set, and config 3's
    moments at 64K particles; the analytical scheme on the Stommel gyre is
    held on each device to the JAX test's invariants (P conserved, the
    particles moved) and the card-CPU difference is printed;
15. (h) the UGRID path at the FESOM2-baroclinic-gyre scale of
    ``scripts/bench_ux.py``: a Delaunay mesh of 1200 x 1200 nodes
    (2,875,202 faces, 1,440,000 nodes, 48 interfaces, node-registered
    solid-body rotation on zf) through ``FieldSet.from_ugrid_conventions``
    (fails unless the native mesh library loaded; prints the ingest time),
    2M particles in the middle of the mesh at z = 100 m, AdvectionRK4 at dt
    120 s for 10 steps in the three tiers: the defaults (fused face rows and
    the per-face stage cache), ``uxcache="off"``, and ``uxcol="off",
    uxcache="off"`` (the gather tier); particle-steps/s, the stage cache's
    miss share per stage and repairs per step, the device-to-host reads
    per step of the UGRID search and cache, one profiled warm step (host
    reads, device busy share); the radius of the rotation is held at rtol
    2e-3 on every lane, the tiers agree on every lane's state and on
    positions at rtol 1e-5;
16. (i) card against CPU on the UGRID path: a 200 x 200-node mesh (79,202
    faces, above ``uxcol.MIN_FACES``), 64K particles, AdvectionRK4 at dt 120
    s for 6 steps, the card's defaults against the CPU's ``uxcol="force",
    uxcache="force"``: identical states, positions within 1e-5 relative on
    all but at most 0.1 % of lanes (an edge-riding lane may pick the
    neighbouring face);
17. (j) out-of-core forcing streamed against resident. The script writes
    two zarr stores with ``io.write_zarr_dataset`` (uncompressed, one level
    a chunk) under ``build/stream`` and deletes them at the end: (j2) path
    (b)'s model over 13 hourly levels, (13, 50, 500, 500) f32 U/V/W; (j1)
    path (a)'s field. Each is opened lazily with ``set_time_window(2)`` and
    run through ``ParticleSet.execute``: (j2) 2M particles,
    ``[AdvectionRK4_3D, delete_oob]`` at dt 120 s for 12 h (K2 must
    launch); (j1) 1M particles, AdvectionRK4 at dt 300 s for 23 h (K1 must
    launch). Each streamed run equals, bit for bit, the same windows taken
    from memory; (j1) also equals a second, untimed streamed run that holds
    every window, at its first use, bit for bit against the in-memory
    dataset's levels on the card (phase 18 does so for (j2)'s windows).
    Then the same seeds on the
    resident in-memory fieldset: states and activity equal on every lane,
    the position spread printed (the resident axis rounds the time
    position coarser, in both packages: ``stream_pair``); ``window_stats``
    equal to the count reckoned from the windows' offsets. Printed for both runs:
    particle-steps/s, peak device memory, host seconds inside
    ``windowed_arrays`` (the method wrapped on the instance); the pinned
    copy rate of one window; (j2) for 2 h without and with the prefetch,
    in turns;
18. restart on the card: (j2) streamed for 6 h with hourly Parquet output,
    ``checkpoint``, ``from_checkpoint`` on a freshly opened streamed
    fieldset, 6 more hours, every window held at its first use against the
    dataset's levels: equal to phase 17's 12 h run (states equal,
    positions within rtol 1e-6; the largest difference and whether it is
    bit for bit are printed); ``from_particlefile`` on the output returns
    the 6 h snapshot's ids and positions. Then (j2) streamed at 64K
    particles for 2 h on the card and on the CPU: states equal, positions
    within rtol 1e-5, as phase 5.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Field data and
particle seeds are random, made from fixed seeds. Exits non-zero without a
result when CUDA is absent or the port cannot be imported.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
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


#: cycles the stream spins before a timed run (a few ms at the H100's clocks)
QUEUE_CYCLES = 10_000_000


def cuda_ms(torch, fn, reps=20, warmup=3, queued=False) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls.

    With ``queued`` the stream first spins for a few milliseconds, so every
    call is enqueued before the first one runs: the reading is then the
    calls' device time alone, not bounded by the host's time to launch
    them. The kernels' ``ms`` are read without it, as in every earlier run.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
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
    rng = np.random.default_rng(seed)
    data = {c: rng.uniform(-0.3, 0.3, shape).astype(np.float32) for c in ("U", "V")}
    if w_scale is not None:
        data["W"] = (rng.uniform(-1, 1, shape) * w_scale).astype(np.float32)
    return flat_dataset_of(data, extent)


def j2_dataset():
    """(j2)'s 1.95 GB U/V/W, drawn in f32 (half the host time of f64 draws)."""
    rng = np.random.default_rng(5)

    def uniform(scale):
        a = rng.random(J2_SHAPE, dtype=np.float32)
        a *= np.float32(2 * scale)
        a -= np.float32(scale)
        return a

    return flat_dataset_of({"U": uniform(0.3), "V": uniform(0.3), "W": uniform(3e-4)},
                           extent=(1e6, 1e6))


def flat_dataset_of(data, extent):
    """An SGRID dataset of the (T, Z, Y, X) arrays in ``data`` on a flat
    rectilinear grid over ``extent`` (m), with hourly levels."""
    from parcels_tpu_torch import xrlite as xr
    from parcels_tpu_torch.datasets.structured import _coords_2d, _wrap_sgrid

    T, Z, Y, X = next(iter(data.values())).shape
    lon = np.linspace(0.0, extent[1], X)
    lat = np.linspace(0.0, extent[0], Y)
    depth = np.linspace(0.0, 500.0, Z) if Z > 1 else np.array([0.0])
    taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s") for i in range(T)])
    dims = ["time", "depth", "YG", "XG"]
    ds = xr.Dataset({c: (dims, a) for c, a in data.items()},
                    coords=_coords_2d(lon, lat, time=taxis, depth=depth, mesh="flat"))
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

    if not same_bits(torch, out, ref):
        raise AssertionError("K1 is not bit for bit equal to its plain version")

    ms = cuda_ms(torch, lambda: ik.fold_sample(data, *pos))
    queued_ms = cuda_ms(torch, lambda: ik.fold_sample(data, *pos), queued=True)
    plain_ms = cuda_ms(torch, lambda: ik.fold_sample_plain(data, *pos), reps=5)
    gs = grid_sample_fn(torch, data, pos)
    lib_err = float((gs().view(n) - out).abs()[~nan_k].max())
    library_ms = cuda_ms(torch, gs)
    nbytes = touched_field_bytes(torch, shape, pos) + n * 20
    bound_ms, bound_by = bound(nbytes, n * OPS_PER_LANE)
    log(f"[K1] shape {shape} lanes {n}: max abs err {err:.3g} max rel err {rel:.3g} "
        f"(grid_sample differs by {lib_err:.3g}); kernel {ms:.4f} ms ({queued_ms:.4f} ms queued "
        f"behind a spin: device time alone), plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B); ptxas: {ptxas_lines('fold_sample')}")
    k1_layouts(torch, data, pos)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def grid_sample_fn(torch, data, pos):
    """Yardstick only: one library call computing K1's (t, y, x) function on
    a field with Z == 1 (``F.grid_sample``, 5-D, trilinear, zero padding)."""
    T, _, Y, X = data.shape
    n = pos[0].shape[0]
    grid = torch.stack([2 * pos[3] / (X - 1) - 1, 2 * pos[2] / (Y - 1) - 1,
                        2 * pos[0] / (T - 1) - 1], dim=-1).view(1, n, 1, 1, 3)
    inp = data.view(1, 1, T, Y, X)
    return lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def k1_layouts(torch, data, pos):
    """K1 and grid_sample at phase 2's positions laid out two more ways:
    every lane at one shared t (as path (a)'s lockstep step gives it), and
    the lanes sorted by their (t, y, x) cell. The gaps say how much the
    scatter of a warp's corner loads sets K1's pace."""
    from parcels_tpu_torch.ops import interp_kernels as ik

    T, _, Y, X = data.shape
    shared = [torch.full_like(pos[0], 11.375), *pos[1:]]
    cells = [torch.nan_to_num(torch.floor(p), nan=0.0).clamp(-2, d).to(torch.int64)
             for p, d in zip((pos[0], pos[2], pos[3]), (T, Y, X))]
    order = torch.argsort(((cells[0] + 2) * (Y + 3) + cells[1] + 2) * (X + 3) + cells[2] + 2)
    ordered = [p[order].contiguous() for p in pos]
    out, layouts = {}, {"shared t": shared, "sorted by cell": ordered}
    for name, p in layouts.items():
        if not same_bits(torch, ik.fold_sample(data, *p), ik.fold_sample_plain(data, *p)):
            raise AssertionError(f"K1 disagrees with its plain version at {name} positions")
        out[name] = (cuda_ms(torch, lambda: ik.fold_sample(data, *p)),
                     cuda_ms(torch, grid_sample_fn(torch, data, p)))
    log("[K1 layouts] " + "; ".join(f"{k}: kernel {a:.4f} ms, grid_sample {b:.4f} ms"
                                    for k, (a, b) in out.items()))


def ptxas_lines(name):
    """What ``nvcc -Xptxas -v`` said of each kernel in a library: template
    arguments (from the mangled name), registers, stack frame and spills."""
    import re

    from parcels_tpu_torch.ops import _build

    out, entry = [], "?"
    for ln in _build.BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"kernelI(.*?)EEv", m.group(1))
            entry = t.group(1) if t else m.group(1)
        elif "stack frame" in ln:
            out.append(f"{entry}: {ln.strip()}")
        elif "registers" in ln:
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    return out


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
    if not same_bits(torch, out, ref):  # same rounding order as the plain version
        raise AssertionError(f"K2 is not bit for bit equal to its plain version: max abs err {err}")
    vals = bs.binned_linear_sample(data, gpos)
    g16 = bs._gather16(data, bs._gather_lanes(gpos))
    err16 = float((vals - g16).abs().max())
    # tolerance of the reference's own tests (rtol 2e-4 / atol 2e-5): K2
    # carries each slab-relative position as one f32
    if not torch.allclose(vals, g16, rtol=2e-4, atol=2e-5):
        raise AssertionError(f"K2 + fix-up disagrees with the plain gather: {err16}")
    share = plan["count"] / n
    ms = cuda_ms(torch, lambda: bs.slab_sample(data, plan))
    queued_ms = cuda_ms(torch, lambda: bs.slab_sample(data, plan), queued=True)
    plain_ms = cuda_ms(torch, lambda: bs.slab_sample_plain(data, plan), reps=5)
    fixed_ms = cuda_ms(torch, lambda: bs.binned_linear_sample(data, gpos), reps=5)
    pos = [gpos[ax]["index"].float() + gpos[ax]["bcoord"] for ax in "TZYX"]
    plan_bytes = sum(a.numel() * 4 for a in (plan["t0"], plan["shalf"], plan["z0w"], plan["live"]))
    plan_bytes += sum(a.numel() * 4 for a in plan["origins"].values())
    nbytes = touched_field_bytes(torch, shape, pos) + plan["npad"] * 20 + plan_bytes
    bound_ms, bound_by = bound(nbytes, plan["npad"] * OPS_PER_LANE)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    bs.slab_sample(data, plan, counter)
    staged = int(counter)
    host_staged = bs.staged_bytes(plan, torch.cuda.get_device_properties(dev).multi_processor_count)
    if staged != host_staged:
        raise AssertionError(f"K2 staged {staged} B, its rule counted on the host {host_staged} B")
    log(f"[K2] shape {shape} lanes {n}: geometry (WT,SZ,SY,SX,bz,by,bx)={geom} feasible {feasible}, "
        f"window {4 * geom[0] * plan['WZ'] * geom[2] * geom[3]} B, ring of "
        f"{bs.ring_planes(geom)} planes, overflow share {share:.4f}; max abs err vs plain {err:.3g}, "
        f"K2+fix-up vs gather {err16:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, K2+plan "
        f"fix-up {fixed_ms:.4f} ms, kernel queued behind a spin (device time alone) "
        f"{queued_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B); staged "
        f"{staged} B a call as the kernel counted its copies ({staged / 1e6:.1f} MB; "
        f"{staged / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM rate), equal to the host's count "
        f"of its staging rule; no single library call computes a 4-D (t,z,y,x) sample; "
        f"ptxas: {ptxas_lines('slab_sample')}")
    direct_gather_reading(torch, data, pos, g16)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def direct_gather_reading(torch, data, pos, g16):
    """A reading only: K1's kernel, which takes any 4-D field, as a direct
    16-corner gather over phase 3's sorted lanes (absolute f32 positions, so
    its values differ from the plain gather's by f32 rounding)."""
    from parcels_tpu_torch.ops import interp_kernels as ik

    out = ik.fold_sample(data, *pos)
    torch.cuda.synchronize()
    err = float((out - g16).abs().max())
    ms = cuda_ms(torch, lambda: ik.fold_sample(data, *pos))
    log(f"[K1 on K2's lanes] direct gather over the {pos[0].numel()} sorted lanes of "
        f"{tuple(data.shape)}: {ms:.4f} ms, max abs diff from the plain gather {err:.3g}")
    return ms


def same_bits(torch, a, b) -> bool:
    """Equal values, and NaN on the same lanes."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


#: K1 edge fields: degenerate T and Z (alone and together), X % 4 != 0, and
#: the K1 path's shape; each also with a base that is not 16-byte aligned
K1_EDGE_SHAPES = ((1, 1, 8, 8), (3, 4, 10, 130), (1, 3, 16, 67), (4, 1, 16, 64),
                  (24, 1, 256, 1000))


def unaligned(torch, data):
    """A contiguous copy of ``data`` whose base sits 4 bytes past a 16-byte boundary."""
    flat = torch.empty(data.numel() + 1, device=data.device)
    out = flat[1:].view(data.shape)
    out.copy_(data)
    return out


def edge_phase(torch, dev):
    """Both kernels against their plain versions, bit for bit (NaN lanes
    included), on cases the end-to-end paths seldom or never reach. K1:
    lanes at x0 = X - 1 and x0 % 4 == 3, far-out and NaN positions, on
    degenerate T/Z axes, X % 4 != 0 and unaligned bases (K1's 4-byte load
    path). K2: scripted window sequences (z moves of 0, 1, 2 and WZ or more
    planes, a change of half mid-chunk, consecutive chunks with equal
    origins, dead chunks) staged by bulk copies (X = 520) and by the scalar
    path (X = 517), and planned sorted lanes at (2, 6, 40, 1101) (scalar)
    and (1, 1, 64, 1024) with dead chunks."""
    from parcels_tpu_torch.ops import binned_sample as bs
    from parcels_tpu_torch.ops import interp_kernels as ik

    g = torch.Generator(device=dev).manual_seed(9)
    for i, shape in enumerate(K1_EDGE_SHAPES):
        data = torch.rand(shape, generator=g, device=dev)
        pos = ik.edge_positions(shape, 20000, seed=i, device=dev)
        for field in (data, unaligned(torch, data)):
            if not same_bits(torch, ik.fold_sample(field, *pos), ik.fold_sample_plain(data, *pos)):
                raise AssertionError(f"K1 disagrees with its plain version at {shape} "
                                     f"(base offset {field.data_ptr() % 16} B)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for X in (520, 517):
        plan = bs.edge_plans(X, device=dev)
        data = torch.rand((3, 12, 40, X), generator=g, device=dev)
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        if not same_bits(torch, bs.slab_sample(data, plan, counter), bs.slab_sample_plain(data, plan)):
            raise AssertionError(f"K2 disagrees with its plain version on the scripted plan, X {X}")
        if int(counter) != bs.staged_bytes(plan, sms):
            raise AssertionError(f"K2 staged {int(counter)} B on the scripted plan, X {X}; its "
                                 f"rule counted on the host {bs.staged_bytes(plan, sms)} B")
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
        if not same_bits(torch, bs.slab_sample(data, plan), bs.slab_sample_plain(data, plan)):
            raise AssertionError(f"K2 disagrees with its plain version at {shape}")
    torch.cuda.synchronize()
    log(f"[edges] K1 at {K1_EDGE_SHAPES}, aligned and unaligned, with edge positions; K2 on "
        "scripted window sequences at X 520 (bulk copies) and 517 (scalar), staging what the host "
        "counts, planned lanes at "
        "(2,6,40,1101) (scalar) and (1,1,64,1024) with dead chunks: equal to their plain versions")


#: f32 operations per lane of one K3 step, counting each add, multiply,
#: compare, select, division, square root and trig call as one: per stage
#: about 162 adds/multiplies/compares, 9 divisions, 5 square roots and 9 trig
#: calls, plus about 30 for the RK4 combination. The bound keeps this
#: definition; on the card each trig call, division and square root is a
#: sequence of 10-30 instructions, so k3_phase prints beside it the built
#: kernel's hit-path SASS count a lane (ops/sass.hit_path) and the time that
#: count takes to issue at 128 lanes a clock an SM (k3_sass)
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


#: K3 lane counts with a ragged last block of 256 threads (1, 255, 259, 1380
#: lanes), and 4096 lanes on planes whose bases are not 16-byte aligned
K3_EDGE_LANES = (1, 255, 259, 1380)
#: face values scaled so that a lane's divisions and square roots leave the
#: fast paths' operand range (2^-80: every lane; 2^-40 and 2^40: near and
#: past its ends), and every 7th lane with zero velocity (a land cell)
K3_REDO_CASES = ((2.0**-80, 0), (2.0**-40, 0), (2.0**40, 0), (1.0, 7))


def k3_edges(torch, fs, seed=12, dt=600.0):
    """K3 bit for bit against its plain version at ``K3_EDGE_LANES``, on
    unaligned planes, and on 65536 lanes of each ``K3_REDO_CASES`` (which
    take the exact redo: its lanes are counted by the kernel); NaN lanes and
    invalid rows as ``k3_inputs`` makes them."""
    from parcels_tpu_torch.ops.fused_rk4 import fused_rk4_step, fused_rk4_step_plain

    args = (fs.gridset[0].spec.deg2m, 1.0 / float(fs.gridset[0].time[1]), dt)
    cases = [(n, False, 1.0, 0) for n in K3_EDGE_LANES] + [(4096, True, 1.0, 0)]
    cases += [(1 << 16, False, scale, every) for scale, every in K3_REDO_CASES]
    seen = []
    for n, shifted, scale, every in cases:
        rowsT, uvT, state = k3_inputs(torch, fs, n, seed, dt)
        uvT = uvT * scale
        if every:
            uvT[:, ::every] = 0.0
        planes = (rowsT, uvT, state)
        if shifted:
            planes = tuple(unaligned(torch, a) for a in planes)
        counter = torch.zeros(1, dtype=torch.int64, device=rowsT.device)
        out = fused_rk4_step(*planes, *args, redone=counter)
        torch.cuda.synchronize()
        ref = fused_rk4_step_plain(*planes, *args)
        same = int(((out == ref) | (torch.isnan(out) & torch.isnan(ref))).all(dim=0).sum())
        name = (f"{n}{' unaligned' if shifted else ''}"
                f"{f' uv x {scale:g}' if scale != 1.0 else ''}"
                f"{f' zero uv every {every}th' if every else ''}")
        if same != n:
            raise AssertionError(f"K3 at {name} lanes differs from its plain version on "
                                 f"{n - same} lanes")
        seen.append(f"{name}: bitwise-equal lanes {same}, redone {int(counter)}")
    return seen


def k3_phase(torch, fs, n, seed=11, dt=600.0):
    """K3 against its plain version on the card; returns the kernel line."""
    from parcels_tpu_torch.ops import _build
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
    counter = torch.zeros(1, dtype=torch.int64, device=rowsT.device)
    fused_rk4_step(rowsT, uvT, state, *args, redone=counter)
    redone = int(counter)
    ms = cuda_ms(torch, lambda: fused_rk4_step(rowsT, uvT, state, *args))
    queued_ms = cuda_ms(torch, lambda: fused_rk4_step(rowsT, uvT, state, *args), queued=True)
    plain_ms = cuda_ms(torch, lambda: fused_rk4_step_plain(rowsT, uvT, state, *args),
                       reps=3, warmup=1)
    bound_ms, bound_by = bound(n * K3_BYTES_PER_LANE, n * K3_OPS_PER_LANE)
    del rowsT, uvT, state, out
    edges = k3_edges(torch, fs)
    sass = {k: {f: v[f] for f in ("count", "issue_ms", "clock_mhz")}
            for k, v in k3_sass(torch, _build.library("fused_rk4"), n).items()}
    log(f"[K3] lanes {n}: max abs err x/y {err:.3g} deg, bitwise-equal lanes {bitwise} of {n}, "
        f"miss flags differing {miss_diff}, miss share {miss_share:.4f}, lanes redone with the "
        f"exact division and root {redone} (counted by the kernel); kernel {ms:.4f} ms "
        f"({queued_ms:.4f} ms queued behind a spin: device time alone), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}, {K3_BYTES_PER_LANE} B and {K3_OPS_PER_LANE} ops a "
        f"lane); hit-path SASS a lane and its issue time at the top SM clock: {sass}; ptxas: "
        f"{ptxas_lines('fused_rk4')}; edge cases: {edges}; no single library call computes "
        f"this step")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def k3_sass(torch, lib, n, dump=None):
    """Hit-path SASS instructions a lane of each K3 kernel in ``lib``
    (``ops/sass.hit_path``) and the time they take to issue on ``n`` lanes
    at the card's top SM clock; with ``dump``, the SASS is written there."""
    from parcels_tpu_torch.ops import sass

    text = sass.sass_of(lib)
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(text)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_clock_mhz()
    out = {}
    for name, items in sass.functions(text).items():
        hp = sass.hit_path(items)
        out[name] = dict(count=hp["count"], reachable=hp["reachable"],
                         issue_ms=sass.issue_ms(hp["count"], n, sms, mhz), clock_mhz=mhz,
                         top_ops=dict(list(hp["by_op"].items())[:14]))
    return out


def k3_ab(torch, tp, parent_src):
    """K3 of this tree against an earlier K3 (``parent_src``, a copy of its
    csrc/fused_rk4.cu) at phase 7's 2^23 lanes, in turns (parent, this
    tree, this tree, parent), each read back to back and queued; both held
    bit for bit to the plain version; the registers, stack frame and
    hit-path SASS count of both. Writes chiprun_out/k3_ab.json."""
    import ctypes
    from pathlib import Path

    from parcels_tpu_torch.ops import _build
    from parcels_tpu_torch.ops.fused_rk4 import fused_rk4_step, fused_rk4_step_plain

    P, F = ctypes.c_void_p, ctypes.c_float
    n = CONFIG5_LANES
    lib_new = _build.library("fused_rk4")
    lib_old = _build.build_file("fused_rk4_parent", parent_src)
    old = _build.load_symbol(lib_old, "fused_rk4_launch",
                             [P, P, P, P, ctypes.c_longlong, F, F, F, P])
    log(f"[K3 A/B] ptxas: this tree {ptxas_lines('fused_rk4')}, parent "
        f"{ptxas_lines('fused_rk4_parent')}")
    fs5 = config5_fieldset(torch, tp, "cuda")
    fill_velocities(torch, fs5)
    rowsT, uvT, state = k3_inputs(torch, fs5, n, 11)
    spec = fs5.gridset[0].spec
    args = (spec.deg2m, 1.0 / float(fs5.gridset[0].time[1]), 600.0)

    def parent():
        out = torch.empty((8, n), device=rowsT.device)
        f32 = [float(np.float32(a)) for a in args]
        err = old(rowsT.data_ptr(), uvT.data_ptr(), state.data_ptr(), out.data_ptr(), n, *f32,
                  torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent K3 launch failed with cudaError {err}")
        return out

    def new():
        return fused_rk4_step(rowsT, uvT, state, *args)

    ref = fused_rk4_step_plain(rowsT, uvT, state, *args)
    res = {"card": nvidia_smi(), "lanes": n, "parent_src": str(parent_src)}
    counter = torch.zeros(1, dtype=torch.int64, device=rowsT.device)
    fused_rk4_step(rowsT, uvT, state, *args, redone=counter)
    res["new_redone_lanes"] = int(counter)
    for name, fn in (("parent", parent), ("new", new)):
        out = fn()
        torch.cuda.synchronize()
        same = ((out == ref) | (torch.isnan(out) & torch.isnan(ref))).all(dim=0)
        res[f"{name}_bitwise_lanes"] = int(same.sum())
        if int(same.sum()) != n:
            raise AssertionError(f"K3 ({name}) differs from its plain version on "
                                 f"{n - int(same.sum())} lanes")
    del ref, out
    res["new_edges"] = k3_edges(torch, fs5)
    del fs5
    turns = []
    for name, fn in (("parent", parent), ("new", new), ("new", new), ("parent", parent)):
        turns.append(dict(kernel=name, ms=cuda_ms(torch, fn),
                          queued_ms=cuda_ms(torch, fn, queued=True)))
    res["turns"] = turns
    outdir = Path("chiprun_out")
    for name, lib, tag in (("parent", lib_old, "fused_rk4_parent"), ("new", lib_new, "fused_rk4")):
        res[f"{name}_ptxas"] = [ln.strip() for ln in _build.BUILD_LOG.get(tag, "").splitlines()
                                if "registers" in ln or "stack frame" in ln]
        res[f"{name}_sass"] = k3_sass(torch, lib, n, outdir / f"k3_sass_{name}.txt")
    res["bound_ms"] = bound(n * K3_BYTES_PER_LANE, n * K3_OPS_PER_LANE)[0]
    outdir.mkdir(exist_ok=True)
    (outdir / "k3_ab.json").write_text(json.dumps(res, indent=1))
    log(json.dumps(res))
    return res


def _wrappers():
    from parcels_tpu_torch.ops.binned_sample import slab_sample
    from parcels_tpu_torch.ops.flat_rk4 import flat_rk4_step
    from parcels_tpu_torch.ops.fused_rk4 import fused_rk4_step
    from parcels_tpu_torch.ops.interp_kernels import fold_sample

    return {"fold_sample": fold_sample, "slab_sample": slab_sample, "fused_rk4": fused_rk4_step,
            "flat_rk4": flat_rk4_step}


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


#: f32 operations per lane of one K4 step, counted as K3's are: per stage
#: about 114 adds/multiplies/compares/selects, 6 divisions and 5 square
#: roots, plus about 20 for the RK4 combination
K4_OPS_PER_LANE = 4 * (114 + 6 + 5) + 20
#: the JAX micro-benchmark's default N = 10,000,000 floored to its 2048-lane block
K4_LANES = 10_000_000 // 2048 * 2048


def k4_phase(torch):
    """Phase 11: K4 against its plain version, then the micro-benchmark."""
    from parcels_tpu_torch.ops import _build
    from parcels_tpu_torch.ops import flat_rk4 as fr

    n = K4_LANES
    row, uv, scal = fr.synthetic_inputs(n, seed=0, device="cuda", branches=True)
    out = fr.flat_rk4_step(row, uv, scal)
    torch.cuda.synchronize()
    ref = fr.flat_rk4_step_plain(row, uv, scal)
    if not torch.equal(torch.isnan(out), torch.isnan(ref)):
        raise AssertionError("K4: NaN lanes differ from the plain version")
    fin = ~torch.isnan(ref[:2])
    err = float((out[:2] - ref[:2]).abs()[fin].max())
    bitwise = int(((out == ref) | (torch.isnan(out) & torch.isnan(ref))).all(dim=0).sum())
    nan_lanes = int(torch.isnan(ref[0]).sum())
    if bool((out[2:] != 0).any()):
        raise AssertionError("K4: output rows 2-7 are not zero")
    # acceptance: within 1e-5 (the target, equal rounding order, is bit for bit)
    if err > 1e-5:
        raise AssertionError(f"K4 disagrees with its plain version: max abs err {err}")
    del ref
    ms = cuda_ms(torch, lambda: fr.flat_rk4_step(row, uv, scal))
    plain_ms = cuda_ms(torch, lambda: fr.flat_rk4_step_plain(row, uv, scal), reps=3, warmup=1)
    bound_ms, bound_by = bound(n * fr.BYTES_PER_LANE, n * K4_OPS_PER_LANE)
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("flat_rk4", "").splitlines()
             if "registers" in ln or "stack frame" in ln]
    log(f"[K4] lanes {n}: max abs err dx/dy {err:.3g}, bitwise-equal lanes {bitwise} of {n} "
        f"({nan_lanes} NaN lanes); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {fr.BYTES_PER_LANE} B and {K4_OPS_PER_LANE} ops a lane; "
        f"the JAX script's docstring counts 224 B, "
        f"{1e3 * n * 224 / HBM_BYTES_PER_S:.4f} ms); ptxas {ptxas}; no single library call "
        f"computes this step")
    del row, uv, scal, out
    torch.cuda.empty_cache()
    zero_counts()
    mb = fr.micro_bench(n)
    launches = counts()["flat_rk4"]
    log(f"[K4 micro-bench] unit cells, {mb['n']} lanes: kernel {mb['cuda_ms']:.4f} ms "
        f"({mb['n'] / mb['cuda_ms'] / 1e3:.1f} M lane-steps/s), plain {mb['plain_ms']:.4f} ms, "
        f"max abs err {mb['max_abs_err']:.3g}; launches {launches}")
    if launches == 0 or mb["max_abs_err"] > 1e-5:
        raise AssertionError("K4 micro-benchmark: no launch or disagreement")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), launches


#: quickstart 03 (BASELINE config 3): Kh, the particles' start x and the day
KH3, X3, DAY = 100.0, 9.97e5, 86400.0


def delete_oob(particles, fieldset):
    """Quickstart 03's recovery kernel: out-of-bounds particles are deleted."""
    import torch

    from parcels_tpu_torch import StatusCode

    particles.state = torch.where(particles.state == StatusCode.ErrorOutOfBounds,
                                  StatusCode.Delete, particles.state)


def add_diffusivity(fs, kh, dres):
    fs.add_constant_field("Kh_zonal", kh, mesh="flat")
    fs.add_constant_field("Kh_meridional", kh, mesh="flat")
    fs.add_context("dres", dres)
    return fs


def run_config3(tp, device, n, seed=7):
    """Quickstart 03 at ``n`` particles on ``device``; checks its asserts."""
    from parcels_tpu_torch.datasets import simple_UV_dataset

    ds = simple_UV_dataset(dims=(2, 2, 32, 32), mesh="flat")  # +-1e6 m flat box
    fs = add_diffusivity(tp.FieldSet.from_sgrid_conventions(ds, mesh="flat", device=device),
                         KH3, 10000.0)
    pset = tp.ParticleSet(fs, x=np.full(n, X3), y=np.zeros(n), t=np.zeros(n), seed=seed)
    pset.execute([tp.AdvectionDiffusionEM, delete_oob], dt=np.timedelta64(10, "m"),
                 runtime=np.timedelta64(24, "h"))
    survived = len(pset) / n
    y = pset.y
    ratio = float(y.std()) / np.sqrt(2 * KH3 * DAY)
    if not (np.isfinite(pset.x).all() and np.isfinite(y).all()):
        raise AssertionError("config 3: non-finite positions")
    if not (0.2 < survived < 0.8 and 0.7 < ratio < 1.3):
        raise AssertionError(f"config 3: survival share {survived}, y-spread / sqrt(2Kt) {ratio}")
    return pset, dict(survived=survived, spread_ratio=ratio, y_mean=float(y.mean()))


def land_band(ds, rows=slice(100, 112)):
    """Zero U and V over a band of rows: land for the slip interpolators."""
    for c in ("U", "V"):
        ds[c].values[:, :, rows, :] = 0.0
    return ds


def sample_p(torch, fs, x, y):
    """The Stommel streamfunction P at (x, y) on the fieldset's device."""
    fsv = fs.build_views(fs.device_arrays())
    pos = [torch.as_tensor(np.asarray(a, np.float32), device=fs.device) for a in (y, x)]
    zero = torch.zeros_like(pos[0])
    return fsv.P.eval(zero, zero, *pos).cpu().numpy()


def stommel_fieldset(tp, device):
    from parcels_tpu_torch.datasets import stommel_gyre_dataset

    return tp.FieldSet.from_sgrid_conventions(stommel_gyre_dataset(grid_type="C"), mesh="flat",
                                              device=device)


def cgrid_w_fieldset(tp, device, u0=0.05, w0=0.002):
    """A 3-D flat C-grid with uniform (u, 0, w) (the JAX package's
    test_analytical_advection_3d_with_w field)."""
    from parcels_tpu_torch import _sgrid as sgrid
    from parcels_tpu_torch import xrlite as xr

    xdim, ydim, nz = 30, 20, 6
    shape = (2, nz, ydim, xdim)
    ds = xr.Dataset(
        {"U": (["time", "depth", "YG", "XC"], np.full(shape, u0, np.float32)),
         "V": (["time", "depth", "YC", "XG"], np.zeros(shape, np.float32)),
         "W": (["time", "depth", "YC", "XC"], np.full(shape, w0, np.float32))},
        coords={
            "time": (["time"], np.array([np.timedelta64(0, "s"), np.timedelta64(10, "D")]),
                     {"axis": "T"}),
            "depth": (["depth"], np.linspace(0.0, 120.0, nz), {"axis": "Z"}),
            "YC": (["YC"], np.arange(ydim) - 0.5, {"axis": "Y"}),
            "YG": (["YG"], np.arange(ydim, dtype=np.float64), {"axis": "Y"}),
            "XC": (["XC"], np.arange(xdim) - 0.5, {"axis": "X"}),
            "XG": (["XG"], np.arange(xdim, dtype=np.float64), {"axis": "X"}),
            "lat": (["YG"], np.arange(ydim) * 1000.0, {"axis": "Y", "units": "m"}),
            "lon": (["XG"], np.arange(xdim) * 1000.0, {"axis": "X", "units": "m"}),
        },
    )
    meta = sgrid.SGrid2DMetadata(
        node_dimensions=("XG", "YG"), node_coordinates=("lon", "lat"),
        face_dimensions=(sgrid.FaceNodePadding("XC", "XG", sgrid.Padding.LOW),
                         sgrid.FaceNodePadding("YC", "YG", sgrid.Padding.LOW)),
        vertical_dimensions=(sgrid.FaceNodePadding("ZC", "depth", sgrid.Padding.BOTH),),
    )
    return tp.FieldSet.from_sgrid_conventions(sgrid.attach_sgrid_metadata(ds, meta), mesh="flat",
                                              device=device)


def croco_fieldset(tp, device, n=8, nz=6, hc=20.0):
    """The idealized CROCO set of the JAX package's sigma-grid tests, with a
    meridional flow over a sloping bottom under a free surface."""
    from parcels_tpu_torch import xrlite as xr

    extent = 200e3
    x_rho = np.broadcast_to(np.linspace(0, extent, n), (n, n)).copy()
    y_rho = np.broadcast_to(np.linspace(0, extent, n)[:, None], (n, n)).copy()
    s_w = np.linspace(-1.0, 0.0, nz)
    h = np.broadcast_to(np.linspace(80.0, 160.0, n)[:, None], (n, n)).astype(np.float32).copy()
    fields = {
        "U": xr.DataArray(np.full((2, nz, n, n - 1), 1.0, np.float32),
                          dims=("time", "s_rho", "eta_rho", "xi_u"), name="U"),
        "V": xr.DataArray(np.full((2, nz, n - 1, n), 0.3, np.float32),
                          dims=("time", "s_rho", "eta_v", "xi_rho"), name="V"),
        "W": xr.DataArray(np.zeros((2, nz, n, n), np.float32),
                          dims=("time", "s_w", "eta_rho", "xi_rho"), name="W"),
        "h": xr.DataArray(h, dims=("eta_rho", "xi_rho"), name="h"),
        "zeta": xr.DataArray(np.full((2, n, n), 0.4, np.float32),
                             dims=("time", "eta_rho", "xi_rho"), name="zeta"),
        "Cs_w": xr.DataArray((s_w**3).astype(np.float32), dims=("s_w",), name="Cs_w"),
        "omega": xr.DataArray(np.full((2, nz, n, n), 3.3, np.float32),
                              dims=("time", "s_w", "eta_rho", "xi_rho"), name="omega"),
    }
    coords = xr.Dataset(coords={
        "time": (("time",), np.arange(2) * 20000.0, {"units": "seconds"}),
        "x_rho": (("eta_rho", "xi_rho"), x_rho, {"units": "m"}),
        "y_rho": (("eta_rho", "xi_rho"), y_rho, {"units": "m"}),
        "s_w": (("s_w",), s_w),
    })
    fs = tp.FieldSet.from_sgrid_conventions(tp.convert.croco_to_sgrid(fields=fields, coords=coords),
                                            device=device)
    fs.add_context("hc", hc)
    return fs


def card_and_cpu(tp, build, run):
    """``run(build(device))`` on the card, then on the CPU (stage cache
    forced there, as the card runs it); returns both particle sets."""
    a = run(build("cuda"))
    os.environ["PARCELS_TPU_STAGECACHE"] = "force"
    try:
        b = run(build("cpu"))
    finally:
        del os.environ["PARCELS_TPU_STAGECACHE"]
    return a, b


def assert_same(name, a, b, rtol=1e-5, atol=0.0, vars_=("x", "y", "z")):
    for var in vars_:
        np.testing.assert_allclose(getattr(a, var), getattr(b, var), rtol=rtol, atol=atol,
                                   err_msg=f"{name}: {var}")
    np.testing.assert_array_equal(a.state, b.state, err_msg=f"{name}: states")
    return max(float(np.abs(getattr(a, v) - getattr(b, v)).max()) for v in vars_)


#: particles of phase 12 (BASELINE config 3), phase 13 and the card-against-CPU runs
CONFIG3_LANES, EM_LANES, CMP_LANES = 1_000_000, 2_000_000, 1 << 16


def config3_phase(tp):
    """Phase 12: quickstart 03 at config 3's particle count; K1 launches."""
    zero_counts()
    pset, m = run_config3(tp, "cuda", CONFIG3_LANES)
    launches, st = counts(), pset.last_run_stats
    log(f"[config3] quickstart 03, {CONFIG3_LANES} particles, AdvectionDiffusionEM + DeleteOOB, "
        f"Kh 100 m^2/s, dt 10 min for 24 h: survival share {m['survived']:.4f}, y-spread / "
        f"sqrt(2Kt) {m['spread_ratio']:.4f}; particle_steps_per_s {st['particle_steps_per_s']} "
        f"wall_s {st['wall_s']}; launches {launches}")
    if launches["fold_sample"] == 0:
        raise AssertionError("K1 was not launched on the config-3 path")
    return launches["fold_sample"]


def fs_b_with(tp, ds_b, kh, device="cuda"):
    """4(b)'s fieldset with constant diffusivities ``kh`` (dres 2 km, about
    the grid spacing)."""
    return add_diffusivity(tp.FieldSet.from_sgrid_conventions(ds_b, mesh="flat", device=device),
                           kh, 2000.0)


#: 4(b)'s runs: 20 steps of 60 s, particles at 10-490 m
B_RUN = dict(runtime_s=20 * 60, zrange=(10.0, 490.0))


def em_phase(torch, tp, ds_b):
    """Phase 13: Euler-Maruyama on 4(b)'s field (K2 under an RNG kernel);
    with Kh = 0 it equals AdvectionEE."""
    _, launches, st = run_path(torch, tp, fs_b_with(tp, ds_b, KH3), EM_LANES,
                               tp.AdvectionDiffusionEM, seed=6, **B_RUN)
    log(f"[e2e b EM] (2,50,500,500) {EM_LANES} particles AdvectionDiffusionEM Kh 100 m^2/s dt "
        f"60 s 20 steps: launches {launches}; particle_steps_per_s {st['particle_steps_per_s']} "
        f"wall_s {st['wall_s']}")
    if launches["slab_sample"] == 0:
        raise AssertionError("K2 was not launched under AdvectionDiffusionEM")
    fs0 = fs_b_with(tp, ds_b, 0.0)
    em0 = run_path(torch, tp, fs0, EM_LANES, tp.AdvectionDiffusionEM, seed=6, **B_RUN)[0]
    ee = run_path(torch, tp, fs0, EM_LANES, tp.AdvectionEE, seed=6, **B_RUN)[0]
    d = assert_same("EM with Kh = 0 against AdvectionEE", em0, ee, rtol=1e-6)
    log(f"[e2e b EM] Kh = 0 against AdvectionEE, {EM_LANES} particles: max |difference| {d:.3g} m")
    del fs0, em0, ee
    torch.cuda.empty_cache()
    return launches["slab_sample"]


def recorder(torch, rec):
    """A kernel that appends the first three lanes' (x, y) to ``rec``."""
    def Record(particles, fieldset):  # noqa: N802
        rec.append(torch.stack([particles.x, particles.y])[:, :3].cpu().numpy())
    return Record


def analytical_run(tp, fs, seeds, dt_h, hours):
    """AdvectionAnalytical from ``seeds`` (x, y and z)."""
    pset = tp.ParticleSet(fs, t=np.zeros(len(seeds["x"])), **seeds)
    pset.execute(tp.AdvectionAnalytical, dt=np.timedelta64(dt_h, "h"),
                 runtime=np.timedelta64(hours, "h"))
    return pset


#: the JAX package's Stommel seeds (tests/test_advection.py). Random seeds
#: in the gyre can stall: a lane within one f32 step of a face takes a
#: transit of a few seconds that leaves its position unchanged, and repeats
#: it to the end of the run, one engine iteration each time (the JAX
#: scheme's f32 tolerance, ported as it is)
STOMMEL_SEEDS = dict(x=np.array([3e6, 4e6, 5e6]), y=np.array([3e6, 5e6, 7e6]))


def croco_run(tp, fs, n=1024):
    """RK2 on the CROCO sigma grid with omega sampling, 100 steps of 100 s."""
    rng = np.random.default_rng(11)
    pclass = tp.Particle.add_variable(tp.Variable("omega"))
    pset = tp.ParticleSet(fs, pclass=pclass, x=rng.uniform(20e3, 120e3, n),
                          y=rng.uniform(20e3, 120e3, n), z=rng.uniform(-70.0, -5.0, n),
                          t=np.zeros(n))
    pset.execute([tp.AdvectionRK2_3D_CROCO, tp.SampleOmegaCroco],
                 runtime=np.timedelta64(10_000, "s"), dt=np.timedelta64(100, "s"))
    return pset


def card_cpu_phase(torch, tp, ds_b):
    """Phase 14: this slice's kernels on the card against the CPU; returns
    the K1 launches of the slip runs."""
    n = CMP_LANES
    for kern in (tp.AdvectionDiffusionEM, tp.AdvectionDiffusionM1):
        a, b = card_and_cpu(tp, lambda d: fs_b_with(tp, ds_b, 0.0, d),
                            lambda fs, k=kern: run_path(torch, tp, fs, n, k, seed=7, **B_RUN)[0])
        log(f"[card vs cpu] {kern.__name__} Kh = 0, {n} particles, 20 steps on 4(b)'s field: "
            f"max |difference| {assert_same(kern.__name__, a, b):.3g} m")

    ds_s = land_band(flat_dataset((24, 1, 256, 1000), extent=(255e3, 999e3), seed=3))
    k1_slip = 0
    for interp in (tp.XFreeslip, tp.XPartialslip):
        runs, launches = {}, {}
        for d in ("cuda", "cpu"):
            fs = tp.FieldSet.from_sgrid_conventions(ds_s, mesh="flat", device=d)
            fs.fields["UV"].interp_method = interp()
            fs._invalidate_caches()
            runs[d], launches[d], _ = run_path(torch, tp, fs, n, tp.AdvectionRK4, 1200, seed=9)
        k1 = launches["cuda"]["fold_sample"]
        if k1 == 0:
            raise AssertionError(f"K1 was not launched under {interp.__name__}")
        k1_slip += k1
        log(f"[card vs cpu] {interp.__name__} on 4(a)'s field with a land band, {n} particles, "
            f"20 RK4 steps: max |difference| "
            f"{assert_same(interp.__name__, runs['cuda'], runs['cpu']):.3g} m; K1 launches {k1}")

    # the Stommel gyre: the JAX test's asserts on each device (the
    # streamfunction P is conserved along the trajectories, the particles
    # moved). Card against CPU is reported, not held: a lane that ends a
    # jump within one f32 step of a face stays on it or not with the last
    # bit of exp and log, as the JAX package's jitted and eager runs differ.
    # Each jump's start is recorded to show where the devices part
    st, jumps = {}, {}
    for d in ("cuda", "cpu"):
        fs = stommel_fieldset(tp, d)
        jumps[d] = []
        pset = tp.ParticleSet(fs, t=np.zeros(3), **STOMMEL_SEEDS)
        pset.execute([recorder(torch, jumps[d]), tp.AdvectionAnalytical], dt=np.timedelta64(6, "h"),
                     runtime=np.timedelta64(48, "h"))
        p0 = sample_p(torch, fs, STOMMEL_SEEDS["x"], STOMMEL_SEEDS["y"])
        p1 = sample_p(torch, fs, pset.x, pset.y)
        if not np.allclose(p1, p0, rtol=2e-2) or np.allclose(pset.x, STOMMEL_SEEDS["x"], atol=1.0):
            raise AssertionError(f"AdvectionAnalytical on the Stommel gyre ({d}): P {p0} -> {p1}, "
                                 f"x {STOMMEL_SEEDS['x']} -> {pset.x}")
        st[d] = (pset, float(np.abs(p1 - p0).max() / np.abs(p0).max()))
    (a, ra), (b, rb) = st["cuda"], st["cpu"]
    parted = next(((k, np.abs(u - v).max(axis=0).tolist()) for k, (u, v) in
                   enumerate(zip(jumps["cuda"], jumps["cpu"])) if not np.array_equal(u, v)), None)
    log(f"[card vs cpu] AdvectionAnalytical on the Stommel gyre, 3 particles, 8 steps of 6 h: "
        f"P conserved to {ra:.3g} (card), {rb:.3g} (CPU); card x {a.x} y {a.y}, CPU x {b.x} "
        f"y {b.y}; states equal {bool(np.array_equal(a.state, b.state))}; jumps card "
        f"{len(jumps['cuda'])}, CPU {len(jumps['cpu'])}; first jump starting apart (index, "
        f"max |dx|,|dy| per lane): {parted}")

    # a 3-D C-grid with uniform (u, 0, w): card against CPU to 1e-4 of the
    # extent (the port-against-JAX tests' tolerance), and the closed form
    rng = np.random.default_rng(10)
    w_seeds = dict(x=rng.uniform(1500.0, 5000.0, 1024), y=rng.uniform(3000.0, 15000.0, 1024),
                   z=rng.uniform(5.0, 40.0, 1024))
    a, b = card_and_cpu(tp, lambda d: cgrid_w_fieldset(tp, d),
                        lambda fs: analytical_run(tp, fs, w_seeds, 1, 6))
    dmax = assert_same("AdvectionAnalytical 3-D with W", a, b, rtol=0.0, atol=3.0)
    np.testing.assert_allclose(a.x, w_seeds["x"] + 0.05 * 6 * 3600, rtol=1e-4)
    np.testing.assert_allclose(a.z, w_seeds["z"] + 0.002 * 6 * 3600, rtol=1e-3)
    log(f"[card vs cpu] AdvectionAnalytical on a 3-D C-grid with W, 1024 particles, 6 steps: "
        f"max |difference| {dmax:.3g} m; closed form holds on the card")

    a, b = card_and_cpu(tp, lambda d: croco_fieldset(tp, d), lambda fs: croco_run(tp, fs))
    d = assert_same("AdvectionRK2_3D_CROCO", a, b, vars_=("x", "y", "z", "omega"))
    log(f"[card vs cpu] AdvectionRK2_3D_CROCO + SampleOmegaCroco on the idealized CROCO set, "
        f"{len(a)} particles, 100 steps: max |difference| {d:.3g}")

    moments = {d: run_config3(tp, d, n)[1] for d in ("cuda", "cpu")}
    # both meet the quickstart's asserts (run_config3); the card's and the
    # CPU's independent streams agree within 0.02 on both moments (about 7
    # standard errors at 64K particles)
    for k in ("survived", "spread_ratio"):
        if abs(moments["cuda"][k] - moments["cpu"][k]) > 0.02:
            raise AssertionError(f"config 3 at {n}: card and CPU {k} differ: {moments}")
    log(f"[card vs cpu] config 3 at {n} particles (Kh 100 m^2/s): {moments}")
    return k1_slip


#: path (h): the FESOM2-baroclinic-gyre scale of scripts/bench_ux.py
UX_MESH = dict(flow="rotation", placement="node", vertical="zf", nx=1200, ny=1200, nz=48,
               extent=1e6, maxdepth=1000.0)
#: its (faces, nodes, interfaces)
UX_SIZE = (2875202, 1440000, 48)
UX_LANES = 2_000_000
UX_STEPS = 10
UX_TIERS = {
    "auto": {},
    "uxcache off": dict(uxcache="off"),
    "gather": dict(uxcol="off", uxcache="off"),
}


def ux_counts():
    from parcels_tpu_torch._core.uxgrid import lanes
    from parcels_tpu_torch.ops.uxcache import ux_cached_eval as ce

    return dict(host_reads=lanes.host_reads, checked=ce.checked_lanes, misses=ce.misses,
                repairs=ce.repairs, full_evals=ce.full_evals)


def ux_seeds(n, extent, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.uniform(0.3 * extent, 0.7 * extent, n),
                y=rng.uniform(0.3 * extent, 0.7 * extent, n), z=np.full(n, 100.0),
                t=np.zeros(n))


def ux_run(tp, fs, seeds, steps, dt=120, **opts):
    """(pset, stats, UGRID counters) of one execute of ``steps`` RK4 steps."""
    before = ux_counts()
    pset = tp.ParticleSet(fs, **seeds)
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(dt, "s"),
                 runtime=np.timedelta64(steps * dt, "s"), options=tp.EngineOptions(**opts))
    after = ux_counts()
    x, y = pset.x, pset.y
    if not (x.shape == y.shape == seeds["x"].shape and np.isfinite(x).all()
            and np.isfinite(y).all()):
        raise AssertionError("UGRID path: positions are not finite of the expected shape")
    if int((pset.state >= tp.StatusCode.Error).sum()):
        raise AssertionError("UGRID path: particles ended in an error state")
    return pset, pset.last_run_stats, {k: after[k] - before[k] for k in after}


def profile_ux_step(torch, tp, fs, seeds, dt=120):
    """One warm RK4 step of the default tier under torch.profiler: its host
    reads (``aten::_local_scalar_dense`` and ``aten::nonzero`` calls, each a
    device-to-host read), the device busy share of its wall time and the
    largest device entries (ms)."""
    from torch.profiler import ProfilerActivity, profile

    pset = tp.ParticleSet(fs, **seeds)
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(dt, "s"), runtime=np.timedelta64(dt, "s"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(dt, "s"),
                     runtime=np.timedelta64(dt, "s"))
        torch.cuda.synchronize()
    wall = pset.last_run_stats["wall_s"]
    reads, by_name = {}, {}
    for ev in prof.key_averages():
        if ev.key in ("aten::_local_scalar_dense", "aten::nonzero"):
            reads[ev.key] = ev.count
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_name[ev.key] = by_name.get(ev.key, 0.0) + getattr(ev, "self_device_time_total", 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_s=wall, host_reads=reads,
                device_busy_share=sum(by_name.values()) * 1e-6 / wall,
                top_device_ms={k[:60]: round(v * 1e-3, 3) for k, v in top})


def ux_phase(torch, tp):
    """Phase 15: path (h), the UGRID path at FESOM2 scale in three tiers."""
    from parcels_tpu_torch import native
    from parcels_tpu_torch.datasets import delaunay_flow_dataset

    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the native mesh library did not load: the numpy fallbacks "
                             "take many minutes at this scale")
    ds = delaunay_flow_dataset(**UX_MESH)
    t_ds = time.perf_counter() - t0
    fs = tp.FieldSet.from_ugrid_conventions(ds, mesh="flat")
    grid = fs.gridset[0]
    fs.device_arrays()
    torch.cuda.synchronize()
    ingest = time.perf_counter() - t0
    if (grid.spec.n_face, grid.spec.n_node, grid.spec.nz) != UX_SIZE:
        raise AssertionError(f"UGRID mesh {grid!r} is not the FESOM2-scale mesh")
    log(f"[ux ingest] {grid!r}: {ingest:.1f} s ({t_ds:.1f} s Delaunay and fields, "
        f"{ingest - t_ds:.1f} s FieldSet.from_ugrid_conventions with the native raster and "
        f"adjacency, and the device copy)")
    del ds
    extent = UX_MESH["extent"]
    c = extent / 2
    seeds = ux_seeds(UX_LANES, extent, seed=2)
    r0 = np.hypot(seeds["x"] - c, seeds["y"] - c)
    runs = {}
    for tier, opts in UX_TIERS.items():
        _, s1, d1 = ux_run(tp, fs, seeds, 1, **opts)
        pset, s, d = ux_run(tp, fs, seeds, UX_STEPS, **opts)
        order = np.argsort(pset.particle_id)
        runs[tier] = (pset.x[order], pset.y[order], pset.state[order])
        del pset
        torch.cuda.empty_cache()
        r1 = np.hypot(runs[tier][0] - c, runs[tier][1] - c)
        np.testing.assert_allclose(r1, r0, rtol=2e-3)
        checked = d["checked"]
        log(f"[e2e ux {tier}] {UX_LANES} particles RK4 dt 120 s {UX_STEPS} steps: "
            f"particle_steps_per_s {s['particle_steps_per_s']} wall_s {s['wall_s']}; "
            f"a first step alone: wall_s {s1['wall_s']}, {d1['host_reads']} UGRID host reads; "
            f"UGRID host reads per step {d['host_reads'] / UX_STEPS:.1f}; stage cache: miss "
            f"share per stage {d['misses'] / checked if checked else 0.0:.5f}, repairs per step "
            f"{d['repairs'] / UX_STEPS:.1f}, full-batch evals {d['full_evals']}; radius held "
            f"within {np.abs(r1 / r0 - 1).max():.3g} relative")
    ref = runs["auto"]
    for got in runs.values():
        np.testing.assert_array_equal(got[2], ref[2])
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(a, b, rtol=1e-5)
    dmax = max(float(np.abs(a - b).max()) for got in runs.values()
               for a, b in zip(got[:2], ref[:2]))
    log(f"[e2e ux] the three tiers agree: states equal, max |position difference| {dmax:.3g} m")
    prof = profile_ux_step(torch, tp, fs, seeds)
    log(f"[e2e ux profile] one warm RK4 step of the default tier, {UX_LANES} particles: {prof}")
    del fs
    torch.cuda.empty_cache()


def ux_card_cpu_phase(tp):
    """Phase 16: path (i), the card's default tiers against the CPU's forced ones."""
    from parcels_tpu_torch.datasets import delaunay_flow_dataset

    ds = delaunay_flow_dataset(**{**UX_MESH, "nx": 200, "ny": 200})
    seeds = ux_seeds(1 << 16, UX_MESH["extent"], seed=4)
    fs_card = tp.FieldSet.from_ugrid_conventions(ds, mesh="flat")
    a, _, da = ux_run(tp, fs_card, seeds, 6)
    if not da["checked"] or "face_table" not in fs_card.device_arrays()["grids"][0]:
        raise AssertionError("the card's defaults did not run the fused rows and the stage cache")
    fs_cpu = tp.FieldSet.from_ugrid_conventions(ds, mesh="flat", device="cpu")
    b, _, _ = ux_run(tp, fs_cpu, seeds, 6, uxcol="force", uxcache="force")
    np.testing.assert_array_equal(a.state, b.state)
    rel = np.maximum(np.abs(a.x - b.x) / np.abs(b.x), np.abs(a.y - b.y) / np.abs(b.y))
    over = float((rel > 1e-5).mean())
    if over > 1e-3:
        raise AssertionError(f"UGRID card vs CPU: {over:.4%} of lanes beyond 1e-5 relative")
    log(f"[card vs cpu ux] {fs_card.gridset[0]!r}, 64K particles, 6 RK4 steps: states equal, "
        f"max relative position difference {rel.max():.3g}, share beyond 1e-5 {over:.5f}")


#: (j2): path (b)'s regional 3-D model over 13 hourly levels, 2M particles,
#: RK4_3D with out-of-bounds deletion at dt 120 s for 12 h; (j1): path (a)'s
#: surface field (24 hourly levels), 1M particles, RK4 at dt 300 s for 23 h
J2_SHAPE, J2_LANES, J2_DT, J2_HOURS = (13, 50, 500, 500), 2_000_000, 120, 12
J1_LANES, J1_DT, J1_HOURS = 1 << 20, 300, 23
#: levels a window holds
WINDOW = 2


def stream_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "stream")


def streamed_fieldset(tp, path):
    """A fieldset over the zarr store at ``path``, streamed two levels at a time."""
    from parcels_tpu_torch.io import open_zarr_dataset

    fs = tp.FieldSet.from_sgrid_conventions(open_zarr_dataset(path), mesh="flat")
    fs.set_time_window(WINDOW)
    if not getattr(fs.fields["U"].data, "_parcels_lazy", False):
        raise AssertionError("the store's U was not opened lazily")
    return fs


def watch_windows(fs, ds=None):
    """Wrap ``fs.windowed_arrays`` on the instance: host seconds spent inside
    it and the offsets of the windows it served. With ``ds`` (the in-memory
    dataset the store was written from) each window, at its first use, is
    held bit for bit against ``ds``'s levels on the current stream, after
    the wait for its copy (outside the timed span)."""
    rec = {"wait_s": 0.0, "keys": set()}
    inner = fs.windowed_arrays

    def wrapped(t_lo, t_hi):
        t0 = time.perf_counter()
        out = inner(t_lo, t_hi)
        rec["wait_s"] += time.perf_counter() - t0
        key = fs._window_offsets(t_lo, t_hi)
        if ds is not None and key not in rec["keys"]:
            check_window(fs, ds, key, out)
        rec["keys"].add(key)
        return out

    fs.windowed_arrays = wrapped
    return rec


def check_window(fs, ds, key, farrays):
    """The window's field and time tensors equal ``ds``'s levels."""
    import torch

    for name, f in fs.fields.items():
        got = farrays["fields"].get(name)  # scalar fields only
        if got is None or f.data.shape[0] <= 1:
            continue
        i0 = key[f.igrid]
        want = np.asarray(ds[name].values)[i0:i0 + got.shape[0]].reshape(got.shape)
        if not torch.equal(got, torch.from_numpy(np.ascontiguousarray(want)).to(got.device)):
            raise AssertionError(f"window {key}: {name} differs from the dataset's levels")
        t_want = fs.gridset[f.igrid].time[i0:i0 + got.shape[0]].astype(np.float32)
        if not np.array_equal(farrays["grids"][f.igrid]["time"].cpu().numpy(), t_want):
            raise AssertionError(f"window {key}: the time values differ")


def reckoned_stats(tp, fs, keys) -> dict:
    """Loads and bytes the windows at ``keys`` read, from their offsets."""
    loads = nbytes = 0
    for key in keys:
        for f in fs.fields.values():
            if isinstance(f, tp.Field) and f.data.shape[0] > 1:
                n = min(WINDOW, f.data.shape[0] - key[f.igrid])
                loads += 1
                nbytes += n * int(np.prod(f.data.shape[1:])) * f.data.dtype.itemsize
    return {"loads": loads, "bytes_read": nbytes}


def stream_seeds(fs, n, seed, zrange=None):
    """``run_path``'s release: uniform over the middle 80 % of the grid."""
    rng = np.random.default_rng(seed)
    g = fs.gridset[0]
    span = lambda a: (a[0] + 0.1 * (a[-1] - a[0]), a[-1] - 0.1 * (a[-1] - a[0]))  # noqa: E731
    kw = dict(x=rng.uniform(*span(g.lon), n), y=rng.uniform(*span(g.lat), n), t=np.zeros(n))
    if zrange is not None:
        kw["z"] = rng.uniform(*zrange, n)
    return kw


def timed_run(torch, tp, fs, seeds, kernels, dt_s, hours, output_file=None):
    """One execute from ``seeds``; (pset, launches, stats, peak): ``peak`` is
    ``max_memory_allocated`` (reset just before) less what was allocated
    before the run, i.e. what the run itself held at its peak."""
    gc.collect()  # fieldsets of earlier runs (a wrapped method is a cycle)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pset = tp.ParticleSet(fs, **seeds)
    zero_counts()
    pset.execute(kernels, dt=np.timedelta64(dt_s, "s"), runtime=np.timedelta64(hours * 3600, "s"),
                 output_file=output_file)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() - base
    if not (np.isfinite(pset.x).all() and np.isfinite(pset.y).all() and np.isfinite(pset.z).all()):
        raise AssertionError("non-finite positions after a streamed run")
    if int((pset.state >= tp.StatusCode.Error).sum()):
        raise AssertionError("particles ended a streamed run in an error state")
    return pset, launches, pset.last_run_stats, peak


def same_run(name, a, b, rtol=1e-6, atol=1e-3):
    """States and activity equal on every lane, positions within tolerance
    (the JAX windowing test's); returns the largest position difference."""
    np.testing.assert_array_equal(a._data["_active"].cpu().numpy(),
                                  b._data["_active"].cpu().numpy(), err_msg=f"{name}: activity")
    return assert_same(name, a, b, rtol=rtol, atol=atol)


def h2d_ms(torch, nbytes, reps=5) -> float:
    """Device ms of one pinned host-to-device copy of ``nbytes`` on a side
    stream (the copy a window rollover makes)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    stream = torch.cuda.Stream()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps + 1):
        with torch.cuda.stream(stream):
            t0.record(stream)
            host.to("cuda", non_blocking=True)
            t1.record(stream)
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sum(times[1:]) / reps  # the first copy is a warm-up


def spread(a, b, rtol=1e-6, atol=1e-3):
    """(largest position difference, share of lanes beyond rtol/atol)."""
    d = np.max([np.abs(getattr(a, v) - getattr(b, v)) for v in ("x", "y", "z")], axis=0)
    tol = np.max([atol + rtol * np.abs(getattr(b, v)) for v in ("x", "y", "z")], axis=0)
    return float(d.max()), float((d > tol).mean())


def stream_pair(torch, tp, name, ds, path, seeds, kernels, dt_s, hours, kernel):
    """Phase 17 for one path: streamed from the store, then the in-memory
    dataset resident on the card, with equal states and activity
    on every lane and its position spread printed. A resident axis of T
    levels brackets t with the O(1) uniform formula and K1/K2 fold ``index
    + tau`` into one f32, so tau keeps fewer bits than in a 2-level window,
    in both packages alike (``scripts/window_time_spread.py``); a random
    field grows that over a run. ``kernel`` must launch on the streamed run."""
    fs = streamed_fieldset(tp, path)
    rec = watch_windows(fs)
    s_set, s_l, s_st, s_peak = timed_run(torch, tp, fs, seeds, kernels, dt_s, hours)
    want = reckoned_stats(tp, fs, rec["keys"])
    if fs.window_stats != want:
        raise AssertionError(f"{name}: window_stats {fs.window_stats}, reckoned {want}")
    if s_l[kernel] == 0:
        raise AssertionError(f"{name}: {kernel} was not launched on the streamed run")
    nvar = sum(1 for f in fs.fields.values() if isinstance(f, tp.Field) and f.data.shape[0] > 1)
    window_bytes = want["bytes_read"] // max(want["loads"], 1) * nvar
    del fs
    torch.cuda.empty_cache()

    fs = tp.FieldSet.from_sgrid_conventions(ds, mesh="flat")
    r_set, r_l, r_st, r_peak = timed_run(torch, tp, fs, seeds, kernels, dt_s, hours)
    np.testing.assert_array_equal(s_set.state, r_set.state, err_msg=f"{name}: states")
    np.testing.assert_array_equal(s_set._data["_active"].cpu().numpy(),
                                  r_set._data["_active"].cpu().numpy(), err_msg=f"{name}: activity")
    r_max, r_over = spread(s_set, r_set)
    del fs, r_set
    torch.cuda.empty_cache()
    steps = hours * 3600 // dt_s
    log(f"[stream {name}] {len(seeds['x'])} particles, {steps} steps of {dt_s} s, window "
        f"{WINDOW} levels (store just written: reads from the page cache, a pipeline reading, "
        f"not a disk's): streamed particle_steps_per_s {s_st['particle_steps_per_s']} (wall_s "
        f"{s_st['wall_s']}, ms per step {1e3 * s_st['wall_s'] / steps:.2f}), resident "
        f"{r_st['particle_steps_per_s']} (wall_s {r_st['wall_s']}, ms per step "
        f"{1e3 * r_st['wall_s'] / steps:.2f}), streamed/resident "
        f"{s_st['particle_steps_per_s'] / r_st['particle_steps_per_s']:.4f}; peak device memory "
        f"of the run (max_memory_allocated above its start) streamed {s_peak} B, resident "
        f"{r_peak} B (saved {r_peak - s_peak} B); host s in windowed_arrays "
        f"{rec['wait_s']:.4f} over {len(rec['keys'])} windows; window_stats loads "
        f"{want['loads']} bytes_read {want['bytes_read']} (= reckoned); launches streamed "
        f"{s_l}, resident {r_l}; against the resident run: states and activity equal, max |position difference| "
        f"{r_max:.4g} m, share of lanes beyond rtol 1e-6 / atol 1e-3 {r_over:.6f}")
    return dict(streamed=s_set, launches=s_l, stats=s_st, peak=s_peak, resident_stats=r_st,
                resident_peak=r_peak, wait_s=rec["wait_s"], windows=len(rec["keys"]),
                window_bytes=window_bytes)


def memory_windows(torch, tp, name, ds, seeds, kernels, dt_s, hours, streamed):
    """The streamed run equals, bit for bit, the same windows taken from the
    in-memory dataset (the store, the pinned staging and the copy stream
    change nothing end to end, over every window's whole life)."""
    fs = tp.FieldSet.from_sgrid_conventions(ds, mesh="flat")
    fs.set_time_window(WINDOW)
    m_set, _, st, _ = timed_run(torch, tp, fs, seeds, kernels, dt_s, hours)
    equal_runs(f"{name}: streamed against in-memory windows", streamed, m_set)
    log(f"[stream {name}] the same windows from memory (particle_steps_per_s "
        f"{st['particle_steps_per_s']}): equal to the streamed run bit for bit")


def checked_stream(torch, tp, name, ds, path, seeds, kernels, dt_s, hours, streamed):
    """A second streamed run, untimed, whose every window is held bit for bit
    against ``ds``'s levels at its first use; it equals the timed run bit
    for bit."""
    fs = streamed_fieldset(tp, path)
    rec = watch_windows(fs, ds)
    c_set, _, _, _ = timed_run(torch, tp, fs, seeds, kernels, dt_s, hours)
    equal_runs(f"{name}: checked against timed streamed run", streamed, c_set)
    log(f"[stream {name}] a checked streamed run: each of its {len(rec['keys'])} windows equal "
        f"to the dataset's levels on the card; equal to the timed run bit for bit")


def equal_runs(what, a, b):
    for v in ("x", "y", "z", "state"):
        np.testing.assert_array_equal(getattr(a, v), getattr(b, v), err_msg=f"{what}: {v}")


def prefetch_ab(torch, tp, path, seeds, kernels, hours=2):
    """(j2) streamed for ``hours`` without and with the prefetch, in turns
    (without, with, with, without): without it each rollover reads its
    window on the main thread."""
    steps = hours * 3600 // J2_DT
    readings = []
    for prefetch in (False, True, True, False):
        fs = streamed_fieldset(tp, path)
        if not prefetch:
            fs.prefetch_window = lambda t_anchor: None
        rec = watch_windows(fs)
        _, _, st, _ = timed_run(torch, tp, fs, seeds, kernels, J2_DT, hours)
        readings.append(f"{'with' if prefetch else 'without'}: {1e3 * st['wall_s'] / steps:.2f} ms "
                        f"per step, {rec['wait_s']:.4f} s in windowed_arrays")
        del fs
    log(f"[stream j2] {hours} h ({steps} steps, {hours} windows) without and with the prefetch, "
        f"in turns: " + "; ".join(readings))


def stream_phase(torch, tp, ds_a):
    """Phases 17-18: (j2) and (j1) streamed against resident, (j2) with and
    without the prefetch, restart on the card, (j2) streamed card against CPU."""
    from parcels_tpu_torch.io import write_zarr_dataset

    root = stream_dir()
    if os.path.isdir(root):
        shutil.rmtree(root)
    try:
        t0 = time.perf_counter()
        ds_j2 = j2_dataset()
        j2, j1 = os.path.join(root, "j2.zarr"), os.path.join(root, "j1.zarr")
        write_zarr_dataset(ds_j2, j2)
        write_zarr_dataset(ds_a, j1)
        log(f"[stream] wrote {J2_SHAPE} U/V/W and (24, 1, 256, 1000) U/V uncompressed, one level "
            f"a chunk, in {time.perf_counter() - t0:.1f} s")
        kern_j2 = [tp.AdvectionRK4_3D, delete_oob]
        seeds_j2 = stream_seeds(tp.FieldSet.from_sgrid_conventions(ds_j2, mesh="flat"), J2_LANES,
                                seed=6, zrange=(10.0, 490.0))
        j2r = stream_pair(torch, tp, "j2", ds_j2, j2, seeds_j2, kern_j2, J2_DT, J2_HOURS,
                          "slab_sample")
        memory_windows(torch, tp, "j2", ds_j2, seeds_j2, kern_j2, J2_DT, J2_HOURS,
                       j2r["streamed"])

        ms = h2d_ms(torch, j2r["window_bytes"])
        log(f"[stream j2] one window's pinned host-to-device copy: {j2r['window_bytes']} B in "
            f"{ms:.3f} ms ({j2r['window_bytes'] / ms / 1e6:.2f} GB/s)")

        prefetch_ab(torch, tp, j2, seeds_j2, kern_j2)

        seeds_j1 = stream_seeds(tp.FieldSet.from_sgrid_conventions(ds_a, mesh="flat"), J1_LANES,
                                seed=4)
        j1r = stream_pair(torch, tp, "j1", ds_a, j1, seeds_j1, tp.AdvectionRK4, J1_DT, J1_HOURS,
                          "fold_sample")
        memory_windows(torch, tp, "j1", ds_a, seeds_j1, tp.AdvectionRK4, J1_DT, J1_HOURS,
                       j1r["streamed"])
        checked_stream(torch, tp, "j1", ds_a, j1, seeds_j1, tp.AdvectionRK4, J1_DT, J1_HOURS,
                       j1r["streamed"])

        restart_phase(torch, tp, ds_j2, j2, seeds_j2, kern_j2, j2r["streamed"], root)
        stream_card_cpu(tp, j2, kern_j2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return j2r, j1r


def restart_phase(torch, tp, ds, path, seeds, kernels, whole, root):
    """Phase 18: (j2) streamed for 6 h with hourly output, checkpoint, restart
    on a freshly opened streamed fieldset for 6 more hours; equal to the
    uninterrupted 12 h run. The two halves hold each of the 12 windows, at
    its first use, bit for bit against ``ds``'s levels on the card. Then
    from_particlefile on the 6 h output."""
    half = J2_HOURS // 2
    out = os.path.join(root, "j2_half.parquet")
    pf = tp.ParticleFile(out, outputdt=np.timedelta64(1, "h"), mode="w")
    fs = streamed_fieldset(tp, path)
    rec = watch_windows(fs, ds)
    first, _, st1, _ = timed_run(torch, tp, fs, seeds, kernels, J2_DT, half, output_file=pf)
    pf.close()
    ckpt = os.path.join(root, "j2_half.npz")
    t0 = time.perf_counter()
    first.checkpoint(ckpt)
    ck_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = streamed_fieldset(tp, path)
    rec2 = watch_windows(fs, ds)
    resumed = tp.ParticleSet.from_checkpoint(fs, ckpt)
    rs_s = time.perf_counter() - t0
    zero_counts()
    resumed.execute(kernels, dt=np.timedelta64(J2_DT, "s"),
                    runtime=np.timedelta64(half * 3600, "s"))
    l2 = counts()
    if l2["slab_sample"] == 0:
        raise AssertionError("restart: K2 was not launched after the restart")
    dmax = same_run("restart", resumed, whole, rtol=1e-6, atol=0.0)
    bits = all(np.array_equal(getattr(resumed, v), getattr(whole, v)) for v in ("x", "y", "z"))

    restarted = tp.ParticleSet.from_particlefile(streamed_fieldset(tp, path), tp.Particle, out)
    ids = first.particle_id
    order = np.argsort(restarted.particle_id)
    if not np.array_equal(restarted.particle_id[order], np.sort(ids)):
        raise AssertionError("from_particlefile: the ids differ from the 6 h snapshot's")
    by_id = np.argsort(ids)
    for v in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(restarted, v)[order], getattr(first, v)[by_id],
                                      err_msg=f"from_particlefile: {v}")
    log(f"[restart j2] {len(rec['keys'] | rec2['keys'])} windows, each equal to the dataset's "
        f"levels on the card; {len(ids)} live particles after {half} h (hourly output, wall_s "
        f"{st1['wall_s']}); checkpoint {ck_s:.2f} s, from_checkpoint {rs_s:.2f} s; 6 more hours "
        f"equal the uninterrupted 12 h run: states equal, max |position difference| {dmax:.3g} m "
        f"(bit for bit: {bits}); launches after the restart {l2}; from_particlefile: last "
        f"snapshot's ids and positions")


def stream_card_cpu(tp, path, kernels):
    """(j2) streamed at 64K particles for 2 h (60 steps, two rollovers) on the
    card and on the CPU, as phase 5 holds (b)."""
    from parcels_tpu_torch.io import open_zarr_dataset

    runs = {}
    for d in ("cuda", "cpu"):
        fs = tp.FieldSet.from_sgrid_conventions(open_zarr_dataset(path), mesh="flat", device=d)
        fs.set_time_window(WINDOW)
        seeds = stream_seeds(fs, CMP_LANES, seed=7, zrange=(10.0, 490.0))
        runs[d] = tp.ParticleSet(fs, **seeds)
        runs[d].execute(kernels, dt=np.timedelta64(J2_DT, "s"), runtime=np.timedelta64(2, "h"))
        if fs.window_stats["loads"] != 3 * 2:
            raise AssertionError(f"card vs CPU streamed on {d}: window_stats {fs.window_stats}")
    dmax = same_run("j2 card vs cpu", runs["cuda"], runs["cpu"], rtol=1e-5, atol=0.0)
    log(f"[card vs cpu stream j2] {CMP_LANES} particles, 60 RK4_3D steps over two windows: "
        f"states equal, max |position difference| {dmax:.3g} m")


def mark(t_start, done: str):
    log(f"[time] {done} done at {time.perf_counter() - t_start:.1f} s")


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
    if len(sys.argv) == 3 and sys.argv[1] == "--k3-ab":
        k3_ab(torch, tp, sys.argv[2])
        return 0

    build_s = _build.build_all()
    regs = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln] for k, v in _build.BUILD_LOG.items()}
    log(f"[build] {sorted(_build.KERNEL_SOURCES)} in {build_s:.2f} s (nvcc, parallel); ptxas: {regs}")

    k1 = k1_phase(torch, dev)
    k2 = k2_phase(torch, dev)
    edge_phase(torch, dev)

    mark(t_start, "phases 1-3")
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

    mark(t_start, "phase 4")
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

    mark(t_start, "phase 5")
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

    mark(t_start, "phase 6")
    # 7: K3 against its plain version at the config-5 lane count, on rows of
    # the config-5 grid
    t_fs = time.perf_counter()
    fs5 = config5_fieldset(torch, tp, "cuda")
    fill_velocities(torch, fs5)
    torch.cuda.synchronize()
    log(f"[config5] fieldset {CONFIG5} built and filled in {time.perf_counter() - t_fs:.1f} s")
    k3 = k3_phase(torch, fs5, CONFIG5_LANES)
    torch.cuda.empty_cache()

    mark(t_start, "phase 7")
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

    mark(t_start, "phase 8")
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

    mark(t_start, "phase 9")
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
    del fs5
    torch.cuda.empty_cache()

    mark(t_start, "phase 10")
    # 11: K4 against its plain version, then its micro-benchmark path
    k4, l11 = k4_phase(torch)

    mark(t_start, "phase 11")
    # 12-14: config 3, Euler-Maruyama under K2, card against CPU
    l12 = config3_phase(tp)
    l13 = em_phase(torch, tp, ds_b)
    l14 = card_cpu_phase(torch, tp, ds_b)

    mark(t_start, "phases 12-14")
    # 15-16: the UGRID path at FESOM2 scale, then card against CPU on it. The
    # path has no hand-written kernel (the JAX package's is XLA): K1-K4 stay at 0
    zero_counts()
    ux_phase(torch, tp)
    l15 = counts()
    log(f"[e2e ux] launches of K1-K4 on path (h): {l15}")
    if any(l15.values()):
        raise AssertionError("path (h) launched a structured-grid kernel")
    ux_card_cpu_phase(tp)

    mark(t_start, "phases 15-16")
    # 17-18: the store streamed a window at a time against the resident
    # field, (j2) without prefetch, restart on the card, card against CPU
    j2r, j1r = stream_phase(torch, tp, ds_a)

    mark(t_start, "phases 17-18")
    kernels = [
        dict(name="fold_sample", route="cuda", source="parcels_tpu_torch/csrc/fold_sample.cu",
             replaces="parcels_tpu/ops/interp_kernels.py:77", launches=la["fold_sample"],
             launches_by_path={"e2e_a": la["fold_sample"], "cgrid_peninsula": lp["fold_sample"],
                               "config3": l12, "slip": l14,
                               "stream_j1": j1r["launches"]["fold_sample"]},
             **k1),
        dict(name="slab_sample", route="cuda", source="parcels_tpu_torch/csrc/slab_sample.cu",
             replaces="parcels_tpu/ops/binned_sample.py:489", launches=lb["slab_sample"],
             launches_by_path={"e2e_b": lb["slab_sample"], "e2e_b_em": l13,
                               "stream_j2": j2r["launches"]["slab_sample"]}, **k2),
        dict(name="fused_rk4", route="cuda", source="parcels_tpu_torch/csrc/fused_rk4.cu",
             replaces="scripts/bench_fused_rk4.py:134", launches=k9["launches"],
             launches_by_path={"k3_path": k9["launches"]}, **k3),
        dict(name="flat_rk4", route="cuda", source="parcels_tpu_torch/csrc/flat_rk4.cu",
             replaces="scripts/micro_pallas_rk4.py:129", launches=l11,
             launches_by_path={"k4_micro_bench": l11}, **k4),
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

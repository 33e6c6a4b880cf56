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
    within rtol 1e-5, as phase 5;
19. (k) a Copernicus Marine global release, shaped as the product
    GLOBAL_ANALYSISFORECAST_PHY_001_024 (``cmems_mod_glo_phy_anfc_0.083deg_PT1H-m``,
    hourly-mean surface currents at 1/12 degree): native ``uo``/``vo`` with
    CF standard names on (24, 1, 2041, 4320) f32, random velocities in +-1
    m/s, NaN over a synthetic land mask of about 30 % of the cells, made
    from a seed, through ``convert.copernicusmarine_to_sgrid`` and
    ``FieldSet.from_sgrid_conventions`` onto the card (ingest time printed;
    ``memory_report``'s field and grid bytes within 1 % of the allocator's
    rise). 2M particles in a North Atlantic box (80-40 W, 25-45 N),
    AdvectionRK4 at dt 15 min for 12 h with hourly Parquet output and
    ``z`` write-disabled (its column must be absent), ``pset +=`` 1M more,
    ``remove_indices`` of a seeded 10 %, 11 h more (to the day's last
    level); K2 must launch in both halves; ``len``, ``pset[0]`` and
    ``describe`` on the 2.7M set timed, each column copied to the host once;
    the merged run equals a fresh set built from the same lanes at hour
    12 (states equal, positions within rtol 1e-6, bit for bit or not
    printed). Each half also holds K2 against its plain version, bit for
    bit, on the field window and engine-sorted lanes of one of its stages.
    Before it, ``profiling.trace`` of one chunk of path (a): the trace must
    name K1's kernel and the ``annotate`` region;
20. card against CPU at 64K particles for 6 RK4 steps on the three new
    converters' outputs: the ``circulation_models`` mimics at realistic
    widths with seeded random velocities, ``mitgcm_style``'s names at 500
    x 500 x 15 staggered as MITgcm writes a C-grid (U on (Zl, YC, XG), V
    on (Zl, YG, XC), so ``CGrid_Velocity``; past K1's fold, so the binned
    sampler is forced on both devices: rtol 1e-5 and equal states, as phase
    5) and ``delft3d_style`` at ``n=400`` (2-D XZETA/YZETA coordinates, so
    the curvilinear search runs; phase 10's rule scaled to its 100 m cells:
    at most 0.1 % of lanes beyond 0.05 m, equal states elsewhere), and
    (k)'s field through (k)'s add-and-remove sequence (3 steps, += a third,
    10 % removed, 3 steps; binned sampler forced on both devices): states
    equal, positions within rtol 1e-5. Each must launch K2 on the card, and
    K2 is held bit for bit against its plain version on one of its stages;
21. (l) scale-out: (k)'s field banded (``YBandDomain``, halo 3, 2 spare
    slab rows) over 4 ranks spawned on the one card (``torch.multiprocessing``
    ``spawn``; gloo, since NCCL refuses two ranks on one device; a
    ``FileStore`` under ``build/ranks``, new for the phase and deleted after
    it; the kernels built by phase 1, only loaded by the ranks). 8M
    particles over ocean cells of the whole grid, 10 % within 2 rows of an
    interior band edge; RK4 at dt 15 min for 12 h with Parquet output every
    3 h to one file a rank, ``rebalance`` (non-uniform edges, so all2all
    migration), 6 h more. Each rank prints its slab's allocator rise
    beside ``memory_report(bands=4)``'s field bytes (within 2 %), its peak
    memory, K2's overflow share and its launches; K2 must launch on every
    rank in both halves, and rank 0 holds it bit for bit against its plain
    version on one banded stage; lanes must migrate in both halves. Against
    the same seeds on one rank (resident, run by this process on (k)'s
    field before the ranks start): after one step, states equal and every
    lane within rtol 1e-6, atol 1e-4 deg; after 2 more steps in one
    execute, states equal and the same tolerance on every lane below the
    latitude where a step crosses half a zonal cell (``L_COURANT``),
    lanes received in that execute's first migration and stepped on their
    new rank among them (more than 0 required); after 12 and 18 h, states equal
    and at most 1 % of lanes beyond 1e-4 deg (a grid-scale random field is
    chaotic; one rank with the seeds nudged one ulp is printed as the
    control); the rank files hold every particle once at each output time,
    equal the gathered SoA at each half's end and the one-rank file at
    every output time. Printed: particle-steps/s banded and on one rank,
    lanes migrated a step, ``comm_stats()`` and the final gather's seconds,
    the card's used memory before and after the ranks;
22. the other modes over 4 ranks on the card, each against this process's
    one-rank run: a ``ParticleMesh`` on path (a)'s field (1M particles, 1 h
    at dt 60 s), ``XYTileDomain(tiles=(2, 2))`` on (a)'s grid with a
    diagonal 0.5 m/s flow (256K; the closed form) and with a seeded smooth
    field of up to 0.5 m/s (256K), each with K1 launched on every rank and
    held there bit for bit against its plain version on the rank's largest
    recorded call (its slab, its lanes), the config-5 grid banded by cell row (256K particles, 3 RK4
    steps at dt 600 s; phase 10's rule) and phase 16's UGRID mesh under a
    ``ParticleMesh`` (64K, 6 steps at dt 120 s);
23. the JAX package's behaviour tiers on the card (``behaviour_phase``):
    (m), path (a)'s (24, 1, 256, 1000) field and grid on an hourly
    ``360_day`` axis from 2000-02-30, 1M particles, RK4 at dt 60 s for 6 h
    with hourly Parquet output read back as ``360_day`` ``CFDatetime``s
    (K1, 8 launches a step, one recorded call held bit for bit against its
    plain version; particle-steps/s printed beside the card's name and
    power limit); on the card alone, the clock at dt 0.7 s for an hour,
    landing exactly; then the card against the CPU at 64K particles, each
    with equal live-lane counts, ids, states and clocks and positions
    within rtol 1e-5: (m)'s first hour (both Parquet files equal in
    columns, types, metadata, rows, ids and times), the clock from 100 days
    (past 2^23 s) at dt 17.3 s for half an hour and at dt 0.7 s for a
    minute (``t`` landing exactly, bit for bit), backward in time to the start
    (the engine tier's closed form), ``StopAllExecution`` and the Delete
    recovery kernel.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Field data and
particle seeds are random, made from fixed seeds. Exits non-zero without a
result when CUDA is absent or the port cannot be imported.
"""

from __future__ import annotations

import gc
import io
import json
import os
import pathlib
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


def flat_dataset_of(data, extent, taxis=None):
    """An SGRID dataset of the (T, Z, Y, X) arrays in ``data`` on a flat
    rectilinear grid over ``extent`` (m), with hourly levels from
    2000-01-01 unless ``taxis`` gives the time axis."""
    from parcels_tpu_torch import xrlite as xr
    from parcels_tpu_torch.datasets.structured import _coords_2d, _wrap_sgrid

    T, Z, Y, X = next(iter(data.values())).shape
    lon = np.linspace(0.0, extent[1], X)
    lat = np.linspace(0.0, extent[0], Y)
    depth = np.linspace(0.0, 500.0, Z) if Z > 1 else np.array([0.0])
    if taxis is None:
        taxis = np.array([np.datetime64("2000-01-01") + np.timedelta64(3600 * i, "s")
                          for i in range(T)])
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


#: (k): the Copernicus Marine product GLOBAL_ANALYSISFORECAST_PHY_001_024, dataset
#: cmems_mod_glo_phy_anfc_0.083deg_PT1H-m (hourly-mean surface currents at 1/12
#: degree): one day of (time, depth, latitude, longitude)
K_SHAPE = (24, 1, 2041, 4320)
#: the North Atlantic release box (lon, lat), the two releases, dt, and the hours
#: before and after the second release (the day's 24 hourly levels span 23 h)
K_BOX = ((-80.0, -40.0), (25.0, 45.0))
K_FIRST, K_SECOND, K_DT, K_HOURS, K_HOURS_AFTER = 2_000_000, 1_000_000, 900, 12, 11
#: the write-disabled particle variable (every particle sits at the surface)
K_UNWRITTEN = "z"


def land_mask(rng, Y, X):
    """The synthetic land mask of (k): 64-cell blocks of a coarse random
    field under its 30th percentile (the first draws of ``rng``)."""
    coarse = rng.random((Y // 64 + 2, X // 64 + 2))
    return np.kron(coarse < np.quantile(coarse, 0.3), np.ones((64, 64), bool))[:Y, :X]


def copernicus_global_inputs(seed=9, shape=K_SHAPE):
    """``(fields, coords)`` shaped as the product: native ``uo``/``vo`` with
    their CF standard names on (time, depth, latitude, longitude), random
    velocities in +-1 m/s and NaN over a synthetic land mask of about 30 %
    of the cells (64-cell blocks of a coarse random field under its 30th
    percentile), so that the ingest's fill runs."""
    from parcels_tpu_torch import xrlite as xr

    T, Z, Y, X = shape
    rng = np.random.default_rng(seed)
    land = land_mask(rng, Y, X)

    def velocity():
        a = rng.random(shape, dtype=np.float32)
        a *= np.float32(2.0)
        a -= np.float32(1.0)
        a[:, :, land] = np.nan
        return a

    dims = ("time", "depth", "latitude", "longitude")
    fields = {
        name: xr.DataArray(velocity(), dims, {"units": "m s-1", "standard_name": std}, name=name)
        for name, std in (("uo", "eastward_sea_water_velocity"),
                          ("vo", "northward_sea_water_velocity"))
    }
    t0 = np.datetime64("2024-01-01T00:30")
    coords = xr.Dataset(coords={
        "time": (("time",), t0 + np.arange(T) * np.timedelta64(1, "h")),
        "depth": (("depth",), np.array([0.494025])[:Z], {"units": "m", "positive": "down"}),
        "latitude": (("latitude",), np.linspace(-80.0, 90.0, Y), {"units": "degrees_north"}),
        "longitude": (("longitude",), -180.0 + np.arange(X) * (360.0 / X),
                      {"units": "degrees_east"}),
    })
    return fields, coords, float(land.mean())


def box_release(n, rng, t):
    (x0, x1), (y0, y1) = K_BOX
    return dict(x=rng.uniform(x0, x1, n), y=rng.uniform(y0, y1, n), t=np.full(n, float(t)))


def host_copies(tp_ps):
    """Count the particle set's device-to-host column copies (``_host``)."""
    calls = []
    inner = tp_ps._host

    def counted(v):
        calls.append(1)
        return inner(v)

    tp_ps._host = counted
    return calls, lambda: setattr(tp_ps, "_host", inner)


def trace_chunk(torch, tp, fs_a):
    """``profiling.trace`` of one chunk of path (a) (2 RK4 steps at 1M
    particles, inside an ``annotate`` region): the trace names K1's kernel
    and the region."""
    logdir = os.path.join(os.path.dirname(stream_dir()), "trace")
    seeds = stream_seeds(fs_a, 1 << 20, seed=4)
    pset = tp.ParticleSet(fs_a, **seeds)
    zero_counts()
    try:
        with tp.profiling.trace(logdir) as prof:
            with tp.profiling.annotate("path_a_chunk"):
                pset.execute(tp.AdvectionRK4, dt=np.timedelta64(60, "s"),
                             runtime=np.timedelta64(120, "s"))
        launches = counts()["fold_sample"]
        with open(os.path.join(logdir, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
        size = os.path.getsize(os.path.join(logdir, "trace.json"))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    names = [str(e.get("name", "")) for e in events]
    k1 = [e for e in events if "fold_sample_kernel" in str(e.get("name", ""))]
    if pset.last_run_stats["chunks"] != 1:
        raise AssertionError(f"trace: {pset.last_run_stats['chunks']} chunks, not one")
    if "path_a_chunk" not in names or not k1:
        raise AssertionError(f"trace: region in it {'path_a_chunk' in names}, K1 kernel events "
                             f"{len(k1)}")
    k1_us = sum(float(e.get("dur", 0.0)) for e in k1)
    cuda_ops = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[trace a] one chunk (2 RK4 steps, 1M particles): trace.json {size} B, {len(events)} "
        f"events, {cuda_ops} device kernels, {len(k1)} of them K1 ({k1_us:.1f} us), the "
        f"'path_a_chunk' region present; K1 launches counted {launches}; top by device time: "
        + "; ".join(f"{e.key} {e.device_time_total:.0f} us"
                    for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:4]))
    return launches


def k_ingest(torch, tp):
    """(k)'s dataset through ``convert.copernicusmarine_to_sgrid`` and
    ``FieldSet.from_sgrid_conventions`` onto the card; ``memory_report``'s
    field and grid bytes held within 1 % of the allocator's rise."""
    from parcels_tpu_torch import convert

    t0 = time.perf_counter()
    fields, coords, land = copernicus_global_inputs()
    gen_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ds = convert.copernicusmarine_to_sgrid(fields=fields, coords=coords)
    fs = tp.FieldSet.from_sgrid_conventions(ds)
    fs.device_arrays()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    rise = torch.cuda.memory_allocated() - base
    if not (fs.gridset[0].spec.spherical and fs.U.data.shape == K_SHAPE):
        raise AssertionError(f"(k): ingest gave {fs.U.data.shape}, spherical "
                             f"{fs.gridset[0].spec.spherical}")
    if np.isnan(fs.U.data).any():
        raise AssertionError("(k): the land NaNs were not filled")
    rep = fs.memory_report(particles=K_FIRST)
    fg = sum(rep["fields"].values()) + sum(sum(e.values()) for e in rep["grids"])
    total = torch.cuda.get_device_properties(0).total_memory
    if abs(fg - rise) > 0.01 * rise or rep["device_bytes"] != total:
        raise AssertionError(f"(k): memory_report fields+grids {fg} B against a rise of {rise} B")
    log(f"[k ingest] {K_SHAPE} uo/vo (land {land:.3f} of cells) made in {gen_s:.2f} s; converter "
        f"+ FieldSet + device copy {ingest_s:.2f} s; memory_report fields+grids {fg} B, "
        f"allocator rise {rise} B ({(fg - rise) / rise:+.5%}), total with {K_FIRST} particles "
        f"{rep['total']} B (SoA {rep['soa']} B), device_bytes {rep['device_bytes']} (card total "
        f"{total}), fits {rep['fits']}")
    return ds, fs, dict(gen_s=gen_s, ingest_s=ingest_s, report_total=rep["total"],
                        fields_grids=fg, rise=rise)


def binned_calls():
    """Record the binned sampler's calls: each (field shape, lane count)
    with its number of calls, and the (data, gpos) of the last call with
    the most lanes, for ``k2_on_path``. Returns (seen, restore)."""
    from parcels_tpu_torch.ops import binned_sample as bs

    seen = {"calls": {}, "last": None}
    inner = bs.binned_linear_sample

    def recorded(data, gpos):
        key = (tuple(data.shape), int(gpos["X"]["index"].shape[0]))
        seen["calls"][key] = seen["calls"].get(key, 0) + 1
        if seen["last"] is None or key[1] >= seen["last"][1]["X"]["index"].shape[0]:
            seen["last"] = (data, gpos)
        return inner(data, gpos)

    bs.binned_linear_sample = recorded
    return seen, lambda: setattr(bs, "binned_linear_sample", inner)


def k2_on_path(torch, what, seen):
    """K2 against its plain version, bit for bit, at the shapes a main path
    gave it: the field window and engine-sorted lanes of the last stage with
    the most lanes, planned anew with ``_build_plan``. The plan's overflow
    must stay in the fix-up's capacity, so that K2's values are the ones
    kept. Returns a summary for the log."""
    from parcels_tpu_torch.ops import binned_sample as bs

    if seen["last"] is None:
        raise AssertionError(f"{what}: the binned sampler was never called")
    data, gpos = seen["last"]
    shape4, n = tuple(data.shape), int(gpos["X"]["index"].shape[0])
    plan = bs._build_plan(shape4, gpos)
    out = bs.slab_sample(data, plan)
    torch.cuda.synchronize()
    ref = bs.slab_sample_plain(data, plan)
    err = float((out - ref).abs().max())
    if not same_bits(torch, out, ref):
        raise AssertionError(f"{what}: K2 is not bit for bit equal to its plain version at "
                             f"{shape4}, {n} lanes: max abs err {err}")
    k_big = min(n, max(4096, n // bs._K_BIG_DIV))
    if plan["count"] > k_big:
        raise AssertionError(f"{what}: {plan['count']} of {n} lanes overflow K2's slabs (fix-up "
                             f"capacity {k_big}), so the whole batch fell back to the gather")
    ms = cuda_ms(torch, lambda: bs.slab_sample(data, plan), reps=10)
    return (f"K2 at {shape4} on {n} engine-sorted lanes (geometry {bs.slab_geometry(shape4, n)}, "
            f"{plan['npad'] // bs.CHUNK} chunks, overflow share {plan['count'] / n:.5f}): bit for "
            f"bit equal to its plain version (max abs err {err:.3g}), {ms:.4f} ms; sampler calls "
            f"by (shape, lanes): {seen['calls']}")


def k_run(tp, pset, hours, output_file=None, capture=False):
    zero_counts()
    seen, restore = binned_calls() if capture else (None, lambda: None)
    try:
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(K_DT, "s"),
                     runtime=np.timedelta64(hours * 3600, "s"), output_file=output_file)
    finally:
        restore()
    launches = counts()
    if not (np.isfinite(pset.x).all() and np.isfinite(pset.y).all()):
        raise AssertionError("(k): non-finite positions")
    if int((pset.state >= tp.StatusCode.Error).sum()):
        raise AssertionError("(k): particles ended in an error state")
    return launches, pset.last_run_stats, seen


def by_id(pset):
    order = np.argsort(pset.particle_id)
    return {v: getattr(pset, v)[order] for v in ("particle_id", "x", "y", "state")}


def k_phase(torch, tp):
    """Phase 19: (k) a Copernicus Marine global release: 2M particles in a
    North Atlantic box, RK4 at dt 15 min for 12 h with hourly Parquet output
    (one variable write-disabled), ``pset +=`` 1M more, ``remove_indices``
    of a seeded 10 %, 11 h more (to the day's last level); K2 in both
    halves; equal to a fresh set built from the same lanes at hour 12."""
    from parcels_tpu_torch._core import particleset as ps_mod

    ds, fs, ing = k_ingest(torch, tp)
    rng = np.random.default_rng(12)
    out = os.path.join(os.path.dirname(stream_dir()), "k_first.parquet")
    pset = tp.ParticleSet(fs, **box_release(K_FIRST, rng, 0.0))
    pset.set_variable_write_status(K_UNWRITTEN, False)
    pf = tp.ParticleFile(out, outputdt=np.timedelta64(1, "h"), mode="w")
    try:
        l1, s1, seen1 = k_run(tp, pset, K_HOURS, output_file=pf, capture=True)
        pf.close()
        import pyarrow.parquet as pq

        table = pq.read_table(out)
        cols, rows = table.column_names, table.num_rows
    finally:
        if os.path.exists(out):
            os.remove(out)
    if K_UNWRITTEN in cols or "x" not in cols or rows != K_FIRST * (K_HOURS + 1):
        raise AssertionError(f"(k) output: columns {cols}, {rows} rows")
    log(f"[k K2 first half] {k2_on_path(torch, '(k) first half', seen1)}")
    del seen1
    t_mid = K_HOURS * 3600.0
    pset += tp.ParticleSet(fs, **box_release(K_SECOND, rng, t_mid),
                           particle_ids=np.arange(K_FIRST, K_FIRST + K_SECOND))
    n_merged = len(pset)
    pset.remove_indices(np.random.default_rng(13).choice(n_merged, n_merged // 10, replace=False))
    n_live = len(pset)
    if n_merged != K_FIRST + K_SECOND or n_live != n_merged - n_merged // 10:
        raise AssertionError(f"(k): {n_merged} merged, {n_live} live")

    calls, restore = host_copies(ps_mod)
    try:
        ncols = sum(1 for k in pset._data if k != "_rng" and not k.startswith(("_sc_", "_uxc_")))
        t0 = time.perf_counter()
        n = len(pset)
        len_s, len_copies = time.perf_counter() - t0, len(calls)
        t0 = time.perf_counter()
        rec = pset[0]
        get_s, get_copies = time.perf_counter() - t0, len(calls) - len_copies
        buf = io.StringIO()
        t0 = time.perf_counter()
        pset.describe(buf)
        desc_s, desc_copies = time.perf_counter() - t0, len(calls) - len_copies - get_copies
    finally:
        restore()
    if n != n_live or get_copies != ncols or desc_copies != ncols or len_copies:
        raise AssertionError(f"(k): host copies len {len_copies}, pset[0] {get_copies}, describe "
                             f"{desc_copies} for {ncols} columns")
    log(f"[k api] {n_live} live of {n_merged} merged lanes: len {len_s * 1e3:.2f} ms (no column "
        f"copy), pset[0] {get_s * 1e3:.2f} ms ({get_copies} column copies), describe "
        f"{desc_s * 1e3:.2f} ms ({desc_copies} copies, {len(buf.getvalue())} chars); pset[0] = "
        f"{rec!r}; summary {buf.getvalue().splitlines()[2].strip()}")

    fresh = tp.ParticleSet(fs, x=pset.x, y=pset.y, z=pset.z, t=pset.t,
                           particle_ids=pset.particle_id)
    l2, s2, seen2 = k_run(tp, pset, K_HOURS_AFTER, capture=True)
    log(f"[k K2 second half] {k2_on_path(torch, '(k) second half', seen2)}")
    del seen2
    l3, s3, _ = k_run(tp, fresh, K_HOURS_AFTER)
    if l1["slab_sample"] == 0 or l2["slab_sample"] == 0:
        raise AssertionError(f"(k): K2 launches {l1['slab_sample']} and {l2['slab_sample']}")
    a, b = by_id(pset), by_id(fresh)
    np.testing.assert_array_equal(a["particle_id"], b["particle_id"])
    np.testing.assert_array_equal(a["state"], b["state"], err_msg="(k) merged vs fresh: states")
    for v in ("x", "y"):
        np.testing.assert_allclose(a[v], b[v], rtol=1e-6, err_msg=f"(k) merged vs fresh: {v}")
    dmax = max(float(np.abs(a[v] - b[v]).max()) for v in ("x", "y"))
    bits = all(np.array_equal(a[v], b[v]) for v in ("x", "y"))
    steps, steps2 = K_HOURS * 3600 // K_DT, K_HOURS_AFTER * 3600 // K_DT
    log(f"[e2e k] first half: {K_FIRST} particles, {steps} RK4 steps at dt {K_DT} s, hourly "
        f"output ({rows} rows, '{K_UNWRITTEN}' not written): particle_steps_per_s "
        f"{s1['particle_steps_per_s']} wall_s {s1['wall_s']}, launches {l1} "
        f"({l1['slab_sample'] / steps:.2f} K2 a step); second half: {n_live} particles "
        f"after += {K_SECOND} and removing {n_merged // 10}, {steps2} steps: particle_steps_per_s "
        f"{s2['particle_steps_per_s']} wall_s {s2['wall_s']}, launches {l2} "
        f"({l2['slab_sample'] / steps2:.2f} K2 a step); a fresh set from the same lanes: "
        f"particle_steps_per_s {s3['particle_steps_per_s']}, launches {l3}; merged equals "
        f"fresh: states equal, max |position difference| {dmax:.3g} deg (bit for bit: {bits})")
    del pset, fresh
    torch.cuda.empty_cache()
    return ds, fs, dict(ing, first=l1, second=l2, fresh=l3, rate1=s1["particle_steps_per_s"],
                        rate2=s2["particle_steps_per_s"], bits=bits)


def k_add_remove(tp, fs, n, steps=3, options=None):
    """(k)'s sequence at ``n`` particles on ``fs``'s device: two thirds
    released, ``steps`` steps, the rest added, 10 % removed, ``steps``
    more; positions by particle id."""
    rng = np.random.default_rng(14)
    n1 = 2 * n // 3
    pset = tp.ParticleSet(fs, **box_release(n1, rng, 0.0))
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(K_DT, "s"),
                 runtime=np.timedelta64(steps * K_DT, "s"), options=options)
    pset += tp.ParticleSet(fs, **box_release(n - n1, rng, steps * K_DT),
                           particle_ids=np.arange(n1, n))
    pset.remove_indices(np.random.default_rng(15).choice(n, n // 10, replace=False))
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(K_DT, "s"),
                 runtime=np.timedelta64(steps * K_DT, "s"), options=options)
    return pset


def mitgcm_staggered(nx, ny, nz, extent):
    """``circulation_models.mitgcm_style``'s names at a C-grid's staggering,
    as MITgcm writes it: U on the west faces (Zl, YC, XG), V on the south
    faces (Zl, YG, XC), with the centres XC/YC half a cell past the corners
    XG/YG."""
    from parcels_tpu_torch import xrlite as xr
    from parcels_tpu_torch.datasets import circulation_models as cm

    fields, coords = cm.mitgcm_style(nx=nx, ny=ny, nz=nz, extent=extent)
    c = {k: coords[k] for k in coords.coords}
    for centre, corner in (("XC", "XG"), ("YC", "YG")):
        g = np.asarray(coords[corner].values)
        c[centre] = ((centre,), g + 0.5 * (g[1] - g[0]), {"units": "m"})
    dims = {"U": ("time", "Zl", "YC", "XG"), "V": ("time", "Zl", "YG", "XC")}
    return ({k: xr.DataArray(fields[k].values, d, dict(fields[k].attrs), name=k)
             for k, d in dims.items()}, xr.Dataset(coords=c))


def mimic_fieldset(tp, which, device, seed):
    """A ``circulation_models`` mimic at a realistic width through its
    converter, with seeded random velocities (+-0.3 m/s) in place of the
    mimic's constant ones."""
    import warnings

    from parcels_tpu_torch import convert
    from parcels_tpu_torch.datasets import circulation_models as cm

    if which == "mitgcm":
        fields, coords = mitgcm_staggered(nx=500, ny=500, nz=15, extent=5e5)
        conv = convert.mitgcm_to_sgrid
    else:
        fields, coords = cm.delft3d_style(n=400, extent=4e4)
        conv = convert.delft3d_to_sgrid
    rng = np.random.default_rng(seed)
    for name in ("U", "V"):
        fields[name].values[...] = rng.uniform(-0.3, 0.3, fields[name].values.shape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # delft3d_to_sgrid is experimental
        ds = conv(fields=fields, coords=coords)
    return tp.FieldSet.from_sgrid_conventions(ds, mesh="flat", device=device)


def mimic_phase(torch, tp, which, dt_s, options=None, frac=0.8):
    """Card against CPU at 64K particles, 6 RK4 steps, on a mimic (the same
    ``options`` on both devices), released over the central ``frac`` of
    each side; returns the card's launches."""
    runs, launches = {}, None
    for d in ("cuda", "cpu"):
        fs = mimic_fieldset(tp, which, d, seed=16)
        rng = np.random.default_rng(17)
        g = fs.gridset[0]
        lon, lat = np.asarray(g.lon), np.asarray(g.lat)
        span = lambda a: (a.min() + (1 - frac) / 2 * np.ptp(a),  # noqa: E731
                          a.max() - (1 - frac) / 2 * np.ptp(a))
        seeds = dict(x=rng.uniform(*span(lon), CMP_LANES), y=rng.uniform(*span(lat), CMP_LANES),
                     z=rng.uniform(*((5.0, 95.0) if which == "mitgcm" else (-0.9, -0.1)),
                                   CMP_LANES), t=np.zeros(CMP_LANES))
        runs[d] = tp.ParticleSet(fs, **seeds)
        zero_counts()
        seen, restore = binned_calls() if d == "cuda" else (None, lambda: None)
        try:
            runs[d].execute(tp.AdvectionRK4, dt=np.timedelta64(dt_s, "s"),
                            runtime=np.timedelta64(6 * dt_s, "s"), options=options)
        finally:
            restore()
        if d == "cuda":
            launches = counts()
            curvilinear, interp = g.spec.curvilinear, type(fs.UV.interp_method).__name__
            k2 = k2_on_path(torch, f"card vs cpu {which}", seen)
            del seen
    if launches["slab_sample"] == 0:
        raise AssertionError(f"card vs cpu {which}: K2 was not launched on the card")
    a, b = runs["cuda"], runs["cpu"]
    if which == "mitgcm":
        dmax = assert_same(f"card vs cpu {which}", a, b, rtol=1e-5)
        over = 0.0
    else:
        # phase 10's rule on the 100 m cells: 1/2000 of a cell, as phase 10's
        # 1e-4 deg is of its 0.18 deg cell; at most 0.1 % of lanes beyond it
        d = np.maximum(np.abs(a.x - b.x), np.abs(a.y - b.y))
        near = d <= 0.05
        over, dmax = float((~near).mean()), float(d.max())
        if over > 1e-3 or not np.array_equal(a.state[near], b.state[near]):
            raise AssertionError(f"card vs cpu {which}: {over:.4%} of lanes beyond 0.05 m")
    log(f"[card vs cpu {which}] {CMP_LANES} particles, 6 RK4 steps at dt {dt_s} s on "
        f"{a.fieldset.U.data.shape} ({'curvilinear' if curvilinear else 'rectilinear'}, "
        f"{interp}, sampler {options.sampler if options else 'auto'}): max |position "
        f"difference| {dmax:.3g} m, share beyond tolerance {over:.5f}; card launches "
        f"{launches}; {k2}")
    return launches


def convert_phase(torch, tp, ds_k, fs_k):
    """Phase 20: card against CPU on the three converters' outputs. The
    MITgcm C-grid (2, 15, 500, 500) is past K1's fold budget, and 64K lanes
    on it, or on (k)'s field, fall short of the bin plan's fill bar, so
    there the binned sampler is forced on both devices (K2 on the card, its
    plain version on the CPU); the Delft3D mesh takes K2 on its own. The
    MITgcm release covers the central 40 % of each side: over 80 % of them,
    64K lanes leave about 14 % of the lanes outside their chunk's slab,
    past the fix-up's 1/8, and the sampler then gathers the whole batch."""
    from parcels_tpu_torch.ops.interp_kernels import fits_fast_path

    binned = tp.EngineOptions(sampler="binned")
    if fits_fast_path((2, 15, 500, 500)) or fits_fast_path(K_SHAPE):
        raise AssertionError("phase 20: a field meant for K2 fits K1's fold")
    l_mit = mimic_phase(torch, tp, "mitgcm", 300, options=binned, frac=0.4)
    l_delft = mimic_phase(torch, tp, "delft3d", 60)
    fs_cpu = tp.FieldSet.from_sgrid_conventions(ds_k, device="cpu")
    zero_counts()
    seen, restore = binned_calls()
    try:
        a = k_add_remove(tp, fs_k, CMP_LANES, options=binned)
    finally:
        restore()
    l_k = counts()
    if l_k["slab_sample"] == 0:
        raise AssertionError("(k) card vs cpu: K2 was not launched on the card")
    k2 = k2_on_path(torch, "(k) card vs cpu", seen)
    del seen
    b = k_add_remove(tp, fs_cpu, CMP_LANES, options=binned)
    if len(a) != len(b) or len(a) != CMP_LANES - CMP_LANES // 10:
        raise AssertionError(f"(k) card vs cpu: {len(a)} and {len(b)} live particles")
    pa, pb = by_id(a), by_id(b)
    np.testing.assert_array_equal(pa["particle_id"], pb["particle_id"])
    np.testing.assert_array_equal(pa["state"], pb["state"], err_msg="(k) card vs cpu: states")
    for v in ("x", "y"):
        np.testing.assert_allclose(pa[v], pb[v], rtol=1e-5, err_msg=f"(k) card vs cpu: {v}")
    dmax = max(float(np.abs(pa[v] - pb[v]).max()) for v in ("x", "y"))
    log(f"[card vs cpu k] {CMP_LANES} particles, 3 RK4 steps, += {CMP_LANES - 2 * CMP_LANES // 3}, "
        f"10 % removed, 3 more (sampler binned on both): {len(a)} live, states equal, max "
        f"|position difference| {dmax:.3g} deg; card launches {l_k}; {k2}")
    return l_mit, l_delft, l_k


# ---------------------------------------------------------------------------
# Phases 21-22: scale-out over torch.distributed, 4 ranks sharing the card
# ---------------------------------------------------------------------------

#: (l): (k)'s product banded over 4 ranks on one card (gloo; NCCL refuses two
#: ranks on one device): 8M particles over ocean cells of the whole grid
#: (lon within +-170, lat -75..85, 10 % within 2 rows of an interior band
#: edge), RK4 at dt 15 min for 12 h with output every 3 h, a rebalance, 6 h
#: more. The slab's 2 spare rows (``slab_headroom``) give the rebalance room.
L = dict(shape=K_SHAPE, particles=8_000_000, ranks=4, halo=3, headroom=1.25, slab_headroom=2,
         hours=12, hours_after=6, output_h=3, edge_share=0.1, edge_rows=2, dt=K_DT,
         device="cuda", card=True)
#: (l)'s lanes may end beyond the JAX banded tests' 1e-4 deg of the one-rank
#: run at most this share: the field is random at the grid scale, so the
#: trajectories are chaotic and a last-bit difference (a slab brackets
#: latitude by search, the whole grid by its uniform spacing) grows; the
#: first steps are held lane by lane, and a one-ulp nudge of the seeds on one
#: rank is printed beside it as the control
L_DIVERGED_SHARE = 0.01
#: (l)'s lane-by-lane checks: after one step, and after ``L_CHECK_STEPS``
#: (one step, then the rest in one execute, so that the lanes received in
#: its first migrations are stepped on their new rank before the check)
L_CHECK_STEPS = 3
#: the check after ``L_CHECK_STEPS`` steps holds every lane where a step at
#: the field's 1 m/s crosses less than this share of a zonal cell (|lat|
#: below 78.8 deg at 1/12 deg and 15 min). Poleward the cells narrow to
#: 0.8 km, a step crosses a whole cell of a field random at the grid scale,
#: and a last-bit difference grows about tenfold a step: 2 of the 8M lanes,
#: at 84.3-84.8 N and received by no rank, ended 1.2e-4 to 2.3e-4 deg from
#: one rank after 3 steps, and the one-rank run from seeds nudged one ulp
#: put 15 lanes past 1e-4 deg (H100 run). The first step holds every lane.
L_COURANT = 0.5
#: phase 22: (a)'s field under a particle mesh (1M) and (2, 2) tiles with
#: diagonal flow and with a smooth seeded field (256K each), the config-5
#: grid banded (256K, 3 steps at dt 600 s), phase 16's UGRID mesh under a
#: particle mesh (64K, 6 steps at dt 120 s)
P22 = dict(a_shape=(24, 1, 256, 1000), a_extent=(255e3, 999e3), mesh_lanes=1 << 20,
           tile_lanes=1 << 18, diagonal=0.5, c5_shape=CONFIG5, c5_lanes=1 << 18, c5_steps=3,
           ux_nx=200, ux_lanes=1 << 16, ux_steps=6, ranks=4, device="cuda", card=True)
#: seconds a spawned rank may take for its phase
RANK_DEADLINE_S = 900


def ranks_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ranks")


def card_used_mib() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def l_seeds(cfg, seed=21):
    """(l)'s release: ocean cells of the grid, jittered within the cell; a
    share of them within ``edge_rows`` rows of each interior band edge."""
    T, Z, Y, X = cfg["shape"]
    land = land_mask(np.random.default_rng(9), Y, X)[:-1, :-1]  # cells
    lat = np.linspace(-80.0, 90.0, Y)
    lon = -180.0 + np.arange(X) * (360.0 / X)
    rows, cols = np.arange(Y - 1)[:, None], np.arange(X - 1)[None, :]
    ok = (~land & (lat[:-1, None] >= -75.0) & (lat[1:, None] <= 85.0)
          & (lon[None, :-1] >= -170.0) & (lon[None, 1:] <= 170.0))
    band_rows = -(-(Y - 1) // cfg["ranks"])
    edges = band_rows * np.arange(1, cfg["ranks"])
    near = (np.abs(rows - edges[:, None, None]) <= cfg["edge_rows"]).any(0)
    rng = np.random.default_rng(seed)
    n = cfg["particles"]
    n_edge = int(n * cfg["edge_share"])
    pick = np.concatenate([rng.choice(np.flatnonzero(ok & near), n_edge),
                           rng.choice(np.flatnonzero(ok), n - n_edge)])
    r, c = np.divmod(pick, X - 1)
    y = lat[r] + rng.random(n) * (lat[1] - lat[0])
    x = lon[c] + rng.random(n) * (lon[1] - lon[0])
    return dict(x=x, y=y, t=np.zeros(n))


def l_fieldset(tp, cfg):
    from parcels_tpu_torch import convert

    fields, coords, _ = copernicus_global_inputs(shape=cfg["shape"])
    return tp.FieldSet.from_sgrid_conventions(
        convert.copernicusmarine_to_sgrid(fields=fields, coords=coords), device=cfg["device"])


def l_state(pset):
    o = np.argsort(pset.particle_id)
    return {v: getattr(pset, v)[o] for v in ("particle_id", "x", "y", "state")}


def l_execute(tp, pset, hours, cfg, output):
    pf = tp.ParticleFile(output, outputdt=np.timedelta64(cfg["output_h"], "h"), mode="w")
    try:
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(cfg["dt"], "s"),
                     runtime=np.timedelta64(hours, "h"), output_file=pf)
    finally:
        pf.close()
    if not (np.isfinite(pset.x).all() and np.isfinite(pset.y).all()):
        raise AssertionError("(l): non-finite positions")
    if int((pset.state >= tp.StatusCode.Error).sum()):
        raise AssertionError("(l): particles ended in an error state")
    return pset.last_run_stats


def l_reference(torch, tp, fs, cfg=L):
    """(l) on one card, resident (no ranks): the same seeds, halves and
    output; returns its states at 12 h and at the end, and its walls."""
    out = os.path.join(ranks_dir(), "l_ref")
    os.makedirs(out, exist_ok=True)
    seeds = l_seeds(cfg)
    step1, step, _ = l_steps(torch, tp, fs, seeds, cfg)
    # the control: the seeds' latitudes one f32 ulp north, on one rank
    nudged = dict(seeds, y=np.nextafter(seeds["y"].astype(np.float32), np.float32(np.inf)))
    _, step_nudged, _ = l_steps(torch, tp, fs, nudged, cfg)
    pset = tp.ParticleSet(fs, **seeds)
    s1 = l_execute(tp, pset, cfg["hours"], cfg, os.path.join(out, "first.parquet"))
    mid = l_state(pset)
    s2 = l_execute(tp, pset, cfg["hours_after"], cfg, os.path.join(out, "second.parquet"))
    end = l_state(pset)
    del pset
    pset = tp.ParticleSet(fs, **nudged)
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(cfg["dt"], "s"),
                 runtime=np.timedelta64(cfg["hours"], "h"))
    control = diverged("(l) one rank, seeds nudged one ulp, at 12 h", l_state(pset), mid)
    del pset
    if cfg["card"]:
        torch.cuda.empty_cache()
    log(f"[l one rank] {cfg['particles']} particles, resident on one card: first "
        f"{cfg['hours']} h particle_steps_per_s {s1['particle_steps_per_s']} wall_s "
        f"{s1['wall_s']}; {cfg['hours_after']} h more particle_steps_per_s "
        f"{s2['particle_steps_per_s']} wall_s {s2['wall_s']}; the seeds nudged one ulp: "
        f"{control}")
    return dict(step1=step1, step=step, step_nudged=step_nudged, mid=mid, end=end,
                rate1=s1["particle_steps_per_s"],
                rate2=s2["particle_steps_per_s"], control=control)


def l_steps(torch, tp, fs, seeds, cfg, domain=None):
    """(l)'s release after one step and after ``L_CHECK_STEPS``, gathered by
    particle id; on a domain also the ids each migration of the later
    execute brought to this rank (``received_ids``)."""
    pset = tp.ParticleSet(fs, **seeds)
    if domain is not None:
        from parcels_tpu_torch.parallel import shard_particleset

        shard_particleset(pset, domain)

    def run(steps):
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(cfg["dt"], "s"),
                     runtime=np.timedelta64(cfg["dt"] * steps, "s"))

    run(1)
    one = l_state(pset)
    received, restore = received_ids(torch) if domain is not None else ([], lambda: None)
    try:
        run(L_CHECK_STEPS - 1)
    finally:
        restore()
    return one, l_state(pset), received


def l_resolved(y, cfg):
    """Lanes at latitudes where a step at 1 m/s crosses less than
    ``L_COURANT`` of a zonal cell."""
    cell_eq = np.deg2rad(360.0 / cfg["shape"][3]) * 6371e3
    return np.cos(np.deg2rad(y)) * cell_eq * L_COURANT > cfg["dt"] * 1.0


def received_ids(torch):
    """Record the particle ids this rank receives in each step's migration:
    the lanes active after the exchange that were not before it. Returns
    (steps, restore), one array of ids a step."""
    from parcels_tpu_torch.parallel import domain as dm

    steps = []
    inner = dm._exchange

    def recorded(pd, mover, dest, cap, dom, on_send=None):
        before = pd["particle_id"][pd["_active"]]
        out = inner(pd, mover, dest, cap, dom, on_send=on_send)
        after = out[0]["particle_id"][out[0]["_active"]]
        steps.append(after[~torch.isin(after, before)].cpu().numpy())
        return out

    dm._exchange = recorded
    return steps, lambda: setattr(dm, "_exchange", inner)


def diverged(what, got, ref, tol=1e-4):
    """States equal and ids kept; the share of lanes beyond ``tol`` deg and
    the largest difference (a summary for the log)."""
    np.testing.assert_array_equal(got["particle_id"], ref["particle_id"], err_msg=what)
    np.testing.assert_array_equal(got["state"], ref["state"], err_msg=f"{what}: states")
    d = np.maximum(np.abs(got["x"] - ref["x"]), np.abs(got["y"] - ref["y"]))
    return dict(share_beyond=float((d > tol + 1e-6 * np.abs(ref["x"])).mean()),
                max_deg=float(d.max()), median_deg=float(np.median(d)),
                bits=bool(np.array_equal(got["x"], ref["x"]) and np.array_equal(got["y"], ref["y"])))


def k2_overflow_share(seen):
    """Share of the last sampled batch's lanes outside their chunk's slab (the
    fix-up gather's lanes) under the plan K2 would run."""
    from parcels_tpu_torch.ops import binned_sample as bs

    if seen["last"] is None:
        return None
    data, gpos = seen["last"]
    plan = bs._build_plan(tuple(data.shape), gpos)
    return plan["count"] / int(gpos["X"]["index"].shape[0])


def l_rank(cfg):
    """Phase 21 on one rank: build (l)'s field, keep this band's slab, run
    the lane-by-lane check's steps (recording the lanes received) and both
    halves; rank 0 also holds K2 bit for bit against its plain version on
    one banded stage and saves the gathered states."""
    import torch
    import torch.distributed as dist

    import parcels_tpu_torch as tp
    from parcels_tpu_torch.parallel import YBandDomain, shard_particleset

    rank = dist.get_rank()
    card = cfg["card"]
    t0 = time.perf_counter()
    fs = l_fieldset(tp, cfg)
    dom = YBandDomain(fs, n_bands=cfg["ranks"], halo=cfg["halo"], headroom=cfg["headroom"],
                      slab_headroom=cfg["slab_headroom"])
    base = torch.cuda.memory_allocated() if card else 0
    dom.stacked_farrays()
    rise = (torch.cuda.memory_allocated() - base) if card else 0
    report = sum(fs.memory_report(bands=cfg["ranks"])["fields"].values())
    ingest_s = time.perf_counter() - t0
    pset = tp.ParticleSet(fs, **l_seeds(cfg))
    shard_particleset(pset, dom)
    if card:
        torch.cuda.reset_peak_memory_stats()
    out = {"rank": rank, "ingest_s": ingest_s, "rise": rise, "report_fields": report}
    step1, step, received = l_steps(torch, tp, fs, l_seeds(cfg), cfg, dom)
    # the lanes received before the execute's last step were stepped on this rank
    out["received"] = [len(r) for r in received]
    out["received_stepped"] = np.concatenate(received[:-1] or [np.zeros(0, np.int64)])
    out["received_last"] = received[-1] if received else np.zeros(0, np.int64)
    if rank == 0:
        np.savez(os.path.join(ranks_dir(), "l_step1.npz"), **step1)
        np.savez(os.path.join(ranks_dir(), "l_step.npz"), **step)
    names = ("first", "second")
    for half, hours in zip(names, (cfg["hours"], cfg["hours_after"])):
        if half == "second":
            out["edges"] = dom.rebalance(pset.y, pset.x).tolist()
        out[f"mode_{half}"] = dom.migration_mode
        zero_counts()
        seen, restore = binned_calls()
        try:
            stats = l_execute(tp, pset, hours, cfg, os.path.join(ranks_dir(), f"l_{half}.parquet"))
        finally:
            restore()
        out[f"launches_{half}"] = counts()
        out[f"stats_{half}"] = stats
        out[f"overflow_{half}"] = k2_overflow_share(seen)
        if rank == 0 and card:
            out[f"k2_{half}"] = k2_on_path(torch, f"(l) {half} half, rank 0", seen)
        del seen
        if rank == 0:
            np.savez(os.path.join(ranks_dir(), f"l_{half}.npz"), **l_state(pset))
    out["peak"] = torch.cuda.max_memory_allocated() if card else 0
    out["wall_s"] = time.perf_counter() - t0
    return out


def spawn_phase(function, cfg):
    """Run this script's ``function(cfg)`` on ``cfg['ranks']`` spawned gloo
    ranks (``parallel._ranks.RankPool``, every rank on ``cuda:0``); returns
    their results in rank order. A rank that fails or passes the deadline
    fails the phase; every rank is stopped before this returns or raises."""
    from parcels_tpu_torch.parallel._ranks import RankPool

    pool = RankPool(cfg["ranks"], ranks_dir(),
                    threads=max(1, (os.cpu_count() or 4) // cfg["ranks"]),  # a shared host
                    collective_timeout_s=RANK_DEADLINE_S,
                    cuda_device=0 if cfg["card"] else None, grace_s=30.0)
    try:
        return pool.run(pathlib.Path(__file__).stem, function, timeout=RANK_DEADLINE_S, cfg=cfg)
    finally:
        pool.close()


def rows_at_times(paths):
    """(ids, x, y) of the Parquet files ``paths`` by output time, each sorted
    by particle id (pyarrow and numpy)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pa.concat_tables([pq.read_table(p, columns=["particle_id", "t", "x", "y"])
                              for p in paths])
    cols = {k: table.column(k).to_numpy() for k in ("particle_id", "t", "x", "y")}
    order = np.lexsort((cols["particle_id"], cols["t"]))
    cols = {k: v[order] for k, v in cols.items()}
    times, starts = np.unique(cols["t"], return_index=True)
    bounds = list(starts) + [cols["t"].size]
    return {float(t): tuple(cols[k][bounds[i]:bounds[i + 1]] for k in ("particle_id", "x", "y"))
            for i, t in enumerate(times)}


def lanes_off(what, got, ref, received, received_last, cfg, held, rtol=1e-6, atol=1e-4):
    """Log the ``held`` lanes of ``got`` beyond the tolerance of the one-rank
    run ``ref['step']``: their seeds, both positions, where they sit against
    the band edges, whether they were received in a migration, and the
    one-rank run from seeds nudged one ulp on the same lanes."""
    r = ref["step"]
    off = np.flatnonzero(held & np.any([np.abs(got[v] - r[v]) > atol + rtol * np.abs(r[v])
                                        for v in ("x", "y")], axis=0))
    if off.size == 0:
        return
    seeds = l_seeds(cfg)
    lat = np.linspace(-80.0, 90.0, cfg["shape"][2])
    band_rows = -(-(cfg["shape"][2] - 1) // cfg["ranks"])
    edges = lat[band_rows * np.arange(1, cfg["ranks"])]
    nudged = ref["step_nudged"]
    for i in off[:20]:
        pid = int(got["particle_id"][i])
        log(f"[{what} off] id {pid}: seed ({seeds['x'][pid]:.6f}, {seeds['y'][pid]:.6f}); "
            f"banded ({got['x'][i]:.6f}, {got['y'][i]:.6f}) one rank ({r['x'][i]:.6f}, "
            f"{r['y'][i]:.6f}) nudged one rank ({nudged['x'][i]:.6f}, {nudged['y'][i]:.6f}); "
            f"deg to the nearest band edge {float(np.abs(edges - r['y'][i]).min()):.4f}; "
            f"received and stepped {pid in set(received.tolist())}, received at the last "
            f"step {pid in set(received_last.tolist())}")
    log(f"[{what} off] {off.size} lanes; the nudged one-rank run beyond the same tolerance on "
        f"{int(np.any([np.abs(nudged[v] - r[v]) > atol + rtol * np.abs(r[v]) for v in ('x', 'y')], axis=0).sum())} lanes")


def banded_against(what, got, ref, rtol=1e-6, atol=1e-4):
    """States equal and ids kept; positions within the JAX banded tests'
    tolerance (rtol 1e-6, atol 1e-4 on degrees); returns (max, bits)."""
    np.testing.assert_array_equal(got["particle_id"], ref["particle_id"], err_msg=what)
    np.testing.assert_array_equal(got["state"], ref["state"], err_msg=f"{what}: states")
    for v in ("x", "y"):
        np.testing.assert_allclose(got[v], ref[v], rtol=rtol, atol=atol, err_msg=f"{what}: {v}")
    dmax = max(float(np.abs(got[v] - ref[v]).max()) for v in ("x", "y"))
    return dmax, all(np.array_equal(got[v], ref[v]) for v in ("x", "y"))


def l_phase(torch, tp, ref, cfg=L):
    """Phase 21: (l) banded over 4 ranks against ``ref``, (l) on one card
    (``l_reference``, run by the caller, which then frees its field)."""
    from parcels_tpu_torch._core.particlefile import _rank_files

    gc.collect()
    if cfg["card"]:
        torch.cuda.empty_cache()
        log(f"[l] card memory used before the ranks start: {card_used_mib()} (this process "
            f"{torch.cuda.memory_allocated()} B allocated)")
    t1 = time.perf_counter()
    outs = spawn_phase("l_rank", cfg)
    spawn_s = time.perf_counter() - t1
    if cfg["card"]:
        log(f"[l] card memory used after the ranks ended: {card_used_mib()}")
    steps = {"first": cfg["hours"] * 3600 // cfg["dt"],
             "second": cfg["hours_after"] * 3600 // cfg["dt"]}
    expect_gap = (2 * cfg["halo"] + cfg["slab_headroom"]) / -(-cfg["shape"][2] // cfg["ranks"])
    for o in outs:
        gap = o["rise"] / o["report_fields"] - 1 if o["rise"] else float("nan")
        log(f"[l rank {o['rank']}] ingest and slab {o['ingest_s']:.1f} s; slab rise {o['rise']} B "
            f"against memory_report(bands={cfg['ranks']}) fields {o['report_fields']} B "
            f"({gap:+.4%}; halo and spare rows {expect_gap:.4%}); peak allocated {o['peak']} B; "
            f"wall {o['wall_s']:.1f} s; K2 overflow share {o['overflow_first']} / "
            f"{o['overflow_second']}; launches {o['launches_first']} / {o['launches_second']}")
        if cfg["card"]:
            if not 0 <= gap <= 0.02:
                raise AssertionError(f"(l) rank {o['rank']}: slab rise {gap:+.4%} off the report")
            for half in ("first", "second"):
                if o[f"launches_{half}"]["slab_sample"] == 0:
                    raise AssertionError(f"(l) rank {o['rank']}: K2 not launched in the {half} half")
    s = {half: outs[0][f"stats_{half}"] for half in ("first", "second")}
    for half in ("first", "second"):
        st = s[half]
        log(f"[e2e l {half}] {cfg['ranks']} ranks, {st['particles']} particles, {steps[half]} RK4 "
            f"steps: particle_steps_per_s {st['particle_steps_per_s']} wall_s {st['wall_s']} "
            f"(one rank {ref['rate1' if half == 'first' else 'rate2']}); migration "
            f"{outs[0]['mode_' + half]}, migrated lanes {st['migrated_lanes']} "
            f"({st['migrated_per_step']:.1f} a step); rank 0 comm {st['comm']}, of which the "
            f"final gather {st['gather_s']} s")
        if "k2_" + half in outs[0]:
            log(f"[l K2 {half}] {outs[0]['k2_' + half]}")
    for half in ("first", "second"):
        if s[half]["migrated_lanes"] <= 0:
            raise AssertionError(f"(l): no lane migrated in the {half} half")
    if outs[0]["mode_first"] != "neighbor" or outs[0]["mode_second"] != "all2all":
        raise AssertionError(f"(l): migration {outs[0]['mode_first']} then "
                             f"{outs[0]['mode_second']}")
    half_got = {h: dict(np.load(os.path.join(ranks_dir(), f"l_{h}.npz")))
                for h in ("step1", "step", "first", "second")}
    d1, bits1 = banded_against("(l) one step", half_got["step1"], ref["step1"])
    what = f"(l) {L_CHECK_STEPS} steps"
    received = np.concatenate([o["received_stepped"] for o in outs])
    received_last = np.concatenate([o["received_last"] for o in outs])
    got3, ref3 = half_got["step"], ref["step"]
    np.testing.assert_array_equal(got3["particle_id"], ref3["particle_id"], err_msg=what)
    np.testing.assert_array_equal(got3["state"], ref3["state"], err_msg=f"{what}: states")
    held = l_resolved(ref3["y"], cfg)
    lanes_off(what, got3, ref, received, received_last, cfg, held)
    d0, bits0 = banded_against(f"{what}, lanes held", {k: v[held] for k, v in got3.items()},
                               {k: v[held] for k, v in ref3.items()})
    polar = diverged(f"{what}, poleward lanes", {k: v[~held] for k, v in got3.items()},
                     {k: v[~held] for k, v in ref3.items()}) if not held.all() else "none"
    mine = np.isin(got3["particle_id"], received) & held
    if not mine.any():
        raise AssertionError(f"{what}: no lane was received and then stepped on its new rank")
    d_recv = max(float(np.abs(got3[v][mine] - ref3[v][mine]).max()) for v in ("x", "y"))
    div = {h: diverged(f"(l) {h}", half_got[h], ref[k])
           for h, k in (("first", "mid"), ("second", "end"))}
    for h, dv in div.items():
        if dv["share_beyond"] > L_DIVERGED_SHARE:
            raise AssertionError(f"(l) {h}: {dv['share_beyond']:.4%} of lanes beyond 1e-4 deg "
                                 f"of one rank (control {ref['control']})")
    # the union of the rank files: every particle once at each output time, the
    # gathered SoA at the last one, the one-rank run's file at every one
    worst = 0.0
    for half, state in (("first", half_got["first"]), ("second", half_got["second"])):
        parts = _rank_files(pathlib.Path(ranks_dir()) / f"l_{half}.parquet")
        union = rows_at_times(parts)
        one = rows_at_times([os.path.join(ranks_dir(), "l_ref", f"{half}.parquet")])
        if len(parts) != cfg["ranks"] or sorted(union) != sorted(one):
            raise AssertionError(f"(l) {half}: {len(parts)} rank files, times {sorted(union)}")
        for t, (ids, x, y) in union.items():
            rid, rx, ry = one[t]
            np.testing.assert_array_equal(ids, rid, err_msg=f"(l) {half} at {t}: ids")
            d = np.maximum(np.abs(x - rx), np.abs(y - ry))
            if float((d > 1e-4 + 1e-6 * np.abs(rx)).mean()) > L_DIVERGED_SHARE:
                raise AssertionError(f"(l) {half} at {t}: the rank files and the one-rank "
                                     "file differ beyond the divergence share")
            worst = max(worst, float(d.max()))
        ids, x, y = union[max(union)]
        act = state["particle_id"]
        if not (np.array_equal(ids, act) and np.array_equal(x, state["x"].astype(x.dtype))
                and np.array_equal(y, state["y"].astype(y.dtype))):
            raise AssertionError(f"(l) {half}: the rank files at the last output time are not "
                                 "the gathered SoA")
    for o in outs:
        for half in ("first", "second"):
            os.remove(os.path.join(ranks_dir(), f"l_{half}.{o['rank']}.parquet"))
    shutil.rmtree(os.path.join(ranks_dir(), "l_ref"), ignore_errors=True)
    for h in ("step1", "step", "first", "second"):
        os.remove(os.path.join(ranks_dir(), f"l_{h}.npz"))
    log(f"[l] against one rank: after one step states equal and positions within rtol 1e-6, "
        f"atol 1e-4 deg on every lane (max {d1:.3g} deg, bit for bit: {bits1}); after "
        f"{L_CHECK_STEPS} steps states equal, and within that tolerance on the {int(held.sum())} "
        f"lanes below |lat| where a step crosses {L_COURANT} of a zonal cell (max {d0:.3g} deg, "
        f"bit for bit: {bits0}), {int(mine.sum())} of them received in the second execute's "
        f"first migration and stepped on their new rank (max {d_recv:.3g} deg; received a step "
        f"by rank {[o['received'] for o in outs]}); the {int((~held).sum())} lanes poleward "
        f"{polar}; states "
        f"equal at 12 h ({div['first']}) and at the end ({div['second']}); one rank with the "
        f"seeds nudged one ulp: {ref['control']}; the rank files: every output time once, the "
        f"gathered SoA at each half's end, the one-rank file within {worst:.3g} deg; "
        f"rebalanced edges {outs[0]['edges']}; ranks {spawn_s:.1f} s")
    return dict(outs=outs, ref=ref, step1=(d1, bits1), step=(d0, bits0), div=div)


def span_seeds(shape, extent, n, seed):
    """Seeds over the inner 80 % of a flat grid of ``extent``, as ``run_path``'s."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.0, extent[0], shape[2])
    lon = np.linspace(0.0, extent[1], shape[3])
    span = lambda a: (a[0] + 0.1 * (a[-1] - a[0]), a[-1] - 0.1 * (a[-1] - a[0]))  # noqa: E731
    return dict(x=rng.uniform(*span(lon), n), y=rng.uniform(*span(lat), n), t=np.zeros(n))


def smooth_dataset(shape, extent, seed, amp=0.5):
    """A flat U/V dataset of four seeded plane waves a component
    (wavelengths 40-200 km, phases drifting over the levels), at most
    ``amp`` m/s: neighbouring cells differ by up to 0.08 m/s, and a
    last-bit difference between two runs does not grow over an hour."""
    rng = np.random.default_rng(seed)
    T, Z, Y, X = shape
    y = np.linspace(0.0, extent[0], Y)[:, None]
    x = np.linspace(0.0, extent[1], X)[None, :]
    data = {}
    for c in ("U", "V"):
        k = 2 * np.pi / rng.uniform(40e3, 200e3, (4, 2)) * rng.choice([-1.0, 1.0], (4, 2))
        phase, drift = rng.uniform(0.0, 2 * np.pi, 4), rng.uniform(0.05, 0.3, 4)
        a = np.empty(shape, np.float32)
        for t in range(T):
            a[t] = (amp / 4) * sum(np.sin(k[m, 0] * x + k[m, 1] * y + phase[m] + drift[m] * t)
                                   for m in range(4))
        data[c] = a
    return flat_dataset_of(data, extent)


def p22_inputs(tp, cfg, which):
    """The fieldset and seeds of one phase-22 run, made from seeds as the
    parent and every rank make them."""
    dev = cfg["device"]
    if which in P22_K1_RUNS:
        if which == "mesh":
            ds = flat_dataset(cfg["a_shape"], extent=cfg["a_extent"], seed=3)
            n = cfg["mesh_lanes"]
        elif which == "tiles":
            u = np.full(cfg["a_shape"], cfg["diagonal"], np.float32)
            ds = flat_dataset_of({"U": u, "V": u.copy()}, cfg["a_extent"])
            n = cfg["tile_lanes"]
        else:
            ds = smooth_dataset(cfg["a_shape"], cfg["a_extent"], seed=6)
            n = cfg["tile_lanes"]
        fs = tp.FieldSet.from_sgrid_conventions(ds, mesh="flat", device=dev)
        return (fs, span_seeds(cfg["a_shape"], cfg["a_extent"], n, 4), tp.AdvectionRK4, 60,
                60)
    if which == "c5":
        fs = config5_fieldset(None, tp, dev, shape=cfg["c5_shape"])
        rng = np.random.default_rng(3)
        for name in ("U", "V"):
            a = rng.random(fs.fields[name].data.shape, dtype=np.float32)
            a *= np.float32(0.6)
            a -= np.float32(0.3)
            fs.fields[name].data = a
        fs._invalidate_caches()
        return fs, config5_seeds(cfg["c5_lanes"], seed=5), tp.AdvectionRK4, 600, cfg["c5_steps"]
    from parcels_tpu_torch.datasets import delaunay_flow_dataset

    ds = delaunay_flow_dataset(**{**UX_MESH, "nx": cfg["ux_nx"], "ny": cfg["ux_nx"]})
    fs = tp.FieldSet.from_ugrid_conventions(ds, mesh="flat", device=dev)
    return (fs, ux_seeds(cfg["ux_lanes"], UX_MESH["extent"], seed=4), tp.AdvectionRK4, 120,
            cfg["ux_steps"])


def p22_run(tp, cfg, which, sharder=None):
    fs, seeds, kernel, dt, steps = p22_inputs(tp, cfg, which)
    pset = tp.ParticleSet(fs, **seeds)
    if sharder is not None:
        from parcels_tpu_torch.parallel import shard_particleset

        shard_particleset(pset, sharder(fs))
    zero_counts()
    seen, restore = fold_calls() if which in P22_K1_RUNS and cfg["card"] else (None, None)
    try:
        pset.execute(kernel, dt=np.timedelta64(dt, "s"), runtime=np.timedelta64(dt * steps, "s"))
    finally:
        if restore is not None:
            restore()
    launches = counts()
    if int((pset.state >= tp.StatusCode.Error).sum()):
        raise AssertionError(f"phase 22 {which}: particles ended in an error state")
    state = l_state(pset)
    state["z"] = pset.z[np.argsort(pset.particle_id)]
    k1 = k1_on_path(f"phase 22 {which}", seen) if seen is not None else None
    return state, launches, pset.last_run_stats, k1


def fold_calls():
    """Record the interpolator's calls that K1 serves (``fits_fast_path``):
    each (field shape, lane count) with its number of calls, and the (data,
    gpos) of the last call with the most lanes, for ``k1_on_path``. Returns
    (seen, restore)."""
    from parcels_tpu_torch.interpolators import xinterp
    from parcels_tpu_torch.ops.interp_kernels import fits_fast_path

    seen = {"calls": {}, "last": None}
    inner = xinterp._linear_sample

    def recorded(data, gpos, *args, **kwargs):
        if fits_fast_path(tuple(data.shape)):
            key = (tuple(data.shape), int(gpos["X"]["index"].shape[0]))
            seen["calls"][key] = seen["calls"].get(key, 0) + 1
            if seen["last"] is None or key[1] >= seen["last"][1]["X"]["index"].shape[0]:
                seen["last"] = (data, gpos)
        return inner(data, gpos, *args, **kwargs)

    xinterp._linear_sample = recorded
    return seen, lambda: setattr(xinterp, "_linear_sample", inner)


def k1_on_path(what, seen):
    """K1 against its plain version, bit for bit, on the field (a rank's
    slab) and lanes of the last recorded call with the most lanes."""
    import torch

    from parcels_tpu_torch.ops import interp_kernels as ik

    if seen["last"] is None:
        raise AssertionError(f"{what}: K1 was never called")
    data, gpos = seen["last"]
    pos = ik.positions_from_gpos(gpos, tuple(data.shape))
    out = ik.fold_sample(data, *pos)
    ref = ik.fold_sample_plain(data, *pos)
    err = float((out - ref).abs().max())
    if not same_bits(torch, out, ref):
        raise AssertionError(f"{what}: K1 is not bit for bit equal to its plain version at "
                             f"{tuple(data.shape)}, {pos[0].shape[0]} lanes: max abs err {err}")
    return (f"K1 at {tuple(data.shape)} on {pos[0].shape[0]} lanes bit for bit equal to its "
            f"plain version (max abs err {err:.3g}); calls by (shape, lanes): {seen['calls']}")


P22_K1_RUNS = ("mesh", "tiles", "tiles_smooth")
P22_RUNS = (*P22_K1_RUNS, "c5", "ux")


def p22_rank(cfg):
    import torch
    import torch.distributed as dist

    import parcels_tpu_torch as tp
    from parcels_tpu_torch.parallel import ParticleMesh, XYTileDomain, YBandDomain

    rank = dist.get_rank()
    sharders = {
        "mesh": lambda fs: ParticleMesh(n_devices=cfg["ranks"], devices=cfg["device"]),
        "tiles": lambda fs: XYTileDomain(fs, tiles=(2, 2), halo=2),
        "tiles_smooth": lambda fs: XYTileDomain(fs, tiles=(2, 2), halo=2),
        "c5": lambda fs: YBandDomain(fs, n_bands=cfg["ranks"], halo=3),
        "ux": lambda fs: ParticleMesh(n_devices=cfg["ranks"], devices=cfg["device"]),
    }
    out = {"rank": rank}
    for which in P22_RUNS:
        t0 = time.perf_counter()
        if cfg["card"]:
            torch.cuda.reset_peak_memory_stats()
        state, launches, stats, k1 = p22_run(tp, cfg, which, sharders[which])
        if rank == 0:
            np.savez(os.path.join(ranks_dir(), f"p22_{which}.npz"), **state)
        out[which] = dict(launches=launches, stats=stats, wall_s=time.perf_counter() - t0,
                          peak=torch.cuda.max_memory_allocated() if cfg["card"] else 0, k1=k1)
        if cfg["card"]:
            torch.cuda.empty_cache()
    return out


def p22_phase(torch, tp, cfg=P22):
    """Phase 22: the particle mesh, tile and config-5 band modes and the
    UGRID mesh under a particle mesh, each against its one-rank run."""
    t0 = time.perf_counter()
    outs = spawn_phase("p22_rank", cfg)
    spawn_s = time.perf_counter() - t0
    results = {}
    for which in P22_RUNS:
        ref, ref_launches, ref_stats, ref_k1 = p22_run(tp, cfg, which)
        got = dict(np.load(os.path.join(ranks_dir(), f"p22_{which}.npz")))
        os.remove(os.path.join(ranks_dir(), f"p22_{which}.npz"))
        if cfg["card"]:
            torch.cuda.empty_cache()
        np.testing.assert_array_equal(got["particle_id"], ref["particle_id"])
        if which == "c5":
            # phase 10's rule: a tolerance-edge lane (on the +-2e-4 in-cell
            # edge) may pick the neighbouring cell; at most 0.1 % of lanes
            d = np.maximum(np.abs(got["x"] - ref["x"]), np.abs(got["y"] - ref["y"]))
            near = d <= 1e-4
            over = float((~near).mean())
            if over > 1e-3 or not np.array_equal(got["state"][near], ref["state"][near]):
                raise AssertionError(f"phase 22 c5: {over:.4%} of lanes beyond 1e-4 deg")
            verdict = f"share beyond 1e-4 deg {over:.5f}, max {float(d.max()):.3g} deg"
        else:
            np.testing.assert_array_equal(got["state"], ref["state"])
            atol = 1e-4 if which == "ux" else 1e-3
            for v in ("x", "y", "z"):
                np.testing.assert_allclose(got[v], ref[v], rtol=1e-6, atol=atol,
                                           err_msg=f"phase 22 {which}: {v}")
            bits = all(np.array_equal(got[v], ref[v]) for v in ("x", "y", "z"))
            dmax = max(float(np.abs(got[v] - ref[v]).max()) for v in ("x", "y", "z"))
            verdict = f"states equal, max |position difference| {dmax:.3g} (bit for bit: {bits})"
        if which == "tiles":
            seeds = span_seeds(cfg["a_shape"], cfg["a_extent"], cfg["tile_lanes"], 4)
            move = cfg["diagonal"] * 3600.0
            for v in ("x", "y"):
                np.testing.assert_allclose(got[v], seeds[v] + move, rtol=1e-5)
            verdict += f"; the closed form (+{move:.0f} m on x and y) within rtol 1e-5"
        per_rank = [o[which]["launches"] for o in outs]
        st = outs[0][which]["stats"]
        results[which] = dict(per_rank=per_rank, ref_launches=ref_launches)
        log(f"[e2e p22 {which}] {cfg['ranks']} ranks: particle_steps_per_s "
            f"{st['particle_steps_per_s']} wall_s {st['wall_s']} (one rank "
            f"{ref_stats['particle_steps_per_s']}); migrated {st.get('migrated_lanes', 0)}; "
            f"per-rank launches {per_rank}, peak allocated "
            f"{[o[which]['peak'] for o in outs]} B; against one rank: {verdict}")
        if cfg["card"] and which in P22_K1_RUNS:
            if any(p["fold_sample"] == 0 for p in per_rank):
                raise AssertionError(f"phase 22 {which}: K1 not launched on every rank")
            for o in outs:
                log(f"[p22 {which} K1 rank {o['rank']}] {o[which]['k1']}")
            log(f"[p22 {which} K1 one rank] {ref_k1}")
        if which in ("tiles", "tiles_smooth") and st["migrated_lanes"] <= 0:
            raise AssertionError(f"phase 22 {which}: no lane migrated")
    log(f"[p22] ranks {spawn_s:.1f} s, one-rank runs {time.perf_counter() - t0 - spawn_s:.1f} s")
    return results


#: phase 23 (m): path (a)'s shape and grid on a 360_day calendar, from a day
#: only that calendar has; 1M particles, RK4 at dt 60 s for 6 h, hourly output
M_SHAPE = (24, 1, 256, 1000)
M_EXTENT = (255e3, 999e3)
M_START = (2000, 2, 30)
M_LANES = 1 << 20
M_HOURS = 6
#: phase 23's card-against-CPU runs: 64K particles; (m) there runs its first
#: hour, the past-cliff clock half an hour and the sub-second dt a minute, so
#: that the CPU side stays within the phase's minute (the card runs the
#: sub-second dt's whole hour as well)
M_CPU_LANES = 1 << 16
#: the past-cliff clock case: a start of 100 days (8.64e6 s > 2^23 s, where
#: the f32 step of t is 1 s) and the engine tier's dt of 17.3 s
CLIFF_T0_S = 100 * 86400.0
CLIFF_DT = np.timedelta64(17300, "ms")


def m_dataset(seed=23):
    """(m)'s field: path (a)'s random hourly currents on a 360_day axis."""
    from datetime import timedelta

    from parcels_tpu_torch._core.calendars import CFDatetime

    start = CFDatetime(*M_START, calendar="360_day")
    taxis = np.asarray([start + timedelta(hours=i) for i in range(M_SHAPE[0])], dtype=object)
    rng = np.random.default_rng(seed)
    data = {c: rng.uniform(-0.3, 0.3, M_SHAPE).astype(np.float32) for c in ("U", "V")}
    return flat_dataset_of(data, M_EXTENT, taxis=taxis), start


def m_run(tp, fs, n, hours, path, seed=24):
    """(m)'s release of ``n`` particles over the inner 80 % of the grid, RK4
    at dt 60 s for ``hours``, with hourly Parquet output to ``path``."""
    rng = np.random.default_rng(seed)
    pset = tp.ParticleSet(fs, x=rng.uniform(0.1 * M_EXTENT[1], 0.9 * M_EXTENT[1], n),
                          y=rng.uniform(0.1 * M_EXTENT[0], 0.9 * M_EXTENT[0], n), t=np.zeros(n))
    pf = tp.ParticleFile(path, outputdt=np.timedelta64(1, "h"), mode="w")
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(60, "s"), runtime=np.timedelta64(hours, "h"),
                 output_file=pf)
    pf.close()
    return pset


def m_times(tp, path, start, hours, rows_per_time):
    """(m)'s file read back: ``rows_per_time`` rows at each hour from
    ``start`` to ``hours``, each decoded as that hour's 360_day
    ``CFDatetime``. Returns the rows read."""
    from datetime import timedelta

    import pyarrow.parquet as pq

    decoded = tp.read_particlefile(path)["t"].to_numpy()
    secs, first, per = np.unique(pq.read_table(path, columns=["t"]).column("t").to_numpy(),
                                 return_index=True, return_counts=True)
    want = [start + timedelta(hours=h) for h in range(hours + 1)]
    got = list(decoded[first])
    if (list(secs) != [3600.0 * h for h in range(hours + 1)] or set(per) != {rows_per_time}
            or got != want or {t.calendar for t in got} != {"360_day"}):
        raise AssertionError(f"(m): output times {got} at {secs} s with {set(per)} rows each, "
                             f"expected {want} with {rows_per_time}")
    return len(decoded)


def same_parquet(name, a, b, rtol=1e-5):
    """Two trajectory files of one run on the card and on the CPU: equal
    columns, types, file and column metadata, row counts, ids and times; the
    other values within ``rtol`` in (t, particle_id) order. Returns the
    largest difference."""
    import pyarrow.parquet as pq

    ta, tb = pq.read_table(a), pq.read_table(b)
    names = ta.schema.names
    if names != tb.schema.names or [f.type for f in ta.schema] != [f.type for f in tb.schema]:
        raise AssertionError(f"{name}: columns {ta.schema} against {tb.schema}")
    meta = [(ta.schema.metadata, tb.schema.metadata)] + [
        (ta.schema.field(c).metadata, tb.schema.field(c).metadata) for c in names]
    if any(x != y for x, y in meta) or ta.num_rows != tb.num_rows:
        raise AssertionError(f"{name}: metadata or rows differ ({ta.num_rows}, {tb.num_rows})")
    oa, ob = (np.lexsort((t.column("particle_id").to_numpy(), t.column("t").to_numpy()))
              for t in (ta, tb))
    dmax = 0.0
    for c in names:
        va, vb = ta.column(c).to_numpy()[oa], tb.column(c).to_numpy()[ob]
        if c in ("t", "particle_id"):
            np.testing.assert_array_equal(va, vb, err_msg=f"{name}: {c}")
        else:
            np.testing.assert_allclose(va, vb, rtol=rtol, err_msg=f"{name}: {c}")
            dmax = max(dmax, float(np.abs(va.astype(np.float64) - vb).max()))
    return dmax


def same_sets(name, a, b, rtol=1e-5):
    """The card's particle set against the CPU's: equal live-lane counts,
    ids, states and clocks; positions within ``rtol``."""
    if len(a) != len(b):
        raise AssertionError(f"{name}: {len(a)} live lanes on the card, {len(b)} on the CPU")
    for var in ("particle_id", "t"):
        np.testing.assert_array_equal(getattr(a, var), getattr(b, var), err_msg=f"{name}: {var}")
    return assert_same(name, a, b, rtol=rtol, vars_=("x", "y"))


def stop_after_an_hour(particles, fieldset):
    """The engine tier's StopAllExecution kernel (``tests/test_engine.py``)."""
    import torch

    from parcels_tpu_torch import StatusCode

    particles.state = torch.where(particles.t >= 3600.0, StatusCode.StopAllExecution,
                                  particles.state)


def uniform_flow(tp, device, u, v, dims):
    from parcels_tpu_torch.datasets import simple_UV_dataset

    ds = simple_UV_dataset(dims=dims, mesh="flat")
    ds["U"].values[:] = u
    ds["V"].values[:] = v
    return tp.FieldSet.from_sgrid_conventions(ds, mesh="flat", device=device)


def engine_case(tp, device, case, full=True):
    """One of the engine tier's cases on ``device`` at ``M_CPU_LANES``
    particles (seeded); ``full=False`` cuts a clock case short (the cliff
    case runs only so)."""
    n = M_CPU_LANES
    rng = np.random.default_rng(26)
    h = np.timedelta64(1, "h")
    if case in ("cliff", "subsecond"):
        u, t0, dt = (0.1, CLIFF_T0_S, CLIFF_DT) if case == "cliff" else (
            1.0, 0.0, np.timedelta64(700, "ms"))
        # the engine tier's hour at dt 0.7 s on the card; cut short for the
        # CPU, half an hour past the cliff (104 steps) and a minute (86 steps)
        runtime = {("cliff", False): np.timedelta64(30, "m"), ("subsecond", True): h,
                   ("subsecond", False): np.timedelta64(1, "m")}[case, full]
        fs = uniform_flow(tp, device, u, 0.0, (2, 2, 8, 8))
        pset = tp.ParticleSet(fs, x=rng.uniform(-1e6, -9e5, n), y=rng.uniform(-5e5, 5e5, n),
                              t=np.full(n, t0))
        pset.execute(tp.AdvectionEE, dt=dt, runtime=runtime)
        return pset
    if case == "backward":
        fs = uniform_flow(tp, device, 1.0, 0.5, (2, 2, 20, 20))
        x0, y0 = rng.uniform(1e5, 5e5, n), rng.uniform(1e5, 5e5, n)
        pset = tp.ParticleSet(fs, x=x0, y=y0, t=np.full(n, 7200.0))
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(-5, "m"), runtime=2 * h)
        # the engine tier's closed form, at its tolerance
        np.testing.assert_allclose(pset.x, x0 - 7200.0, rtol=1e-5, err_msg="backward: x")
        np.testing.assert_allclose(pset.y, y0 - 3600.0, rtol=1e-5, err_msg="backward: y")
        return pset
    if case == "stop_all":
        fs = uniform_flow(tp, device, 1.0, 0.0, (2, 2, 20, 20))
        pset = tp.ParticleSet(fs, x=rng.uniform(-5e5, 5e5, n), y=rng.uniform(-5e5, 5e5, n),
                              t=np.zeros(n))
        pset.execute([tp.AdvectionEE, stop_after_an_hour], dt=np.timedelta64(30, "m"),
                     runtime=6 * h)
        return pset
    # the Delete recovery kernel: 50 m/s east for 2 h moves 360 km, so the
    # lanes released east of 6.4e5 m leave the grid and are deleted
    fs = uniform_flow(tp, device, 50.0, 0.0, (2, 2, 20, 20))
    pset = tp.ParticleSet(fs, x=rng.uniform(-9e5, 9.9e5, n), y=rng.uniform(-5e5, 5e5, n),
                          t=np.zeros(n))
    pset.execute([tp.AdvectionEE, delete_oob], dt=np.timedelta64(30, "m"), runtime=2 * h)
    return pset


def behaviour_phase(torch, tp):
    """Phase 23: (m) on the card, then the card against the CPU on (m) and
    the engine tier's cases (see the module docstring)."""
    from datetime import timedelta

    root = pathlib.Path("build/behaviour")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        ds_m, start = m_dataset()
        fs_m = tp.FieldSet.from_sgrid_conventions(ds_m, mesh="flat")
        if type(fs_m.time_interval.left).__name__ != "CFDatetime":
            raise AssertionError("(m): the fieldset's time axis is not a 360_day CFDatetime")
        seen, restore = fold_calls()
        try:
            zero_counts()
            pset = m_run(tp, fs_m, M_LANES, M_HOURS, root / "m.parquet")
            lm = counts()
        finally:
            restore()
        stats = pset.last_run_stats
        if lm["fold_sample"] == 0:
            raise AssertionError("(m): K1 was not launched")
        if len(pset) != M_LANES or int((pset.state >= tp.StatusCode.Error).sum()):
            raise AssertionError("(m): particles were lost or ended in an error state")
        if not (np.isfinite(pset.x).all() and np.isfinite(pset.y).all()):
            raise AssertionError("(m): non-finite positions")
        if not (pset.t == np.float32(M_HOURS * 3600.0)).all():
            raise AssertionError("(m): the clock did not land on 6 h")
        k1_line = k1_on_path("(m)", seen)
        rows = m_times(tp, root / "m.parquet", start, M_HOURS, M_LANES)
        log(f"[m] {nvidia_smi()}: {M_SHAPE} 360_day from {start.isoformat()}, {M_LANES} "
            f"particles RK4 dt 60 s {M_HOURS} h, hourly output ({rows} rows read back as "
            f"360_day CFDatetime, the last {(start + timedelta(hours=M_HOURS)).isoformat()}): "
            f"particle_steps_per_s {stats['particle_steps_per_s']} wall_s {stats['wall_s']}; "
            f"launches {lm}; {k1_line}")
        del pset, seen
        t_m = time.perf_counter() - t0

        # the card against the CPU: (m)'s first hour at 64K particles
        fs_mc = tp.FieldSet.from_sgrid_conventions(ds_m, mesh="flat", device="cpu")
        sets = {}
        for dev_name, fs in (("cuda", fs_m), ("cpu", fs_mc)):
            sets[dev_name] = m_run(tp, fs, M_CPU_LANES, 1, root / f"m64k_{dev_name}.parquet")
        dm = same_sets("(m) card vs CPU", sets["cuda"], sets["cpu"])
        df_ = same_parquet("(m) files", root / "m64k_cuda.parquet", root / "m64k_cpu.parquet")
        m_times(tp, root / "m64k_cpu.parquet", start, 1, M_CPU_LANES)
        del fs_m, fs_mc, ds_m, sets
        t_mc = time.perf_counter() - t0 - t_m
        parts = [f"(m) 1 h: max |dx| {dm:.3g} m, files equal (max {df_:.3g})"]

        # the engine tier's cases: the sub-second dt for an hour on the card,
        # landing exactly (the day past the cliff lands exactly in both
        # packages' CPU runs, tests/test_torch_engine.py), then both clock
        # cases cut short on both devices
        secs = {"m 1M cuda": round(t_m, 1), "m 64K cuda+cpu": round(t_mc, 1)}

        def timed(device, case, full=True):
            t = time.perf_counter()
            pset = engine_case(tp, device, case, full)
            secs[f"{case}{'' if full else ' cut'} {device}"] = round(time.perf_counter() - t, 1)
            return pset

        full = timed("cuda", "subsecond")
        if not (full.t == np.float32(3600.0)).all():
            raise AssertionError(f"subsecond: t {np.unique(full.t)} did not land on 3600 s")
        for case, cut in (("cliff", CLIFF_T0_S + 1800.0), ("subsecond", 60.0)):
            a, b = (timed(d, case, full=False) for d in ("cuda", "cpu"))
            if not (a.t == np.float32(cut)).all():
                raise AssertionError(f"{case}: t {np.unique(a.t)} did not land on {cut}")
            parts.append(f"{case}: cut short, lands on {cut} s on both, t bit for bit, "
                         f"max |dx| {same_sets(case, a, b):.3g} m")
        parts.append("subsecond: the card's hour lands on 3600.0 s exactly")
        for case in ("backward", "stop_all", "delete"):
            a, b = (timed(d, case) for d in ("cuda", "cpu"))
            d_ = same_sets(case, a, b)
            if case == "backward" and not (a.t == 0.0).all():
                raise AssertionError("backward: the clock did not return to 0")
            if case == "stop_all" and not ((a.state == tp.StatusCode.StopAllExecution).all()
                                           and (a.t <= 7200.0).all()):
                raise AssertionError("stop_all: the run did not stop after an hour")
            if case == "delete" and not 0 < len(a) < M_CPU_LANES:
                raise AssertionError(f"delete: {len(a)} of {M_CPU_LANES} lanes live")
            parts.append(f"{case}: {len(a)} live, max |dx| {d_:.3g} m")
        log(f"[behaviour] card vs CPU at {M_CPU_LANES} particles, states, ids and clocks "
            f"equal, positions within rtol 1e-5: {'; '.join(parts)}; seconds {secs}, the "
            f"phase {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return lm


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
    # 19-20: (k) a Copernicus Marine global release with a second release and a
    # recapture (K2), the trace of one chunk of path (a) (K1), then card against
    # CPU on the MITgcm, Delft3D and Copernicus converters' outputs
    l_trace = trace_chunk(torch, tp, fs_a)
    ds_k, fs_k, kr = k_phase(torch, tp)
    l_mit, l_delft, l_kc = convert_phase(torch, tp, ds_k, fs_k)
    mark(t_start, "phases 19-20")
    # 21-22: scale-out over 4 ranks sharing the card. (l)'s one-rank reference
    # runs on (k)'s field, which is then freed before the ranks start
    l_ref = l_reference(torch, tp, fs_k)
    log(f"[l] card memory used before this process frees the earlier phases' tensors: "
        f"{card_used_mib()} ({torch.cuda.memory_allocated()} B allocated here)")
    # the 4 ranks share the card: drop what the earlier phases left on it
    del ds_k, fs_k, ds_a, fs_a, ds_b, fs_b, fs_cpu, runs, a, b, fs_e, pset, fs_p
    gc.collect()
    torch.cuda.empty_cache()
    l21 = l_phase(torch, tp, l_ref)
    del l_ref
    mark(t_start, "phase 21")
    p22 = p22_phase(torch, tp)
    mark(t_start, "phase 22")
    # 23: the behaviour tiers of the JAX package's tests on the card: (m) on a
    # 360_day calendar, then the card against the CPU on (m) and the engine cases
    l23 = behaviour_phase(torch, tp)
    mark(t_start, "phase 23")

    def by_rank(runs, half, kernel):
        return sum(o[f"launches_{half}"][kernel] for o in runs)
    kernels = [
        dict(name="fold_sample", route="cuda", source="parcels_tpu_torch/csrc/fold_sample.cu",
             replaces="parcels_tpu/ops/interp_kernels.py:77", launches=la["fold_sample"],
             launches_by_path={"e2e_a": la["fold_sample"], "cgrid_peninsula": lp["fold_sample"],
                               "config3": l12, "slip": l14,
                               "stream_j1": j1r["launches"]["fold_sample"], "trace_a": l_trace,
                               "mitgcm_card_vs_cpu": l_mit["fold_sample"],
                               "delft3d_card_vs_cpu": l_delft["fold_sample"],
                               "p22_mesh_4_ranks": sum(r["fold_sample"]
                                                       for r in p22["mesh"]["per_rank"]),
                               "p22_tiles_4_ranks": sum(r["fold_sample"]
                                                        for r in p22["tiles"]["per_rank"]),
                               "p22_tiles_smooth_4_ranks": sum(
                                   r["fold_sample"] for r in p22["tiles_smooth"]["per_rank"]),
                               "m_360_day": l23["fold_sample"]},
             **k1),
        dict(name="slab_sample", route="cuda", source="parcels_tpu_torch/csrc/slab_sample.cu",
             replaces="parcels_tpu/ops/binned_sample.py:489", launches=lb["slab_sample"],
             launches_by_path={"e2e_b": lb["slab_sample"], "e2e_b_em": l13,
                               "stream_j2": j2r["launches"]["slab_sample"],
                               "k_first_half": kr["first"]["slab_sample"],
                               "k_second_half": kr["second"]["slab_sample"],
                               "k_fresh": kr["fresh"]["slab_sample"],
                               "mitgcm_card_vs_cpu": l_mit["slab_sample"],
                               "delft3d_card_vs_cpu": l_delft["slab_sample"],
                               "k_card_vs_cpu": l_kc["slab_sample"],
                               "l_first_4_ranks": by_rank(l21["outs"], "first", "slab_sample"),
                               "l_second_4_ranks": by_rank(l21["outs"], "second",
                                                           "slab_sample")}, **k2),
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

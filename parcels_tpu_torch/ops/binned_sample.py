"""K2: binned slab sampler for fields larger than the card's L2.

Port of the JAX package's ``ops/binned_sample.py``. The engine keeps the
particle SoA sorted by (spatial bin, z-cell) (``_core/engine.py``). Every
chunk of ``CHUNK`` consecutive sorted lanes spans at most two bins in the
common case; the plan (``_build_plan``) gives each chunk a time origin and
two slab origins, and each 128-lane sub-block a slab half and a z window.
The hand-written kernel (``csrc/slab_sample.cu``) stages each sub-block's
(WT, WZ, SY, SX) window into a ring of z-planes in shared memory, loading
only the planes the previous windows did not hold (``staged_bytes``
counts them), and samples its lanes there.

K2 reads each lane's own integer cell index and f32 bcoord (the search's)
and takes the plain gather's (``_gather16``) corners, weights, product order
and first term. A corner inside the sub-block's window reads the staged
copy; a corner outside it ("overflow" lanes: chunks straddling three bins,
sub-blocks straddling a z transition, stale lanes, an unsorted SoA) reads
the field in device memory. So every lane of a live chunk gets the gather's
bits from the one kernel call: correctness never depends on sortedness, a
lane's value depends neither on the chunk it shares nor on how many lanes
overflow, and a run's bits follow neither the sort points nor the chunk
lengths that set them. K2 counts the overflow lanes it serves into a
counter on its device (``profiling.k2_overflow_counter``), without a host
read; its plain version counts the same lanes (``_overflow_lanes``).

What changed for the card: the JAX planner sized a slab pair for the TPU's
on-chip memory, scored it with the TPU's FLOP/byte rate and aligned DMA
origins to the TPU's tiling. Here only the window a sub-block samples is
staged, so the window's ``WT*WZ*SY*SX*4`` bytes must fit one block's shared
memory (``SMEM_WINDOW_BYTES``); the cost of a geometry is the window bytes
staged per lane; y origins need no alignment and x origins align to 4
floats (16-byte loads).

``slab_sample`` launches the kernel for tensors on the card and uses its
plain PyTorch version, ``slab_sample_plain``, only for tensors on the CPU.
"""

from __future__ import annotations

import functools
import os

import torch

from parcels_tpu_torch import profiling

__all__ = [
    "CHUNK",
    "LANE",
    "binned_enabled",
    "binned_linear_sample",
    "binned_usable",
    "edge_plans",
    "k2_grid",
    "plan_feasible",
    "quantize_z_occupancy",
    "ring_planes",
    "scripted_plan",
    "slab_geometry",
    "slab_sample",
    "slab_sample_plain",
    "sort_key_for",
    "staged_bytes",
]

#: lanes per CTA (one slab pair per chunk)
CHUNK = 1024
#: lanes per sub-block (one window per sub-block); the kernel's block size
LANE = 128
#: most chunks one K2 block walks (its window table takes 512 B a chunk)
K2_MAX_CHUNKS = 64
#: sub-blocks a K2 block samples at once (the kernel's GROUP)
GROUP_SUBBLOCKS = 4
#: want at least this many particles per bin (in CHUNK units)
_BIN_FILL = 3
#: shared-memory budget of one staged window (a block may use 227 KB)
SMEM_WINDOW_BYTES = 200 * 1024
#: x origins align to this many floats (16-byte loads)
X_ALIGN = 4
#: spare z-planes K2's ring may hold beyond the window
RING_SPARE = 2
#: shared memory the ring may take with its spare planes: two blocks fit an SM
SMEM_RING_BYTES = 112 * 1024


def binned_usable(shape4) -> bool:
    """Static check: is the slab geometry worthwhile for this field shape?"""
    T, Z, Y, X = shape4
    return Y >= 8 and X >= 128


def _zwin(SZ: int) -> int:
    """z-planes per window: 4 planes = 3 z-cells, anchored one cell below
    the sub-block's mean z-cell so lanes drifting +-1 cell between engine
    re-sorts stay covered."""
    return min(4, SZ)


_Z_OCC_LEVELS = (1.0, 0.5, 0.25, 0.1, 0.05, 0.02)


def quantize_z_occupancy(frac: float) -> float:
    """Quantize an occupied-z fraction to the planner's coarse levels."""
    return min(
        (lv for lv in _Z_OCC_LEVELS if lv >= max(float(frac), _Z_OCC_LEVELS[-1])),
        default=1.0,
    )


def slab_geometry(shape4, n, z_occ: float | None = None):
    """(WT, SZ, SY, SX, bz, by, bx) for a field shape and lane count."""
    return _slab_geometry_impl(tuple(shape4), n, 1.0 if z_occ is None else z_occ)[0]


def plan_feasible(shape4, n, z_occ: float | None = None) -> bool:
    """Did the plan for (shape4, n) meet the bin-population bar?"""
    return _slab_geometry_impl(tuple(shape4), n, 1.0 if z_occ is None else z_occ)[1]


@functools.lru_cache(maxsize=None)
def _slab_geometry_impl(shape4, n, z_occupancy):
    """Bin/slab geometry from field shape, lane count and z occupancy.

    Bins of (bz, by, bx) cells; slabs (SZ, SY, SX) cover a bin plus the +1
    interpolation stencil plus origin-alignment slack. Candidates whose
    staged window fits ``SMEM_WINDOW_BYTES`` are scored by window bytes
    staged per lane: a chunk restages when its sub-blocks change z-cell or
    slab half, about ``1 + CHUNK / lanes-per-bin-plane`` times. The cheapest
    candidate whose expected bin population (uniform density over the
    occupied z-cells) holds ``_BIN_FILL`` chunks, with more than 1.5
    sub-blocks per z-cell, wins; if none qualifies, the largest bin does
    and overflow absorbs the rest.
    """
    T, Z, Y, X = shape4
    WT = 1 if T == 1 else 2
    occupied_z = max(z_occupancy * Z, 1.0)
    density = n / float(max(occupied_z * Y * X, 1))

    def bin_extents(SZ, SY, SX):
        bz = 1 if Z == 1 else (Z if SZ >= Z else max(SZ - 1, 1))
        by = Y if SY >= Y else max(SY - 1, 1)
        bx = X if SX >= X else max(SX - X_ALIGN, 1)
        return bz, by, bx

    sz_cands = [1] if Z == 1 else sorted({min(Z, s) for s in (3, 4, 6, 8, 12, 16, 24, 32)})
    sy_cands = sorted({min(s, Y) for s in (8, 16, 32, 64)})
    sx_cands = sorted({min(s, X) for s in (64, 128, 256, 384, 512)})

    best = None
    for SZ in sz_cands:
        WZ = _zwin(SZ)
        for SY in sy_cands:
            for SX in sx_cands:
                window = 4 * WT * WZ * SY * SX
                if window > SMEM_WINDOW_BYTES:
                    continue
                bz, by, bx = bin_extents(SZ, SY, SX)
                plane = density * by * bx
                restages = min(CHUNK // LANE, 1.0 + CHUNK / max(plane, 1e-9))
                cost = window * restages / CHUNK
                vbin = min(float(bz), occupied_z) * by * bx
                feasible = density * vbin >= _BIN_FILL * CHUNK and (
                    Z == 1 or plane >= 1.5 * LANE
                )
                rank = (feasible, -cost if feasible else vbin)
                if best is None or rank > best[0]:
                    best = (rank, (WT, SZ, SY, SX, bz, by, bx))
    return best[1], bool(best[0][0])


def _mode() -> str:
    return os.environ.get("PARCELS_TPU_BINNED", "auto")


def binned_enabled(shape4, gpos) -> bool:
    """Gate of the binned path: not disabled, slab-compatible shape, an
    engine-sorted batch, and (unless forced) a feasible bin plan."""
    mode = _mode()
    if mode in ("0", "off"):
        return False
    if not binned_usable(shape4):
        return False
    if not gpos.get("_sorted", False):
        return False
    if mode == "force":
        return True
    n = gpos["X"]["index"].shape[0]
    return plan_feasible(shape4, n, gpos.get("_z_occ"))


# ---------------------------------------------------------------------------
# sort key (used by the engine to order the SoA)
# ---------------------------------------------------------------------------


def _bin_coords(geom, shape4, gpos):
    """Per-particle bin coordinates (zb, yb, xb), int32."""
    T, Z, Y, X = shape4
    _, _, _, _, bz, by, bx = geom

    def cell(ax, dim):
        return torch.clamp(gpos[ax]["index"], 0, max(dim - 1, 0)).to(torch.int32)

    return cell("Z", Z) // bz, cell("Y", Y) // by, cell("X", X) // bx


def sort_key_for(spec, gpos, shape4, n, z_occ: float | None = None):
    """int32 (spatial-bin, z-cell) sort key matching the slab geometry:
    lexicographic (z-bin, y-bin, x-bin, z-cell)."""
    geom = slab_geometry(tuple(shape4), n, z_occ)
    _, _, _, _, bz, by, bx = geom
    T, Z, Y, X = shape4
    nby = -(-max(Y, 1) // by)
    nbx = -(-max(X, 1) // bx)
    zb, yb, xb = _bin_coords(geom, shape4, gpos)
    bin_id = (zb * nby + yb) * nbx + xb
    zi = torch.clamp(gpos["Z"]["index"], 0, max(Z - 1, 0)).to(torch.int32)
    return (bin_id * bz + (zi - zb * bz)).to(torch.int32)


# ---------------------------------------------------------------------------
# plan: per-chunk slab origins, per-sub-block halves and z windows
# ---------------------------------------------------------------------------


def _build_plan(shape4, gpos):
    T, Z, Y, X = shape4
    n = gpos["X"]["index"].shape[0]
    geom = slab_geometry(tuple(shape4), n, gpos.get("_z_occ"))
    WT, SZ, SY, SX, bz, by, bx = geom
    WZ = _zwin(SZ)
    G = -(-n // CHUNK)
    npad = G * CHUNK
    pad = npad - n
    NS = CHUNK // LANE
    i32 = torch.int32

    def padded(a):
        return a if pad == 0 else torch.cat([a, a[-1:].expand(pad)])

    zb, yb, xb = (padded(c).reshape(G, CHUNK) for c in _bin_coords(geom, shape4, gpos))

    def bin_origin(b, stride, align, dim, ext):
        o = b * stride
        if align > 1:
            o = (o // align) * align
        return torch.clamp(o, 0, max(dim - ext, 0))

    # two candidate bins per chunk: of the first and of the last lane
    sel1 = (zb == zb[:, :1]) & (yb == yb[:, :1]) & (xb == xb[:, :1])

    origins = {}
    for tag, col in (("1", 0), ("2", -1)):
        origins["z" + tag] = bin_origin(zb[:, col], bz, 1, Z, SZ)
        origins["y" + tag] = bin_origin(yb[:, col], by, 1, Y, SY)
        origins["x" + tag] = bin_origin(xb[:, col], bx, X_ALIGN, X, SX)
    dup = (
        (origins["z1"] == origins["z2"])
        & (origins["y1"] == origins["y2"])
        & (origins["x1"] == origins["x2"])
    )

    # time origin: per-chunk min (shared by both slabs)
    tblend = 1 if T > 1 else 0
    tci = torch.clamp(gpos["T"]["index"].to(i32), 0, max(T - 1 - tblend, 0))
    t0 = torch.clamp(padded(tci).reshape(G, CHUNK).min(dim=1).values, 0, max(T - WT, 0))

    # per-lane slab half (0 -> first-lane bin, 1 -> last-lane bin); when the
    # halves coincide everything maps to half 0
    half = torch.where(sel1, 0, 1).to(i32) * (1 - dup[:, None].to(i32))

    zci = torch.clamp(
        padded(gpos["Z"]["index"].to(i32)).reshape(G, CHUNK), 0,
        max(Z - 1 - (1 if Z > 1 else 0), 0),
    )
    zorig = torch.where(half == 0, origins["z1"][:, None], origins["z2"][:, None])
    zrel_s = (zci - zorig).reshape(G, NS, LANE)

    # per-sub-block slab half by majority vote; z window one cell below the
    # majority's rounded mean z-cell (robust to single drifting lanes)
    half_s = half.reshape(G, NS, LANE)
    shalf = (half_s.sum(dim=2) > LANE // 2).to(i32)
    in_maj = half_s == shalf[:, :, None]
    cnt = torch.clamp_min(in_maj.sum(dim=2), 1)
    zsum = torch.where(in_maj, zrel_s, 0).sum(dim=2)
    zmean = torch.round(zsum.to(torch.float32) / cnt.to(torch.float32)).to(i32)
    z0w = torch.clamp(zmean - 1, 0, max(SZ - WZ, 0))

    # chunks with no live lane (capacity padding, deleted particles) are
    # skipped by the kernel
    active = gpos.get("active")
    if active is not None:
        live = padded(active).reshape(G, CHUNK).any(dim=1).to(i32)
    else:
        live = torch.ones(G, dtype=i32, device=zb.device)

    return {
        "G": G,
        "NS": NS,
        "n": n,
        "npad": npad,
        "geom": geom,
        "WZ": WZ,
        "t0": t0.to(i32).contiguous(),
        "origins": {k: v.to(i32).contiguous() for k, v in origins.items()},
        "shalf": shalf.reshape(-1).contiguous(),
        "z0w": z0w.reshape(-1).to(i32).contiguous(),
        "live": live.contiguous(),
        # each lane's own cell index and bcoord, (T, Z, Y, X), as the gather reads them
        "index": tuple(gpos[ax]["index"].to(i32).contiguous() for ax in "TZYX"),
        "bcoord": tuple(gpos[ax]["bcoord"].to(torch.float32).contiguous() for ax in "TZYX"),
    }


def _get_plan(shape4, gpos):
    """The plan of this search result, built once and shared by every
    component (U, V, W) sampled with it."""
    plans = gpos.setdefault("_k2plans", {})
    if shape4 not in plans:
        with profiling.span("parcels.k2.plan"):
            plans[shape4] = _build_plan(shape4, gpos)
    return plans[shape4]


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def _lane_windows(plan, device):
    """Per-lane window origin (t, z, y, x)."""
    npad, NS = plan["npad"], plan["NS"]
    sub = torch.arange(npad, device=device) // LANE
    chunk = sub // NS
    h = plan["shalf"][sub] == 1
    o = plan["origins"]

    def pick(a1, a2):
        return torch.where(h, a2[chunk], a1[chunk]).to(torch.int64)

    return (
        plan["t0"][chunk].to(torch.int64),
        pick(o["z1"], o["z2"]) + plan["z0w"][sub],
        pick(o["y1"], o["y2"]),
        pick(o["x1"], o["x2"]),
    )


def _levels(index, bcoord, dim):
    """One axis's (corner, weight) levels as ``_gather16`` takes them: corners
    clamped to the axis, a single level of weight 1 on an axis of one point."""
    i = index.to(torch.int64)
    if dim == 1:
        return [(torch.zeros_like(i), torch.ones_like(bcoord))]
    return [(torch.clamp(i, 0, dim - 1), 1.0 - bcoord), (torch.clamp(i + 1, 0, dim - 1), bcoord)]


def _overflow_lanes(plan, shape4) -> torch.Tensor:
    """(n,) bool: the lanes of live chunks with a corner (as ``_levels``
    gives them) outside their sub-block's window, which K2 reads from the
    field. The kernel counts the same lanes."""
    n = plan["n"]
    device = plan["live"].device
    inside = torch.ones(n, dtype=torch.bool, device=device)
    exts = (plan["geom"][0], plan["WZ"], *plan["geom"][2:4])
    for o, ext, i, b, d in zip(_lane_windows(plan, device), exts, plan["index"], plan["bcoord"],
                               shape4):
        for c, _ in _levels(i, b, d):
            inside = inside & (c >= o[:n]) & (c < o[:n] + ext)
    return ~inside & (plan["live"][torch.arange(n, device=device) // CHUNK] == 1)


def slab_sample_plain(data: torch.Tensor, plan, overflow: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2, operation for operation: (n,) values.

    Every lane of a live chunk gets ``_gather16``'s value bit for bit: a
    corner reads the field element that K2 reads from its window's copy or,
    outside the window, from device memory. Lanes of dead chunks are 0.
    ``overflow``, a one-element int64 tensor, receives the lanes K2 reads
    partly from the field (``_overflow_lanes``), as the kernel counts them.
    """
    T, Z, Y, X = data.shape
    n = plan["n"]
    flat = data.reshape(-1)
    chunk = torch.arange(n, device=data.device) // CHUNK
    lv = [_levels(i, b, d) for i, b, d in zip(plan["index"], plan["bcoord"], (T, Z, Y, X))]
    acc = None
    for ct, wt in lv[0]:
        for cz, wz in lv[1]:
            for cy, wy in lv[2]:
                for cx, wx in lv[3]:
                    v = flat[((ct * Z + cz) * Y + cy) * X + cx]
                    v = (((v * wt) * wz) * wy) * wx
                    acc = v if acc is None else acc + v
    if overflow is not None:
        overflow += _overflow_lanes(plan, data.shape).sum()
    return torch.where(plan["live"][chunk] == 1, acc, 0.0)


def ring_planes(geom) -> int:
    """z-planes of K2's ring: the window's ``WZ`` plus up to ``RING_SPARE``
    spare planes (which let sub-blocks whose windows differ in z share one
    group), as far as ``SMEM_RING_BYTES`` allows."""
    WT, SZ, SY, SX = geom[:4]
    WZ = _zwin(SZ)
    fit = SMEM_RING_BYTES // (4 * WT * SY * SX)
    return max(WZ, min(WZ + RING_SPARE, fit))


def k2_grid(G: int, sms: int) -> int:
    """Blocks of K2's grid for ``G`` chunks on a card of ``sms`` SMs: two a
    SM (two blocks fit one), more when a block would walk over
    ``K2_MAX_CHUNKS`` chunks, at most one a chunk. Each block walks an
    equal share of consecutive chunks, keeping its window ring."""
    return min(G, max(2 * sms, -(-G // K2_MAX_CHUNKS)))


def _windows(plan):
    """Per sub-block window origin (t0, z, y, x) as host ints, or None in a
    dead chunk."""
    NS = plan["NS"]
    o = {k: v.tolist() for k, v in plan["origins"].items()}
    t0, live = plan["t0"].tolist(), plan["live"].tolist()
    out = []
    for q, (h, zw) in enumerate(zip(plan["shalf"].tolist(), plan["z0w"].tolist())):
        g = q // NS
        tag = "2" if h else "1"
        out.append((t0[g], o["z" + tag][g] + zw, o["y" + tag][g], o["x" + tag][g])
                   if live[g] else None)
    return out


def _origin(w):
    return w[0], w[2], w[3]


def staged_bytes(plan, sms: int) -> int:
    """Field bytes K2 stages into shared memory for ``plan`` on a card of
    ``sms`` SMs, counted on the host (``slab_sample(..., staged=)`` counts
    them on the card).

    Follows the kernel's rule: block b of ``B = k2_grid(G, sms)`` walks chunks
    ``[b G // B, (b + 1) G // B)``, skipping dead ones, ``GROUP_SUBBLOCKS`` sub-blocks
    at a time: a group is a run of consecutive live sub-blocks with one
    (t0, y, x) origin whose z windows together span at most
    ``ring_planes`` planes. A group loads the planes of its span that the
    previous group of the block did not span with the same origin; so a
    window that moves by d < WZ planes loads d planes, and a block's first
    group, a change of origin or a jump of WZ or more loads in full.
    """
    WT, _, SY, SX = plan["geom"][:4]
    WZ, RZ, NS = plan["WZ"], ring_planes(plan["geom"]), plan["NS"]
    wins = _windows(plan)
    G = plan["G"]
    B = k2_grid(G, sms)
    planes = 0
    for b in range(B):
        blk = wins[b * G // B * NS:(b + 1) * G // B * NS]
        prev, span = None, (0, 0)
        k = 0
        while k < len(blk):
            if blk[k] is None:
                k += 1
                continue
            first = blk[k]
            lo, hi, cnt = first[1], first[1] + WZ, 1
            while cnt < GROUP_SUBBLOCKS and k + cnt < len(blk):
                w = blk[k + cnt]
                if w is None or _origin(w) != _origin(first):
                    break
                if max(hi, w[1] + WZ) - min(lo, w[1]) > RZ:
                    break
                lo, hi, cnt = min(lo, w[1]), max(hi, w[1] + WZ), cnt + 1
            same = prev is not None and _origin(prev) == _origin(first)
            overlap = max(0, min(hi, span[1]) - max(lo, span[0])) if same else 0
            planes += hi - lo - overlap
            prev, span = first, (lo, hi)
            k += cnt
    return 4 * WT * SY * SX * planes


def scripted_plan(shape4, geom, t0, org1, org2, shalf, z0w, live, seed=0, device="cpu"):
    """A K2 plan with the given windows and random lane positions.

    ``geom`` is (WT, SZ, SY, SX); ``t0``, ``live`` and the (z, y, x) slab
    origins ``org1``/``org2`` are per chunk, ``shalf`` and ``z0w`` per
    sub-block (``NS`` per chunk). Positions fall inside their sub-block's
    window and up to 0.6 of a cell beyond it, so some corners fall outside
    the window and some outside the field; every 97th lane has a NaN x
    bcoord. Window sequences the planner seldom produces can so be held
    against the plain version.
    """
    WT, SZ, SY, SX = geom
    WZ = _zwin(SZ)
    G, NS = len(t0), CHUNK // LANE
    npad = G * CHUNK
    g = torch.Generator().manual_seed(seed)

    def ints(a):
        return torch.as_tensor(a, dtype=torch.int32).reshape(-1).contiguous()

    origins = {f"{a}{k}": ints([o[i] for o in org]) for k, org in (("1", org1), ("2", org2))
               for i, a in enumerate("zyx")}
    plan = {
        "G": G, "NS": NS, "n": npad, "npad": npad, "geom": (WT, SZ, SY, SX), "WZ": WZ,
        "t0": ints(t0), "origins": origins, "shalf": ints(shalf), "z0w": ints(z0w),
        "live": ints(live),
    }
    index, bcoord = [], []
    for o, ext in zip(_lane_windows(plan, "cpu"), (WT, WZ, SY, SX)):
        pos = o.to(torch.float32) + torch.rand(npad, generator=g) * (ext + 0.2) - 0.6
        cell = torch.floor(pos)
        index.append(cell.to(torch.int32).contiguous())
        bcoord.append((pos - cell).contiguous())
    bcoord[3][::97] = float("nan")
    plan["index"], plan["bcoord"] = tuple(index), tuple(bcoord)

    def moved(v):
        if isinstance(v, dict):
            return {k: moved(a) for k, a in v.items()}
        if isinstance(v, tuple):
            return tuple(moved(a) for a in v)
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return moved(plan)


def edge_plans(X=520, device="cpu"):
    """Scripted plans over a (3, 12, 40, X) field, window (2, 4, 16, 128):
    z windows that move by 0, 1, 2 and WZ or more planes (both ways), a
    change of half mid-chunk, consecutive chunks with equal origins (across
    a dead chunk too), halves that differ only in z, a new t0, duplicate
    halves and dead chunks. An ``X`` that is not a multiple of 4 takes the
    kernel's scalar staging path."""
    geom = (2, 8, 16, 128)
    a, b, c = (0, 4, 64), (2, 20, 128), (4, 20, 128)
    chunks = [  # (t0, org1, org2, shalf, z0w, live)
        (0, a, b, [0] * 8, [0, 0, 1, 3, 3, 4, 0, 2], 1),
        (0, a, b, [0] * 4 + [1] * 4, [1, 1, 2, 2, 0, 1, 1, 2], 1),
        (0, a, b, [1] * 8, [0] * 8, 0),
        (0, b, b, [0] * 8, [2, 3, 3, 3, 4, 4, 4, 4], 1),
        (1, b, c, [0, 1] * 4, [0, 0, 1, 0, 2, 3, 4, 2], 1),
        (1, b, c, [1] * 8, [2, 2, 3, 3, 3, 4, 4, 4], 1),
        (0, c, c, [0] * 8, [4, 0, 4, 0, 1, 2, 3, 4], 1),
        (1, a, c, [1, 1, 0, 0, 1, 1, 0, 0], [0, 4, 4, 0, 1, 3, 2, 0], 0),
    ]
    cols = list(zip(*chunks))
    return scripted_plan((3, 12, 40, X), geom, cols[0], cols[1], cols[2], cols[3], cols[4],
                         cols[5], seed=X, device=device)


def slab_sample(data: torch.Tensor, plan, staged: torch.Tensor | None = None,
                overflow: torch.Tensor | None = None) -> torch.Tensor:
    """Sample every planned lane, from its staged window where its corners
    lie there and from the field where they do not: (n,) values.

    On a CUDA tensor this launches K2 (``slab_sample.launches`` counts the
    launches); on a CPU tensor it runs the plain version. ``staged``, a
    one-element int64 tensor on the card, receives the bytes of the copies
    the kernel issues. ``overflow``, a one-element int64 tensor on the
    field's device, receives the lanes read partly from the field; without
    it they go to ``profiling.k2_overflow_counter`` and the call's lanes to
    ``profiling.k2_lanes``.
    """
    if overflow is None:
        overflow = profiling.k2_overflow_counter(data.device)
        profiling.k2_lanes += plan["n"]
    if overflow.dtype != torch.int64 or overflow.device != data.device:
        raise ValueError("slab_sample: overflow must be an int64 tensor on the field's device")
    if data.device.type == "cpu":
        return slab_sample_plain(data, plan, overflow)
    if data.device.type != "cuda" or data.dim() != 4:
        raise ValueError(f"slab_sample: expected a 4-D CUDA or CPU field, got {data.device}")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("slab_sample: expected a contiguous float32 field")
    T, Z, Y, X = data.shape
    WT, _, SY, SX = plan["geom"][:4]
    G, NS = plan["G"], plan["NS"]
    o = plan["origins"]
    ints = [plan["t0"], o["z1"], o["y1"], o["x1"], o["z2"], o["y2"], o["x2"],
            plan["shalf"], plan["z0w"], plan["live"]]
    for a in ints:
        if a.dtype != torch.int32 or a.device != data.device or not a.is_contiguous():
            raise ValueError("slab_sample: plan arrays must be contiguous int32 on the field's device")
    n = plan["n"]
    for arrs, dtype in ((plan["index"], torch.int32), (plan["bcoord"], torch.float32)):
        for a in arrs:
            if (a.dtype != dtype or a.shape != (n,) or a.device != data.device
                    or not a.is_contiguous()):
                raise ValueError("slab_sample: lane indices (int32) and bcoords (float32) must be "
                                 "contiguous (n,) arrays on the field's device")
    out = torch.empty(n, dtype=torch.float32, device=data.device)
    if staged is not None and (staged.dtype != torch.int64 or staged.device != data.device):
        raise ValueError("slab_sample: staged must be an int64 tensor on the field's device")
    if G == 0:
        return out
    # bulk (16-byte granular) window copies need 16-byte aligned rows and origins
    vec4 = int(X % 4 == 0 and SX % 4 == 0 and data.data_ptr() % 16 == 0)
    from parcels_tpu_torch.ops._build import load

    launch = load("slab_sample")
    err = launch(
        data.data_ptr(), T, Z, Y, X, *(a.data_ptr() for a in ints),
        *(a.data_ptr() for a in plan["index"]), *(a.data_ptr() for a in plan["bcoord"]),
        out.data_ptr(), n, G, WT, plan["WZ"], ring_planes(plan["geom"]), SY, SX, NS,
        k2_grid(G, torch.cuda.get_device_properties(data.device).multi_processor_count), vec4,
        None if staged is None else staged.data_ptr(), overflow.data_ptr(),
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"slab_sample kernel launch failed with cudaError {err}")
    slab_sample.launches += 1
    return out


slab_sample.launches = 0


# ---------------------------------------------------------------------------
# the plain gather (the reference K2 is held to) + public entry
# ---------------------------------------------------------------------------


def _axis_pairs(idx, bc, dim):
    """[(clipped_index, weight), ...] per-axis blend levels (reference XLinear)."""
    if dim == 1:
        return [(torch.zeros_like(idx), None)]
    return [(torch.clamp(idx, 0, dim - 1), 1.0 - bc), (torch.clamp(idx + 1, 0, dim - 1), bc)]


def _gather16(data, gidx):
    """Plain multilinear gather of the selected lanes: what K2 gives every
    lane of a live chunk, bit for bit."""
    T, Z, Y, X = data.shape
    flat = data.reshape(-1)
    val = None
    for ti, wt in _axis_pairs(*gidx["T"], T):
        for zi, wz in _axis_pairs(*gidx["Z"], Z):
            for yi, wy in _axis_pairs(*gidx["Y"], Y):
                for xi, wx in _axis_pairs(*gidx["X"], X):
                    lin = ((ti * Z + zi) * Y + yi) * X + xi
                    v = flat[torch.clamp(lin, 0, flat.numel() - 1)]
                    for w in (wt, wz, wy, wx):
                        if w is not None:
                            v = v * w
                    val = v if val is None else val + v
    return val


def _gather_lanes(gpos):
    """{axis: (int64 index, f32 bcoord)} of all lanes."""
    return {ax: (gpos[ax]["index"].to(torch.int64), gpos[ax]["bcoord"].to(torch.float32))
            for ax in "TZYX"}


def binned_linear_sample(data, gpos):
    """Multilinear sample of a (T, Z, Y, X) field via sorted-chunk slabs: the
    plan, then one K2 call, with no host read.

    Values of lanes with out-of-bounds sentinel indices are arbitrary: the
    caller masks them (``field._mask_oob_values``), as on the gather path.
    """
    shape4 = tuple(data.shape)
    n = gpos["X"]["index"].shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.float32, device=data.device)
    plan = _get_plan(shape4, gpos)
    with profiling.span("parcels.k2.kernel"):
        return slab_sample(data, plan)

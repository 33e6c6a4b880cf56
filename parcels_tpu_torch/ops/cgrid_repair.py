"""K5: the C-grid stage cache's hit check, search and gather, walk included, on the card.

Port of two XLA loops of the JAX package that stay on its device: the stage
cache's miss repair (``ops/stagecache.py`` ``cgrid_cached_eval``, a
``while_loop`` over rounds of K compacted lanes) and the curvilinear walk
inside it (``_core/index_search.py`` ``curvilinear_search``, an early-exit
``while_loop``), with the stage's hit check and every lane's (xsi, eta). For
tensors on the card one call of ``csrc/cgrid_repair.cu`` runs a stage with no
read back to the host; for tensors on the CPU the plain versions run:

- ``cgrid_stage`` / ``cgrid_stage_plain``: one stage of the cache: the hit
  check over every lane, the misses repaired in rounds of K (a short last
  round padded with lane n - 1), warm-started from the cached cells and
  written into the cache columns in place, and (xsi, eta) from every lane's
  row. On the card: the check kernel compacts the misses into a work list in
  lane order (a miss's place is its rank, its round place // K), then two
  search passes on a fixed grid walk the list alone;
- ``cgrid_full`` / ``cgrid_full_plain``: every lane of a batch in one round,
  warm-started from a given cell; returns new cache columns and (xsi, eta).

What bounds the card's time is the scattered reads: a searched lane's pic
rows and field values, and the check's 121 bytes a lane over all n lanes.
The kernel reads table rows and stages lane-ordered rows in 16-byte vectors
and searches only the work list. The walk's iteration count is the batch's:
the plain loop runs while any lane of a round is neither found nor hopeless,
and a lane hopeless from the start walks that long too; the kernel keeps it
per round, so it keeps every bit the plain version computes.

``launches`` counts the calls that launched the kernel (a stage's memset,
check and two passes are one call).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.statuscodes import StatusCode
from parcels_tpu_torch.ops import stagecache

__all__ = [
    "StageResult",
    "cgrid_full",
    "cgrid_full_plain",
    "cgrid_repair_plain",
    "cgrid_stage",
    "cgrid_stage_plain",
    "plain_rounds",
    "repair_plan",
    "stage_miss",
    "work_list",
]

#: the walk's iteration cap (index_search.curvilinear_search's n_walk)
N_WALK = 12

#: cache columns the search and gather produce (stagecache._full's keys)
COLUMNS = ("cell", "yi", "xi", "row", "u4", "v4", "w4", "esc", "oob")

#: the kernel's lanes a block (a check tile) and the plan's head
#: (cnt, rounds, list length, tile ticket), csrc/cgrid_repair.cu's
TILE = 256
PLAN_HEAD = 4

launches = 0


class StageResult(NamedTuple):
    """What a stage returns beside the cache columns it repairs in place:
    (xsi, eta) of every lane, the misses and rounds (host ints on the CPU,
    0-d int64 tensors on the card), and the work list: its first ``length``
    entries are the lanes searched, in order, place p in round p // K."""

    xsi: torch.Tensor
    eta: torch.Tensor
    cnt: object
    rounds: object
    work: torch.Tensor
    length: object


# ---------------------------------------------------------------------------
# plain versions (the CPU's path, and the reference of the checks)
# ---------------------------------------------------------------------------


def cgrid_full_plain(vf, y, x, ti, t1i, zc, wzi, yi_g, xi_g, iters=None, count=None):
    """Search + gather every cached operand for one batch of lanes.

    Returns the cache-column dict (``COLUMNS``), ``esc`` being the X/Y
    escalation code per lane, with ``xsi`` and ``eta`` from each lane's row.
    ``iters``, a (2,) int64 tensor, gets the point-in-cell evaluations and
    raster re-seeds of the lanes of ``count`` (a bool mask; all if None).
    """
    grid = vf.grid
    spec = grid.spec
    garrs = grid.garrs
    lkm = grid.lookup_meta
    lookup = None
    if spec.has_lookup and lkm is not None:
        lookup = {**lkm, "yi": garrs["lookup_yi"], "xi": garrs["lookup_xi"]}
    stats = None if iters is None else torch.zeros((y.shape[0], 2), dtype=torch.int64,
                                                     device=y.device)
    yi, eta, xi, xsi = index_search.curvilinear_search(
        garrs["lon"], garrs["lat"], y, x, yi_g, xi_g,
        spherical=spec.spherical, lookup=lookup, pic_table=stagecache.cell_table(vf),
        n_walk=N_WALK, stats=stats,
    )
    if iters is not None:
        iters += (stats if count is None else stats[count]).sum(0)

    oob_lane = (yi == index_search.RIGHT_OUT_OF_BOUNDS) | (xi == index_search.RIGHT_OUT_OF_BOUNDS)
    err_lane = (yi == index_search.GRID_SEARCH_ERROR) | (xi == index_search.GRID_SEARCH_ERROR)
    esc = torch.maximum(
        torch.where(oob_lane, int(StatusCode.ErrorOutOfBounds), 0),
        torch.where(err_lane, int(StatusCode.ErrorGridSearching), 0),
    ).to(torch.int32)

    cy, cx = max(spec.ydim, 1), max(spec.xdim, 1)
    yi_cl = torch.clamp(yi, 0, cy - 1)
    xi_cl = torch.clamp(xi, 0, cx - 1)
    cell = yi_cl * cx + xi_cl
    valid = (yi >= 0) & (xi >= 0)

    T, Z, Y, X = vf.U.data.shape
    yi_o = torch.clamp(yi + spec.offset_y, 0, Y - 1)
    xw = torch.clamp(xi, 0, max(X - 2, 0))
    u4 = stagecache._flat_quad(vf.U, ti, t1i, zc, yi_o, xw, yi_o, xw + 1)
    xi_o = torch.clamp(xi + spec.offset_x, 0, X - 1)
    yv = torch.clamp(yi, 0, max(Y - 2, 0))
    v4 = stagecache._flat_quad(vf.V, ti, t1i, zc, yv, xi_o, yv + 1, xi_o)
    w4 = stagecache._w_quad(vf.W, ti, t1i, wzi, yi_o, xi_o) if vf.W is not None else None

    row = stagecache._rows(vf, cell)
    _, xsi_r, eta_r = index_search.pic_from_rows(row, index_search.query_xyz(y, x, spec.spherical))
    return {
        "cell": torch.where(valid, cell, -1).to(torch.int32),
        "yi": yi_cl.to(torch.int32),
        "xi": xi_cl.to(torch.int32),
        "row": row,
        "u4": u4,
        "v4": v4,
        "w4": w4,
        "esc": esc,
        "oob": ~valid,
        "xsi": xsi_r,
        "eta": eta_r,
    }


def plain_rounds(miss, k):
    """The lane indices of each repair round, as the plain loop forms them:
    the misses in order, ``k`` a round, a short last round padded with lane
    n - 1 (the JAX package's clamped compaction). One host read."""
    n = miss.shape[0]
    misses = torch.nonzero(miss).squeeze(1).to(torch.int32)
    cnt = misses.shape[0]
    for r in range(-(-cnt // k)):
        idx = misses[r * k:(r + 1) * k]
        if idx.shape[0] < k:
            idx = torch.cat([idx, torch.full((k - idx.shape[0],), n - 1, dtype=torch.int32,
                                             device=miss.device)])
        yield idx


def cgrid_repair_plain(vf, c, miss, k, y, x, ti, t1i, zc, wzi, iters=None):
    """Repair the cache columns ``c`` in place at the lanes of ``miss``, in
    rounds of ``k`` lanes, each a ``cgrid_full_plain`` warm-started from the
    lanes' cached cells. Returns (misses, rounds) as host ints. ``iters``
    counts each searched lane once (the pad's copies are one lane)."""
    keys = [key for key in COLUMNS if c[key] is not None] + ["ti", "zi", "wzi"]
    cnt = rounds = 0
    for idx in plain_rounds(miss, k):
        rounds += 1
        il = idx.long()
        first = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        first[1:] = idx[1:] != idx[:-1]  # the pad's copies follow one another
        sub = cgrid_full_plain(vf, y[il], x[il], ti[il], t1i[il], zc[il], wzi[il],
                               c["yi"][il], c["xi"][il], iters, first)
        sub["ti"], sub["zi"], sub["wzi"] = ti[il], zc[il], wzi[il]
        for key in keys:
            # duplicate writes of the pad lane carry equal values
            c[key].index_put_((il,), sub[key])
    if rounds:
        cnt = int(miss.sum())
    return cnt, rounds


def stage_miss(c, y, x, q, ti, zc, wzi, mask):
    """The stage's hit check (the JAX package's ``cgrid_cached_eval``): a
    lane misses where its cached row does not hold it or its time, depth or
    cell key changed; NaN lanes and lanes outside ``mask`` never miss."""
    ok, _, _ = index_search.pic_from_rows(c["row"], q)
    finite = torch.isfinite(y) & torch.isfinite(x)
    hit = ok & (ti == c["ti"]) & (zc == c["zi"]) & (wzi == c["wzi"]) & (c["cell"] >= 0)
    # dead/NaN lanes can never resolve: they count as hits (their values
    # are masked by the caller) so they take no repair capacity
    miss = ~hit & finite
    if mask is not None:
        miss = miss & mask
    return miss


def work_list(miss, k):
    """The lanes a stage searches, in the order the check kernel lists them:
    the misses by rank, then lane n - 1 where the last round is short and
    that lane is no miss (the plain loop's pad). Place p is in round p // k.
    Returns (work (m,) int32, misses, rounds) with host ints. One host read."""
    n = miss.shape[0]
    work = torch.nonzero(miss).squeeze(1).to(torch.int32)
    cnt = work.shape[0]
    if cnt % k and not bool(miss[-1]):
        work = torch.cat([work, torch.full((1,), n - 1, dtype=torch.int32, device=miss.device)])
    return work, cnt, -(-cnt // k)


def cgrid_stage_plain(vf, c, y, x, q, ti, t1i, zc, wzi, mask, k, iters=None):
    """One stage of the cache ``c`` (its columns repaired in place): the hit
    check, the misses' repair in rounds of ``k`` (``cgrid_repair_plain``),
    then (xsi, eta) from every lane's row. ``c["esc"]`` becomes the stage's
    escalation: zero but where a searched lane failed."""
    miss = stage_miss(c, y, x, q, ti, zc, wzi, mask)
    work, _, _ = work_list(miss, k)
    c["esc"] = torch.zeros_like(c["esc"])
    cnt, rounds = cgrid_repair_plain(vf, c, miss, k, y, x, ti, t1i, zc, wzi, iters)
    _, xsi, eta = index_search.pic_from_rows(c["row"], q)
    return StageResult(xsi, eta, cnt, rounds, work, work.shape[0])


def repair_plan(miss, k):
    """Each lane's round as ``plain_rounds`` forms them, computed on the
    lanes' device with no host read: (slot, cnt, rounds). ``slot`` (n,)
    int32 is the round of every lane a stage searches and -1 elsewhere (a
    miss's rank by a cumsum, its round ``rank // k``; the pad lane n - 1
    joins the last round when it is short); ``cnt`` and ``rounds`` are 0-d
    int64 tensors. The check kernel's work list is held to it."""
    n = miss.shape[0]
    cum = torch.cumsum(miss.to(torch.int32), 0, dtype=torch.int32)
    cnt = cum[-1].to(torch.int64)
    slot = torch.where(miss, torch.div(cum - 1, k, rounding_mode="floor"), -1).to(torch.int32)
    last = (cnt - 1).div(k, rounding_mode="floor").to(torch.int32)
    pad = (cnt % k != 0) & (cnt > 0)
    slot[n - 1:] = torch.where(pad, last, slot[n - 1:])
    rounds = (cnt + (k - 1)).div(k, rounding_mode="floor")
    return slot, cnt, rounds


# ---------------------------------------------------------------------------
# the kernel's launch
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """csrc/cgrid_repair.cu's K5Args, field for field."""

    _P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    _fields_ = [
        ("n", _L), ("plan", _P), ("work", _P), ("k", _I), ("nslots", _I),
        ("c_row", _P), ("c_ti", _P), ("c_zi", _P), ("c_wzi", _P), ("c_cell", _P), ("mask", _P),
        ("y", _P), ("x", _P), ("qx", _P), ("qy", _P), ("qz", _P),
        ("ti", _P), ("t1i", _P), ("zc", _P), ("wzi", _P), ("yi_w", _P), ("xi_w", _P),
        ("table", _P), ("table_rows", _L), ("table_cols", _I),
        ("ny", _I), ("nx", _I), ("cy", _I), ("cx", _I),
        ("has_lookup", _I), ("outside_test", _I), ("lk_y", _P), ("lk_x", _P),
        ("lny", _I), ("lnx", _I),
        ("ly0", _F), ("lx0", _F), ("inv_lys", _F), ("inv_lxs", _F),
        ("lo_y", _F), ("hi_y", _F), ("lo_x", _F), ("hi_x", _F),
        ("n_walk", _I),
        ("U", _P), ("V", _P), ("W", _P),
        ("uT", _I), ("uZ", _I), ("uY", _I), ("uX", _I),
        ("vT", _I), ("vZ", _I), ("vY", _I), ("vX", _I),
        ("wT", _I), ("wZ", _I), ("wY", _I), ("wX", _I),
        ("off_x", _I), ("off_y", _I), ("esc_oob", _I), ("esc_search", _I),
        ("cell", _P), ("oyi", _P), ("oxi", _P), ("esc", _P), ("oob", _P),
        ("row", _P), ("u4", _P), ("v4", _P), ("w4", _P),
        ("oti", _P), ("ozi", _P), ("owzi", _P), ("xsi", _P), ("eta", _P), ("iters", _P),
        ("nwalk", _P),
    ]


def _f32(v) -> float:
    return float(np.float32(v))


def _ptr(t, name, dtype, n, cols=None):
    """``t``'s address after checking its dtype, device and layout."""
    shape = (n,) if cols is None else (n, cols)
    if t.dtype != dtype or t.device.type != "cuda" or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"cgrid_repair: {name} must be a contiguous {dtype} {shape} tensor on "
                         f"the card, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _view_args(vf, device):
    """The launch fields that depend only on the view (grid, raster, fields,
    table, escalation codes), built once a view and its tensors."""
    table = stagecache.cell_table(vf)
    fields = (vf.U.data, vf.V.data, vf.W.data if vf.W is not None else None)
    key = (table.data_ptr(),) + tuple(0 if d is None else d.data_ptr() for d in fields)
    if vf._k5 is not None and vf._k5[0] == key:
        return vf._k5[1]
    grid, spec = vf.grid, vf.grid.spec
    garrs = grid.garrs
    f32 = torch.float32
    if (table.dtype != f32 or not table.is_contiguous() or table.device != device
            or table.shape[1] % 4 or table.shape[1] < 28 or table.data_ptr() % 16):
        raise ValueError("cgrid_repair: the cell table must be a contiguous, 16-byte aligned "
                         "(cells, 4m >= 28) f32 tensor on the lanes' card")
    a = _Args()
    keep = [table]
    a.table, a.table_rows, a.table_cols = table.data_ptr(), table.shape[0], table.shape[1]
    a.ny, a.nx = garrs["lon"].shape
    a.cy, a.cx = max(spec.ydim, 1), max(spec.xdim, 1)
    a.n_walk = N_WALK
    lkm = grid.lookup_meta
    if spec.has_lookup and lkm is not None:
        lk_y, lk_x = garrs["lookup_yi"].contiguous(), garrs["lookup_xi"].contiguous()
        keep += [lk_y, lk_x]
        (ly0, lx0), (lys, lxs) = lkm["origin"], lkm["step"]
        lny, lnx = lk_y.shape
        a.has_lookup, a.lk_y, a.lk_x, a.lny, a.lnx = 1, lk_y.data_ptr(), lk_x.data_ptr(), lny, lnx
        a.outside_test = 0 if spec.spherical else 1
        # torch divides a card tensor by a Python float as an f32 product
        # with the reciprocal taken in double and rounded to f32; the bounds
        # compare in f32
        a.ly0, a.lx0 = _f32(ly0), _f32(lx0)
        a.inv_lys, a.inv_lxs = _f32(1.0 / lys), _f32(1.0 / lxs)
        a.lo_y, a.hi_y = _f32(ly0), _f32(ly0 + lys * lny)
        a.lo_x, a.hi_x = _f32(lx0), _f32(lx0 + lxs * lnx)
    for name, d in zip("UVW", fields):
        if d is None:
            continue
        if d.dtype != f32 or not d.is_contiguous() or d.device != device or d.dim() != 4:
            raise ValueError(f"cgrid_repair: {name} must be a contiguous (T, Z, Y, X) f32 "
                             f"tensor on the card")
        setattr(a, name, d.data_ptr())
        for axis, size in zip("TZYX", d.shape):
            setattr(a, f"{name.lower()}{axis}", size)
    a.off_x, a.off_y = spec.offset_x, spec.offset_y
    a.esc_oob, a.esc_search = int(StatusCode.ErrorOutOfBounds), int(StatusCode.ErrorGridSearching)
    vf._k5 = (key, (a, keep))
    return vf._k5[1]


def _launch(vf, y, x, q, ti, t1i, zc, wzi, yi_w, xi_w, out, stage=None, iters=None):
    """One K5 call over the n lanes of ``y``, writing into the tensors of
    ``out`` in place. ``stage`` (c, mask, k): a stage of cache ``c``, else a
    full eval. Returns the plan tensor ([cnt, rounds, length, ...]) and the
    work list."""
    global launches
    from parcels_tpu_torch.ops._build import load

    n, dev = y.shape[0], y.device
    template, _ = _view_args(vf, dev)
    a = _Args.from_buffer_copy(template)
    keep = []  # lanes converted for the launch live until it is queued
    f32, i32 = torch.float32, torch.int32

    def lane(t, name, dtype=i32):
        if t.dtype != dtype or not t.is_contiguous():
            t = t.to(dtype).contiguous()
            keep.append(t)
        return _ptr(t, name, dtype, n)

    a.n = n
    a.y, a.x = lane(y, "y", f32), lane(x, "x", f32)
    a.qx, a.qy, a.qz = (lane(v, "q", f32) for v in q)
    a.ti, a.t1i, a.zc, a.wzi = lane(ti, "ti"), lane(t1i, "t1i"), lane(zc, "zc"), lane(wzi, "wzi")
    a.yi_w, a.xi_w = lane(yi_w, "yi_w"), lane(xi_w, "xi_w")
    # the written columns are the caller's tensors themselves
    a.cell, a.oyi, a.oxi = (_ptr(out[k], k, i32, n) for k in ("cell", "yi", "xi"))
    a.esc, a.oob = _ptr(out["esc"], "esc", i32, n), _ptr(out["oob"], "oob", torch.bool, n)
    a.row = _ptr(out["row"], "row", f32, n, stagecache.ROW_COLS)
    a.u4, a.v4 = _ptr(out["u4"], "u4", f32, n, 4), _ptr(out["v4"], "v4", f32, n, 4)
    a.xsi, a.eta = _ptr(out["xsi"], "xsi", f32, n), _ptr(out["eta"], "eta", f32, n)
    if vf.W is not None and out["w4"] is not None:
        a.w4 = _ptr(out["w4"], "w4", f32, n, 4)
    else:
        a.W = None
    if "ti" in out:
        a.oti, a.ozi, a.owzi = (_ptr(out[k], k, i32, n) for k in ("ti", "zi", "wzi"))
    if iters is not None:
        a.iters = _ptr(iters, "iters", torch.int64, 2)
    work = None
    if stage is None:
        a.nslots = 1
        plan = torch.empty(PLAN_HEAD + 1, dtype=torch.int64, device=dev)
    else:
        c, mask, k = stage
        tiles = -(-n // TILE)
        a.k, a.nslots = k, n // k + 1
        plan = torch.empty(PLAN_HEAD + tiles + (a.nslots + 1) // 2, dtype=torch.int64, device=dev)
        work = torch.empty(n + 1, dtype=i32, device=dev)
        a.work = work.data_ptr()
        a.c_row = a.row
        a.c_ti, a.c_zi, a.c_wzi, a.c_cell = a.oti, a.ozi, a.owzi, a.cell
        if mask is not None:
            a.mask = lane(mask, "mask", torch.bool)
    a.plan = plan.data_ptr()
    err = load("cgrid_repair")(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cgrid_repair kernel launch failed with cudaError {err}")
    launches += 1
    return plan, work


def _device(y, name):
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {y.device}")
    return y.device.type


def cgrid_full(vf, y, x, q, ti, t1i, zc, wzi, yi_g, xi_g, iters=None):
    """``cgrid_full_plain``'s columns and (xsi, eta) for every lane of a
    batch, in one round warm-started from (``yi_g``, ``xi_g``). ``q`` is
    ``index_search.query_xyz(y, x, spherical)``. On a CUDA tensor this
    launches K5 (``launches`` counts the calls; ``iters``, a (2,) int64
    tensor on the card, adds the lanes' point-in-cell evaluations and raster
    re-seeds); on a CPU tensor it runs the plain version."""
    if _device(y, "cgrid_full") == "cpu":
        return cgrid_full_plain(vf, y, x, ti, t1i, zc, wzi, yi_g, xi_g, iters)
    n, dev = y.shape[0], y.device
    i32, f32 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float32, device=dev)
    out = {
        "cell": torch.empty(n, **i32),
        "yi": torch.empty(n, **i32),
        "xi": torch.empty(n, **i32),
        "row": torch.empty((n, stagecache.ROW_COLS), **f32),
        "u4": torch.empty((n, 4), **f32),
        "v4": torch.empty((n, 4), **f32),
        "w4": torch.empty((n, 4), **f32) if vf.W is not None else None,
        "esc": torch.empty(n, **i32),
        "oob": torch.empty(n, dtype=torch.bool, device=dev),
        "xsi": torch.empty(n, **f32),
        "eta": torch.empty(n, **f32),
    }
    if n:
        _launch(vf, y, x, q, ti, t1i, zc, wzi, yi_g, xi_g, out, iters=iters)
    return out


def cgrid_stage(vf, c, y, x, q, ti, t1i, zc, wzi, mask, k, iters=None):
    """One stage of the cache ``c``, as ``cgrid_stage_plain``: the hit check,
    the misses repaired in rounds of ``k`` in place, (xsi, eta) of every
    lane; returns a ``StageResult``. ``mask`` (bool, or None) limits the
    lanes that may miss.

    On a CUDA tensor this is one K5 call (a memset, the check-and-plan
    kernel and two search passes) with no host read: the counts and the
    work list's length stay 0-d tensors on the card. ``c``'s columns must
    be contiguous and the caller's own (the loaded SoA columns are copied
    first). On a CPU tensor it runs the plain version.
    """
    if _device(y, "cgrid_stage") == "cpu":
        return cgrid_stage_plain(vf, c, y, x, q, ti, t1i, zc, wzi, mask, k, iters)
    n, dev = y.shape[0], y.device
    xsi = torch.empty(n, dtype=torch.float32, device=dev)
    eta = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return StageResult(xsi, eta, 0, 0, torch.empty(0, dtype=torch.int32, device=dev), 0)
    plan, work = _launch(vf, y, x, q, ti, t1i, zc, wzi, c["yi"], c["xi"],
                         dict(c, xsi=xsi, eta=eta), (c, mask, k), iters)
    return StageResult(xsi, eta, plan[0], plan[1], work, plan[2])

"""K5: the C-grid stage cache's search and gather, walk included, on the card.

Port of two XLA loops of the JAX package that stay on its device: the stage
cache's miss repair (``ops/stagecache.py`` ``cgrid_cached_eval``, a
``while_loop`` over rounds of K compacted lanes) and the curvilinear walk
inside it (``_core/index_search.py`` ``curvilinear_search``, an early-exit
``while_loop``). For tensors on the card one kernel (``csrc/cgrid_repair.cu``)
runs every lane of a batch through ``stagecache._full``'s search and gathers
with no read back to the host; for tensors on the CPU the plain versions run:

- ``cgrid_full`` / ``cgrid_full_plain``: every lane of a batch in one round,
  warm-started from a given cell; returns new cache columns;
- ``cgrid_repair`` / ``cgrid_repair_plain``: the lanes of a miss mask in
  rounds of K (a short last round padded with lane n - 1), warm-started from
  the cached cell and written into the cache columns in place.

The walk's iteration count is the batch's: the plain loop runs while any lane
of a round is neither found nor hopeless, and a lane hopeless from the start
walks that long too. The kernel reproduces it per round from ``repair_plan``'s
slots, so it keeps every bit the plain version computes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.statuscodes import StatusCode
from parcels_tpu_torch.ops import stagecache

__all__ = [
    "cgrid_full",
    "cgrid_full_plain",
    "cgrid_repair",
    "cgrid_repair_plain",
    "plain_rounds",
    "repair_plan",
]

#: the walk's iteration cap (index_search.curvilinear_search's n_walk)
N_WALK = 12

#: cache columns the search and gather produce (stagecache._full's keys)
COLUMNS = ("cell", "yi", "xi", "row", "u4", "v4", "w4", "esc", "oob")


# ---------------------------------------------------------------------------
# plain versions (the CPU's path, and the reference of the checks)
# ---------------------------------------------------------------------------


def cgrid_full_plain(vf, y, x, ti, t1i, zc, wzi, yi_g, xi_g):
    """Search + gather every cached operand for one batch of lanes.

    Returns the cache-column dict (``COLUMNS``), ``esc`` being the X/Y
    escalation code per lane.
    """
    grid = vf.grid
    spec = grid.spec
    garrs = grid.garrs
    lkm = grid.lookup_meta
    lookup = None
    if spec.has_lookup and lkm is not None:
        lookup = {**lkm, "yi": garrs["lookup_yi"], "xi": garrs["lookup_xi"]}
    yi, eta, xi, xsi = index_search.curvilinear_search(
        garrs["lon"], garrs["lat"], y, x, yi_g, xi_g,
        spherical=spec.spherical, lookup=lookup, pic_table=stagecache.cell_table(vf),
        n_walk=N_WALK,
    )

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

    return {
        "cell": torch.where(valid, cell, -1).to(torch.int32),
        "yi": yi_cl.to(torch.int32),
        "xi": xi_cl.to(torch.int32),
        "row": stagecache._rows(vf, cell),
        "u4": u4,
        "v4": v4,
        "w4": w4,
        "esc": esc,
        "oob": ~valid,
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


def cgrid_repair_plain(vf, c, miss, k, y, x, ti, t1i, zc, wzi):
    """Repair the cache columns ``c`` in place at the lanes of ``miss``, in
    rounds of ``k`` lanes, each a ``cgrid_full_plain`` warm-started from the
    lanes' cached cells. Returns (misses, rounds) as host ints."""
    keys = [key for key in COLUMNS if c[key] is not None] + ["ti", "zi", "wzi"]
    cnt = rounds = 0
    for idx in plain_rounds(miss, k):
        rounds += 1
        il = idx.long()
        sub = cgrid_full_plain(vf, y[il], x[il], ti[il], t1i[il], zc[il], wzi[il],
                               c["yi"][il], c["xi"][il])
        sub["ti"], sub["zi"], sub["wzi"] = ti[il], zc[il], wzi[il]
        for key in keys:
            # duplicate writes of the pad lane carry equal values
            c[key].index_put_((il,), sub[key])
    if rounds:
        cnt = int(miss.sum())
    return cnt, rounds


# ---------------------------------------------------------------------------
# the device-side plan: which lanes K5 searches, in which round
# ---------------------------------------------------------------------------


def repair_plan(miss, k):
    """Each lane's round as ``plain_rounds`` forms them, computed on the
    lanes' device with no host read.

    Returns (slot, cnt, rounds): ``slot`` (n,) int32 is the round of every
    lane the repair searches and -1 elsewhere (a miss's rank by a cumsum, its
    round ``rank // k``; the pad lane n - 1 joins the last round when it is
    short); ``cnt`` and ``rounds`` are 0-d int64 tensors.
    """
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
        ("n", _L), ("slot", _P), ("nwalk", _P),
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
        ("oti", _P), ("ozi", _P), ("owzi", _P), ("iters", _P),
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


def _launch(vf, y, x, q, ti, t1i, zc, wzi, yi_w, xi_w, out, slot, nslots, iters=None):
    """One K5 launch (its two passes) over the n lanes of ``y``, writing
    into the tensors of ``out`` in place."""
    from parcels_tpu_torch.ops._build import load

    n = y.shape[0]
    if n == 0:
        return
    grid, spec = vf.grid, vf.grid.spec
    garrs = grid.garrs
    table = stagecache.cell_table(vf)
    ny, nx = garrs["lon"].shape
    lkm = grid.lookup_meta
    has_lookup = spec.has_lookup and lkm is not None
    f32, i32 = torch.float32, torch.int32
    keep = []  # operands converted for the launch live until it is queued

    def arr(t, name, dtype=i32):
        t = t.to(dtype).contiguous()
        keep.append(t)
        return _ptr(t, name, dtype, n)

    nwalk = torch.zeros(nslots, dtype=i32, device=y.device)
    a = _Args()
    a.n = n
    if slot is not None:
        a.slot = arr(slot, "slot")
    a.nwalk = nwalk.data_ptr()
    a.y, a.x = arr(y, "y", f32), arr(x, "x", f32)
    a.qx, a.qy, a.qz = (arr(v, "q", f32) for v in q)
    a.ti, a.t1i, a.zc, a.wzi = arr(ti, "ti"), arr(t1i, "t1i"), arr(zc, "zc"), arr(wzi, "wzi")
    a.yi_w, a.xi_w = arr(yi_w, "yi_w"), arr(xi_w, "xi_w")
    if table.dtype != f32 or not table.is_contiguous() or table.device != y.device:
        raise ValueError("cgrid_repair: the cell table must be contiguous f32 on the lanes' card")
    a.table, a.table_rows, a.table_cols = table.data_ptr(), table.shape[0], table.shape[1]
    a.ny, a.nx = ny, nx
    a.cy, a.cx = max(spec.ydim, 1), max(spec.xdim, 1)
    a.n_walk = N_WALK
    if has_lookup:
        lk_y, lk_x = garrs["lookup_yi"].contiguous(), garrs["lookup_xi"].contiguous()
        keep += [lk_y, lk_x]
        (ly0, lx0), (lys, lxs) = lkm["origin"], lkm["step"]
        lny, lnx = lk_y.shape
        a.has_lookup, a.lk_y, a.lk_x, a.lny, a.lnx = 1, lk_y.data_ptr(), lk_x.data_ptr(), lny, lnx
        a.outside_test = 0 if spec.spherical else 1
        # torch divides a card tensor by a Python float as a product with its
        # f32 reciprocal; the bounds compare in f32
        a.ly0, a.lx0 = _f32(ly0), _f32(lx0)
        a.inv_lys = float(np.float32(1.0) / np.float32(lys))
        a.inv_lxs = float(np.float32(1.0) / np.float32(lxs))
        a.lo_y, a.hi_y = _f32(ly0), _f32(ly0 + lys * lny)
        a.lo_x, a.hi_x = _f32(lx0), _f32(lx0 + lxs * lnx)
    has_w = vf.W is not None and out["w4"] is not None
    for name, field in (("U", vf.U), ("V", vf.V), ("W", vf.W if has_w else None)):
        if field is None:
            continue
        d = field.data
        if d.dtype != f32 or not d.is_contiguous() or d.device != y.device or d.dim() != 4:
            raise ValueError(f"cgrid_repair: {name} must be a contiguous (T, Z, Y, X) f32 "
                             f"tensor on the card")
        setattr(a, name, d.data_ptr())
        for axis, size in zip("TZYX", d.shape):
            setattr(a, f"{name.lower()}{axis}", size)
    a.off_x, a.off_y = spec.offset_x, spec.offset_y
    a.esc_oob, a.esc_search = int(StatusCode.ErrorOutOfBounds), int(StatusCode.ErrorGridSearching)
    # the written columns are the caller's tensors themselves
    a.cell, a.oyi, a.oxi = (_ptr(out[k], k, i32, n) for k in ("cell", "yi", "xi"))
    a.esc, a.oob = _ptr(out["esc"], "esc", i32, n), _ptr(out["oob"], "oob", torch.bool, n)
    a.row = _ptr(out["row"], "row", f32, n, stagecache.ROW_COLS)
    a.u4, a.v4 = _ptr(out["u4"], "u4", f32, n, 4), _ptr(out["v4"], "v4", f32, n, 4)
    if has_w:
        a.w4 = _ptr(out["w4"], "w4", f32, n, 4)
    if "ti" in out:
        a.oti, a.ozi, a.owzi = (_ptr(out[k], k, i32, n) for k in ("ti", "zi", "wzi"))
    if iters is not None:
        a.iters = _ptr(iters, "iters", torch.int64, 2)
    err = load("cgrid_repair")(ctypes.byref(a), torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cgrid_repair kernel launch failed with cudaError {err}")
    cgrid_repair.launches += 1


def _device(y, name):
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {y.device}")
    return y.device.type


def cgrid_full(vf, y, x, q, ti, t1i, zc, wzi, yi_g, xi_g, iters=None):
    """``cgrid_full_plain``'s columns for every lane of a batch, in one round
    warm-started from (``yi_g``, ``xi_g``). ``q`` is
    ``index_search.query_xyz(y, x, spherical)``. On a CUDA tensor this
    launches K5 (``cgrid_repair.launches`` counts the launches; ``iters``, a
    (2,) int64 tensor on the card, adds the lanes' point-in-cell evaluations
    and raster re-seeds); on a CPU tensor it runs the plain version."""
    if _device(y, "cgrid_full") == "cpu":
        return cgrid_full_plain(vf, y, x, ti, t1i, zc, wzi, yi_g, xi_g)
    n, dev = y.shape[0], y.device
    out = {
        "cell": torch.empty(n, dtype=torch.int32, device=dev),
        "yi": torch.empty(n, dtype=torch.int32, device=dev),
        "xi": torch.empty(n, dtype=torch.int32, device=dev),
        "row": torch.empty((n, stagecache.ROW_COLS), dtype=torch.float32, device=dev),
        "u4": torch.empty((n, 4), dtype=torch.float32, device=dev),
        "v4": torch.empty((n, 4), dtype=torch.float32, device=dev),
        "w4": (torch.empty((n, 4), dtype=torch.float32, device=dev)
               if vf.W is not None else None),
        "esc": torch.empty(n, dtype=torch.int32, device=dev),
        "oob": torch.empty(n, dtype=torch.bool, device=dev),
    }
    _launch(vf, y, x, q, ti, t1i, zc, wzi, yi_g, xi_g, out, None, 1, iters)
    return out


def cgrid_repair(vf, c, miss, k, y, x, q, ti, t1i, zc, wzi, iters=None):
    """Repair the cache columns ``c`` in place at the lanes of ``miss``, in
    rounds of ``k`` lanes warm-started from ``c["yi"]``, ``c["xi"]``, as
    ``cgrid_repair_plain`` does. Returns (misses, rounds).

    On a CUDA tensor this launches K5 once over the n lanes with
    ``repair_plan``'s slots, and both counts are 0-d tensors on the card:
    nothing is read back to the host. ``c``'s columns must be contiguous
    and the caller's own (the loaded SoA columns are copied first). On a CPU
    tensor it runs the plain version.
    """
    if _device(y, "cgrid_repair") == "cpu":
        return cgrid_repair_plain(vf, c, miss, k, y, x, ti, t1i, zc, wzi)
    n = y.shape[0]
    if n == 0:
        return 0, 0
    slot, cnt, rounds = repair_plan(miss, k)
    _launch(vf, y, x, q, ti, t1i, zc, wzi, c["yi"], c["xi"], c, slot, n // k + 1, iters)
    return cnt, rounds


cgrid_repair.launches = 0

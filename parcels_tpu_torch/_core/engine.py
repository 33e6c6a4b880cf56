"""The execution engine: kernel chain + particle state machine (torch).

Port of the JAX package's ``_core/engine.py``. There the whole inner loop
traces into one ``lax.while_loop``; here it is a Python loop over device
tensors: per-particle dt clamping, the user kernel chain (with RK45 Repeat
resubmission), the position update with the compensated f32 clock,
end-of-loop detection, deletion and error short-circuiting.

State semantics (masked, static shapes):
- kernels run on ALL lanes; writes are merged under the evaluate mask by
  the ``Particles`` view;
- ``Delete`` clears the validity mask instead of removing rows;
- error states / StopAllExecution end the loop; the host inspects the
  returned states and raises the reference's typed exceptions.

Each loop condition (``any(busy) & ~any(halt)``, and the Repeat loop's
``any(repeat)``) is one device-to-host read per step.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from parcels_tpu_torch._core.particles_view import Particles, split_key
from parcels_tpu_torch._core.statuscodes import MIN_ERROR_CODE, StatusCode

__all__ = ["DEFAULT_BLOCK_SIZE", "RESORT_EVERY", "compute_loop_masks", "engine_step", "run_chunk"]

#: particles per sequential block (bounds live intermediate memory)
DEFAULT_BLOCK_SIZE = 2**21

#: re-sort the SoA every N inner steps while in binned+sorted mode, so the
#: positional drift since the chunk-boundary sort never pushes the slab
#: sampler's overflow past its fix-up capacity tier
RESORT_EVERY = 16


# ---------------------------------------------------------------------------
# spatial chunk sorting (feeds ops/binned_sample.py)
# ---------------------------------------------------------------------------


def _pick_sort_field(fieldset, shape_of=None):
    """Name of the largest field that needs the binned sampler, or None.

    Decided on the shapes the fields have on the device, a window's under a
    time window and a band's or tile's slab under a domain (``shape_of``;
    the JAX package reads the host's full shape; the choice sets only the
    lane order, never a sample's value).
    """
    from parcels_tpu_torch._core.field import Field, VectorField
    from parcels_tpu_torch.ops.binned_sample import binned_usable
    from parcels_tpu_torch.ops.interp_kernels import fits_fast_path

    best, best_size = None, -1
    for f in fieldset.fields.values():
        cand = f.U if isinstance(f, VectorField) else f
        if not isinstance(cand, Field) or cand.data.ndim != 4:
            continue
        shape = (shape_of or fieldset._device_shape)(cand)
        if fits_fast_path(shape) or not binned_usable(shape):
            continue
        if int(np.prod(shape)) > best_size:
            best, best_size = cand, int(np.prod(shape))
    return best.name if best is not None else None


def _sort_mode_enabled(fieldset, shape_of=None) -> bool:
    """Sorted mode follows the option and the field shapes (not the device)."""
    if os.environ.get("PARCELS_TPU_SORT_MODE", "auto") in ("0", "off"):
        return False
    return _pick_sort_field(fieldset, shape_of) is not None


def _sort_worthwhile(fieldset, sort_field_name, n_block, z_occ, shape_of=None) -> bool:
    """Will the binned sampler engage at this lane count? Forced sort mode
    always sorts; otherwise an infeasible bin plan makes the sort pure
    overhead."""
    if os.environ.get("PARCELS_TPU_SORT_MODE", "auto") == "force":
        return True
    from parcels_tpu_torch._core.field import VectorField
    from parcels_tpu_torch.ops.binned_sample import plan_feasible

    f = fieldset.fields[sort_field_name]
    cand = f.U if isinstance(f, VectorField) else f
    return plan_feasible((shape_of or fieldset._device_shape)(cand), n_block, z_occ)


def _permute_soa(pdata, order):
    """Reorder every per-lane tensor by ``order`` (one index_select each)."""
    out = dict(pdata)
    n = order.shape[0]
    for k, v in pdata.items():
        if k == "_rng" or v.dim() == 0 or v.shape[0] != n:
            continue
        out[k] = v.index_select(0, order)
    return out


def _sort_soa(fsview, sort_field_name, pdata, z_occ=None):
    """Sort the SoA by the spatial bin of the cached cell index; returns (pdata, order).

    The bin comes from the SoA's ``ei`` cache (updated at every field
    sample), so sorting costs no extra search. Inactive lanes sort to the
    end.
    """
    from parcels_tpu_torch._core.field import VectorFieldView
    from parcels_tpu_torch.ops.binned_sample import sort_key_for

    fv = getattr(fsview, sort_field_name)
    if isinstance(fv, VectorFieldView):
        fv = fv.U
    spec = fv.grid.spec
    ydim, xdim = max(spec.ydim, 1), max(spec.xdim, 1)
    ei = pdata["ei"][:, fv.igrid].to(torch.int32)
    gpos = {
        "Z": {"index": ei // (xdim * ydim)},
        "Y": {"index": (ei // xdim) % ydim},
        "X": {"index": ei % xdim},
    }
    n = pdata["state"].shape[0]
    key = sort_key_for(spec, gpos, tuple(fv.data.shape), n, z_occ)
    key = torch.where(pdata["_active"], key, torch.iinfo(torch.int32).max)
    order = torch.sort(key, stable=True).indices
    return _permute_soa(pdata, order), order


def _unsort_soa(pdata, ord_col):
    """Undo every permutation applied since ``ord_col`` was the identity."""
    inv = torch.empty_like(ord_col, dtype=torch.int64)
    inv[ord_col.long()] = torch.arange(ord_col.shape[0], device=ord_col.device)
    return _permute_soa(pdata, inv)


def run_chunk(
    fieldset,
    kernel_fns: Sequence[Callable],
    farrays,
    pdata: dict,
    endtime: torch.Tensor,
    dt0: torch.Tensor,
    *,
    sign_dt: int,
    rk45_mode: bool,
    z_occ: float | None = None,
) -> dict:
    """Advance every lane to ``endtime`` (one output-interval chunk).

    ``endtime`` and ``dt0`` are 0-dim f32 tensors on the device. Lane
    counts above ``DEFAULT_BLOCK_SIZE`` run as sequential blocks (the count
    must be a multiple of the block size — the ParticleSet pads with
    inactive lanes); blocks are independent, so per-block loops equal one
    global loop.
    """
    from parcels_tpu_torch.ops import stagecache

    kernel_fns = tuple(kernel_fns)
    block_size = DEFAULT_BLOCK_SIZE
    fsview = fieldset.build_views(farrays)
    # the stage cache's fused cell tables, built before the step loop
    stagecache.prebuild_tables(fsview)
    n = pdata["state"].shape[0]

    sort_field = _pick_sort_field(fieldset) if _sort_mode_enabled(fieldset) else None
    sorting = sort_field is not None and _sort_worthwhile(
        fieldset, sort_field, min(n, block_size), z_occ
    )
    resort = None
    if sorting:
        # carry the original lane index through every (re)sort so the final
        # unsort works whatever permutation the inner loop applied
        pdata = dict(pdata)
        pdata["_ord"] = torch.arange(n, dtype=torch.int32, device=pdata["state"].device)
        pdata, _ = _sort_soa(fsview, sort_field, pdata, z_occ)
        resort = lambda pd: _sort_soa(fsview, sort_field, pd, z_occ)[0]  # noqa: E731

    def block(pd):
        return _run_block(
            fsview, pd, endtime, dt0, kernel_fns, sign_dt, rk45_mode, sorting, resort, z_occ
        )

    if n <= block_size:
        out = block(dict(pdata))
    else:
        if n % block_size:
            raise ValueError(
                f"Particle count {n} must be a multiple of block_size {block_size} "
                "(the ParticleSet pads with inactive lanes)."
            )
        # each block draws from its own key, split from the SoA key as the
        # JAX engine splits it; the merged key is block 0's. The split happens
        # at every chunk, so with more than one block the streams depend on
        # the chunk lengths (ParticleSet.execute holds them at their cap
        # unless a step takes longer than the chunk target over the cap).
        nblocks = n // block_size
        keys = split_key(pdata["_rng"], nblocks)
        outs = []
        for b in range(nblocks):
            sl = slice(b * block_size, (b + 1) * block_size)
            outs.append(block({
                k: keys[b] if k == "_rng" else (v if v.dim() == 0 else v[sl])
                for k, v in pdata.items()
            }))
        out = {
            k: outs[0][k] if (k == "_rng" or v.dim() == 0) else torch.cat([o[k] for o in outs])
            for k, v in outs[0].items()
        }
    if sorting:
        out = _unsort_soa(out, out.pop("_ord"))
    return out


def rk45_chunk_start_dt(fsview, pdata, sign_dt):
    """Chunk-start dt for RK45 mode: restore from next_dt, floored at
    RK45_min_dt (a lane that landed on the previous chunk's endtime had its
    dt clamped toward 0)."""
    min_dt = abs(float(fsview.RK45_min_dt))
    nd = pdata["next_dt"]
    return torch.where(nd.abs() < min_dt, min_dt * sign_dt, nd).to(pdata["dt"].dtype)


def compute_loop_masks(pd, endtime, sign_dt):
    """(busy, halt) lane masks driving the chunk loop condition."""
    st = pd["state"]
    act = pd["_active"]
    tte = sign_dt * (endtime - pd["t"])
    busy = act & ((st == StatusCode.Evaluate) | (st == StatusCode.Repeat)) & (tte >= 0)
    halt = act & ((st >= MIN_ERROR_CODE) | (st == StatusCode.StopAllExecution))
    return busy, halt


def _run_block(
    fsview, pdata, endtime, dt0, kernel_fns, sign_dt, rk45_mode,
    sorted_hint=False, resort=None, z_occ=None,
):
    """The full inner time loop for one particle block."""
    # Chunk start: active lanes are requeued for evaluation, EXCEPT error /
    # StopAllExecution lanes, so a chunk dispatched after a halted one is a
    # no-op and the host raises from identical state.
    st = pdata["state"]
    pdata["state"] = torch.where(
        pdata["_active"] & (st < MIN_ERROR_CODE) & (st != StatusCode.StopAllExecution),
        int(StatusCode.Evaluate),
        st,
    ).to(torch.int32)
    if rk45_mode:
        pdata["dt"] = rk45_chunk_start_dt(fsview, pdata, sign_dt)

    it = 0
    while True:
        busy, halt = compute_loop_masks(pdata, endtime, sign_dt)
        if not bool(busy.any() & ~halt.any()):
            break
        pdata = engine_step(
            fsview, pdata, endtime, dt0, kernel_fns, sign_dt, rk45_mode, sorted_hint, z_occ
        )
        it += 1
        if resort is not None and it % RESORT_EVERY == 0:
            pdata = resort(pdata)
    return pdata


def engine_step(
    fsview, pd, endtime, dt0, kernel_fns, sign_dt, rk45_mode, sorted_hint=False, z_occ=None,
):
    """One iteration of the inner loop: kernel chain + state machine update."""
    pd = dict(pd)
    act = pd["_active"]
    st = pd["state"]
    tte = sign_dt * (endtime - pd["t"])
    eval_mask = act & ((st == StatusCode.Success) | (st == StatusCode.Evaluate)) & (tte >= 0)

    # clamp dt so particles land exactly on endtime (reference kernel.py:201-205)
    if sign_dt == 1:
        pd["dt"] = torch.clamp_min(torch.minimum(pd["dt"], tte), 0.0).to(pd["dt"].dtype)
    else:
        pd["dt"] = torch.clamp_max(torch.maximum(pd["dt"], -tte), 0.0).to(pd["dt"].dtype)

    # kernel chain; each kernel is followed by masked Repeat resubmission
    # (RK45 adaptive dt, reference kernel.py:208-218). The C-grid stage cache
    # never crosses a kernel call; its final entries persist in the SoA.
    from parcels_tpu_torch.ops import stagecache

    def call(view):
        stagecache.reset(fsview)
        f(view, fsview)
        stagecache.flush(fsview, pd)
        stagecache.reset(fsview)

    for f in kernel_fns:
        call(Particles(pd, eval_mask, sorted_hint, z_occ))
        while True:
            repeat = pd["_active"] & (pd["state"] == StatusCode.Repeat)
            if not bool(repeat.any()):
                break
            call(Particles(pd, repeat, sorted_hint, z_occ))

    # position/time update for lanes still in a normal state
    # (reference kernel.py:108-120, 222-224)
    st = pd["state"]
    upd = eval_mask & ((st == StatusCode.Evaluate) | (st == StatusCode.Success))
    t_old = pd["t"]
    uview = Particles(pd, upd)
    uview.x = pd["x"] + pd["dx"]
    uview.y = pd["y"] + pd["dy"]
    uview.z = pd["z"] + pd["dz"]
    # compensated (Kahan) f32 clock: _tc carries the low bits lost by t += dt;
    # the clamped landing step snaps t to endtime exactly and clears the carry
    landing = pd["dt"] == (endtime - pd["t"])
    y_inc = pd["dt"] + pd["_tc"]
    t_new = pd["t"] + y_inc
    c_new = y_inc - (t_new - pd["t"])
    t_new = torch.where(landing, endtime.expand(t_new.shape), t_new)
    c_new = torch.where(landing, torch.zeros_like(c_new), c_new)
    uview.t = t_new
    uview._tc = c_new
    uview.dx = torch.zeros_like(pd["dx"])
    uview.dy = torch.zeros_like(pd["dy"])
    uview.dz = torch.zeros_like(pd["dz"])
    if rk45_mode:
        # dt may have grown in the RK45 kernel; floor at RK45_min_dt so an
        # endtime landing's clamped dt never carries into the next chunk
        min_dt = abs(float(fsview.RK45_min_dt))
        nd = pd["next_dt"]
        uview.dt = torch.where(nd.abs() < min_dt, min_dt * sign_dt, nd)
    else:
        # revert to the nominal dt (reference kernel.py:227-228)
        pd["dt"] = dt0.to(pd["dt"].dtype).expand(pd["dt"].shape).clone()

    # mark lanes that reached endtime (reference kernel.py:231-232); the
    # "stuck" clause guards against f32 time underflow (t + dt == t)
    st = pd["state"]
    stuck = upd & (pd["t"] == t_old) & (sign_dt * (endtime - pd["t"]) > 0)
    reached = (pd["t"] == endtime) | stuck
    pd["state"] = torch.where(
        (st == StatusCode.Evaluate) & reached, int(StatusCode.EndofLoop), st
    ).to(torch.int32)

    # deletion clears validity instead of removing rows (reference kernel.py:235)
    pd["_active"] = pd["_active"] & (pd["state"] != StatusCode.Delete)
    return pd

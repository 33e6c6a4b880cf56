"""The C-grid stage's prologue and epilogue: the calls around K5 on the card.

A stage of the curvilinear C-grid stage cache
(``stagecache.cgrid_cached_eval``) is three calls on the card, with no
eager operation between them:

1. ``stage_prologue``: every lane's time and depth brackets
   (``stagecache.stage_brackets``), the escalation codes they imply, the
   depth's out-of-bounds flag and the query coordinates K5 reads
   (``index_search.query_xyz``);
2. K5 (``cgrid_repair.cgrid_stage``, or ``cgrid_full`` for a kernel call's
   first eval);
3. ``stage_epilogue``: the C-grid blend (``stagecache._blend``) from the
   cached rows and face values, the particle state's escalations, the
   warm-start ``ei`` column and the zeroing of out-of-bounds samples.

For tensors on the card each wrapper is one launch of
``csrc/cgrid_stage.cu``, equal bit for bit to its plain version; for tensors
on the CPU the plain versions run (``stage_prologue_plain``,
``stage_epilogue_plain``: the eager code the kernels replace). Positions are
taken as f32, as K5 takes them. ``stage_prologue.launches`` and
``stage_epilogue.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.statuscodes import StatusCode
from parcels_tpu_torch.ops import stagecache
from parcels_tpu_torch.ops.cgrid_repair import _device, _f32

__all__ = [
    "Brackets",
    "stage_epilogue",
    "stage_epilogue_plain",
    "stage_prologue",
    "stage_prologue_plain",
]


class Brackets(NamedTuple):
    """What the prologue gives a stage: the time bracket (``ti``, ``t1i``,
    ``tau``), the depth bracket (``zi_raw`` with its out-of-bounds
    sentinels, ``zc`` clamped to U's levels, ``zeta``, W's ``wzi``), the
    escalation code of the depth and time searches (``esc_zt``, int32),
    whether the depth is out of bounds (``z_oob``) and the query
    coordinates ``q`` (qX, qY, qZ)."""

    ti: torch.Tensor
    t1i: torch.Tensor
    tau: torch.Tensor
    zi_raw: torch.Tensor
    zc: torch.Tensor
    zeta: torch.Tensor
    wzi: torch.Tensor
    esc_zt: torch.Tensor
    z_oob: torch.Tensor
    q: tuple


# ---------------------------------------------------------------------------
# plain versions (the CPU's path, and the reference of the checks)
# ---------------------------------------------------------------------------


def stage_prologue_plain(vf, t, z, y, x) -> Brackets:
    """The stage's brackets, escalation codes and query coordinates."""
    ti, t1i, tau, t_oob, zi_raw, zc, zeta, wzi, _ = stagecache.stage_brackets(vf, t, z)
    # escalations independent of the X/Y search (field._update_state_position)
    esc_zt = torch.maximum(
        torch.where(zi_raw == index_search.RIGHT_OUT_OF_BOUNDS,
                    int(StatusCode.ErrorOutOfBounds), 0),
        torch.where(zi_raw == index_search.LEFT_OUT_OF_BOUNDS,
                    int(StatusCode.ErrorThroughSurface), 0),
    )
    if t_oob is not None:
        esc_zt = torch.maximum(
            esc_zt, torch.where(t_oob, int(StatusCode.ErrorOutsideTimeInterval), 0)
        )
    esc_zt = esc_zt.to(torch.int32)
    z_oob = zi_raw < 0
    q = index_search.query_xyz(y, x, vf.grid.spec.spherical)
    return Brackets(ti, t1i, tau, zi_raw, zc, zeta, wzi, esc_zt, z_oob, q)


def stage_epilogue_plain(vf, c, xsi, eta, b: Brackets, y, particles):
    """The stage's velocities from the cache ``c`` and K5's (xsi, eta):
    (u, v), or (u, v, w) for a 3-D view. With ``particles`` the state is
    escalated and the ``ei`` column refreshed under their mask."""
    from parcels_tpu_torch._core.field import _escalate

    spec = vf.grid.spec
    Zw = vf.W.data.shape[1] if vf.W is not None else 1
    u, v, w = stagecache._blend(spec, c["row"], xsi, eta, b.tau, b.zeta, c["u4"], c["v4"],
                                c["w4"], Zw, y)
    if particles is not None:
        particles.state = torch.maximum(particles.state, torch.maximum(b.esc_zt, c["esc"]))
        _escalate(particles, torch.isnan(u) | torch.isnan(v) | torch.isnan(w),
                  StatusCode.ErrorInterpolation)
        # refresh the warm-start ei cache (field._update_particles_ei)
        ydim, xdim = max(spec.ydim, 1), max(spec.xdim, 1)
        particles._set_ei(vf.igrid, (b.zc * ydim + c["yi"]) * xdim + c["xi"])

    # out-of-bounds samples return 0 (reference field.py:359-370)
    mask0 = c["oob"] | b.z_oob
    u = torch.where(mask0, 0.0, u)
    v = torch.where(mask0, 0.0, v)
    w = torch.where(mask0, 0.0, w)
    if vf.vector_type == "3D":
        return (u, v, w)
    return (u, v)


# ---------------------------------------------------------------------------
# the kernels' launches
# ---------------------------------------------------------------------------

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


class _Axis(ctypes.Structure):
    """csrc/cgrid_stage.cu's StageAxis."""

    _fields_ = [("nodes", _P), ("n", _I), ("uniform", _I),
                ("origin", _F), ("inv", _F), ("lo", _F), ("hi", _F)]


class _PrologueArgs(ctypes.Structure):
    """csrc/cgrid_stage.cu's PrologueArgs, field for field."""

    _fields_ = [
        ("n", _L), ("t", _P), ("z", _P), ("y", _P), ("x", _P),
        ("time", _Axis), ("depth", _Axis),
        ("T", _I), ("Z", _I), ("has_w", _I), ("off_z", _I), ("wz_hi", _I), ("spherical", _I),
        ("esc_oob", _I), ("esc_surface", _I), ("esc_time", _I),
        ("ti", _P), ("t1i", _P), ("tau", _P), ("zi_raw", _P), ("zc", _P), ("zeta", _P),
        ("wzi", _P), ("esc", _P), ("z_oob", _P), ("qx", _P), ("qy", _P), ("qz", _P),
    ]


class _EpilogueArgs(ctypes.Structure):
    """csrc/cgrid_stage.cu's EpilogueArgs, field for field."""

    _fields_ = [
        ("n", _L), ("row", _P), ("xsi", _P), ("eta", _P), ("tau", _P), ("zeta", _P),
        ("y", _P), ("u4", _P), ("v4", _P), ("w4", _P),
        ("zeta_blend", _I), ("spherical", _I), ("deg2m", _F), ("rad", _F),
        ("esc_zt", _P), ("c_esc", _P), ("c_oob", _P), ("z_oob", _P),
        ("zc", _P), ("yi", _P), ("xi", _P), ("ydim", _I), ("xdim", _I),
        ("mask", _P), ("state", _P), ("ei", _P), ("ngrids", _I), ("igrid", _I),
        ("esc_interp", _I),
        ("u", _P), ("v", _P), ("w", _P), ("new_state", _P), ("new_ei", _P),
    ]


class _Lanes:
    """The addresses of a launch's lane tensors, each checked for its dtype,
    shape and device; a lane input of another dtype or layout is converted
    and kept alive until the launch is queued."""

    def __init__(self, name, n, device):
        self.name, self.n, self.device, self.keep = name, n, device, []

    def __call__(self, t, what, dtype, cols=None, convert=True):
        shape = (self.n,) if cols is None else (self.n, cols)
        if convert and (t.dtype != dtype or not t.is_contiguous()):
            t = t.to(dtype).contiguous()
            self.keep.append(t)
        if t.dtype != dtype or t.device != self.device or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{self.name}: {what} must be a contiguous {dtype} {shape} tensor "
                             f"on {self.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        return t.data_ptr()


def _axis(ax, nodes, uniform):
    """A StageAxis: the nodes (f32 on the card) and, for a uniform axis, the
    closed form's constants as torch rounds them (f32 of the origin, of the
    step's reciprocal taken in double, of the bounds)."""
    if nodes.dtype != torch.float32 or nodes.dim() != 1 or not nodes.is_contiguous():
        raise ValueError("cgrid_stage: an axis must be a contiguous 1-D f32 tensor")
    ax.nodes, ax.n = nodes.data_ptr(), nodes.shape[0]
    if uniform is not None:
        origin, step, last = uniform
        ax.uniform, ax.origin, ax.inv = 1, _f32(origin), _f32(1.0 / step)
        ax.lo, ax.hi = _f32(origin), _f32(last)


def stage_prologue(vf, t, z, y, x) -> Brackets:
    """``stage_prologue_plain``'s brackets, codes and query coordinates of
    every lane of a stage. On a CUDA tensor this is one launch
    (``stage_prologue.launches`` counts them); on a CPU tensor it runs the
    plain version."""
    if _device(y, "stage_prologue") == "cpu":
        return stage_prologue_plain(vf, t, z, y, x)
    from parcels_tpu_torch.ops._build import load

    spec, garrs = vf.grid.spec, vf.grid.garrs
    n, dev = y.shape[0], y.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = Brackets(
        ti=torch.empty(n, **i32), t1i=torch.empty(n, **i32), tau=torch.empty(n, **f32),
        zi_raw=torch.empty(n, **i32), zc=torch.empty(n, **i32), zeta=torch.empty(n, **f32),
        wzi=torch.empty(n, **i32), esc_zt=torch.empty(n, **i32),
        z_oob=torch.empty(n, dtype=torch.bool, device=dev),
        q=(torch.empty(n, **f32), torch.empty(n, **f32), torch.empty(n, **f32)),
    )
    if n == 0:
        return out
    a = _PrologueArgs()
    lane = _Lanes("stage_prologue", n, dev)
    a.n = n
    a.t, a.z = lane(t, "t", torch.float32), lane(z, "z", torch.float32)
    a.y, a.x = lane(y, "y", torch.float32), lane(x, "x", torch.float32)
    if vf.U.has_time and garrs["time"].shape[0] >= 2:
        _axis(a.time, garrs["time"], spec.time_uniform)
    if "Z" in spec.axes and garrs["depth"].shape[0] >= 2:
        _axis(a.depth, garrs["depth"], spec.depth_uniform)
    a.T, a.Z = vf.U.data.shape[0], vf.U.data.shape[1]
    if vf.W is not None:
        a.has_w, a.off_z, a.wz_hi = 1, spec.offset_z, max(vf.W.data.shape[1] - 2, 0)
    a.spherical = int(spec.spherical)
    a.esc_oob = int(StatusCode.ErrorOutOfBounds)
    a.esc_surface = int(StatusCode.ErrorThroughSurface)
    a.esc_time = int(StatusCode.ErrorOutsideTimeInterval)
    a.ti, a.t1i, a.tau = out.ti.data_ptr(), out.t1i.data_ptr(), out.tau.data_ptr()
    a.zi_raw, a.zc, a.zeta = out.zi_raw.data_ptr(), out.zc.data_ptr(), out.zeta.data_ptr()
    a.wzi, a.esc, a.z_oob = out.wzi.data_ptr(), out.esc_zt.data_ptr(), out.z_oob.data_ptr()
    a.qx, a.qy, a.qz = (v.data_ptr() for v in out.q)
    err = load("cgrid_stage")(0, ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cgrid_stage prologue launch failed with cudaError {err}")
    stage_prologue.launches += 1
    return out


def stage_epilogue(vf, c, xsi, eta, b: Brackets, y, particles):
    """``stage_epilogue_plain``'s velocities, state and ``ei`` column: on a
    CUDA tensor one launch (``stage_epilogue.launches`` counts them), which
    writes new state and ``ei`` tensors into the particles' SoA; on a CPU
    tensor the plain version."""
    if _device(y, "stage_epilogue") == "cpu":
        return stage_epilogue_plain(vf, c, xsi, eta, b, y, particles)
    from parcels_tpu_torch.ops._build import load

    spec = vf.grid.spec
    n, dev = y.shape[0], y.device
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    w = torch.empty(n, dtype=f32, device=dev) if vf.vector_type == "3D" else None
    a = _EpilogueArgs()
    lane = _Lanes("stage_epilogue", n, dev)
    a.n = n
    a.row = lane(c["row"], "the cached rows", f32, stagecache.ROW_COLS)
    a.xsi, a.eta = lane(xsi, "xsi", f32), lane(eta, "eta", f32)
    a.tau, a.zeta, a.y = lane(b.tau, "tau", f32), lane(b.zeta, "zeta", f32), lane(y, "y", f32)
    a.u4, a.v4 = lane(c["u4"], "u4", f32, 4), lane(c["v4"], "v4", f32, 4)
    if c["w4"] is not None:
        a.w4 = lane(c["w4"], "w4", f32, 4)
        a.zeta_blend = int(vf.W.data.shape[1] > 1)
    a.spherical = int(spec.spherical)
    a.deg2m, a.rad = _f32(spec.deg2m), _f32(math.pi / 180.0)
    a.esc_zt, a.c_esc = lane(b.esc_zt, "esc_zt", i32), lane(c["esc"], "esc", i32)
    a.c_oob, a.z_oob = lane(c["oob"], "oob", u8), lane(b.z_oob, "z_oob", u8)
    a.zc, a.yi, a.xi = lane(b.zc, "zc", i32), lane(c["yi"], "yi", i32), lane(c["xi"], "xi", i32)
    a.ydim, a.xdim = max(spec.ydim, 1), max(spec.xdim, 1)
    a.u, a.v = u.data_ptr(), v.data_ptr()
    if w is not None:
        a.w = w.data_ptr()
    if particles is not None:
        pd = particles._data
        state = pd["state"]
        ei = pd["ei"]
        new_state, new_ei = torch.empty_like(state), torch.empty(ei.shape, dtype=i32, device=dev)
        a.mask = lane(particles._mask, "the lane mask", u8)
        a.state = lane(state, "state", i32, convert=False)
        a.ngrids, a.igrid = ei.shape[1], vf.igrid
        a.ei = lane(ei, "ei", i32, a.ngrids, convert=False)
        a.esc_interp = int(StatusCode.ErrorInterpolation)
        a.new_state, a.new_ei = new_state.data_ptr(), new_ei.data_ptr()
    if n:
        err = load("cgrid_stage")(1, ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"cgrid_stage epilogue launch failed with cudaError {err}")
        stage_epilogue.launches += 1
    if particles is not None:
        pd["state"], pd["ei"] = new_state, new_ei
    if w is not None:
        return (u, v, w)
    return (u, v)


stage_prologue.launches = 0
stage_epilogue.launches = 0

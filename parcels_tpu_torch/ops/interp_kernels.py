"""K1: direct multilinear sampling of small fields.

Port of the JAX package's fold sampler (``ops/interp_kernels.py``). There a
W-level time window of a field that fits on-chip is folded to a dense
matrix and contracted with hat weights on the TPU's matrix unit, with a
lockstep time window and a gather fallback around it. On the card the
hand-written kernel (``csrc/fold_sample.cu``) reads each lane's 16 stencil
corners of the whole (T, Z, Y, X) field directly: such a field is at most
4 MB and stays in L2, so no window is needed. On every evaluated lane the
result equals the gather path (``interpolators/xinterp._multilinear``).

``fold_sample`` launches the kernel for tensors on the card and uses its
plain PyTorch version, ``fold_sample_plain``, only for tensors on the CPU.
"""

from __future__ import annotations

import torch

__all__ = [
    "edge_positions",
    "fits_fast_path",
    "fold_sample",
    "fold_sample_plain",
    "positions_from_gpos",
]

#: levels in the fold the dispatcher sizes (as in the JAX package)
TIME_WINDOW = 4
#: max rows*X f32 elements of the folded window (4 MB)
MAX_FOLDED_ELEMS = 1 << 20
#: max padded X extent of the fold
MAX_FOLDED_X = 1024


def fits_fast_path(shape4) -> bool:
    """Static check: does this field take K1 (the JAX package's fold budget)?"""
    T, Z, Y, X = shape4
    W = min(TIME_WINDOW, T)
    Rp = -(-(W * Z * Y) // 8) * 8
    Xp = -(-X // 128) * 128
    return Rp * Xp <= MAX_FOLDED_ELEMS and Xp <= MAX_FOLDED_X


def positions_from_gpos(gpos, shape4):
    """Fractional positions (index + bcoord per axis) from a search result.

    Axes whose data extent is 1 pin the position to 0 (no blend), matching
    the reference's lenT/lenZ == 1 semantics.
    """

    def pos(axis, dim):
        idx = gpos[axis]["index"].to(torch.float32)
        if dim == 1:
            return torch.zeros_like(idx)
        return idx + gpos[axis]["bcoord"].to(torch.float32)

    return tuple(pos(ax, dim) for ax, dim in zip("TZYX", shape4))


def hat_stencil(p: torch.Tensor, dim: int):
    """Per-axis 2-point stencil ``[(corner, weight, valid), ...]``.

    The lower corner is ``floor(p)`` (NaN -> 0, far-out positions clamped
    just outside the axis); weights are ``max(0, 1 - |c - p|)`` with NaN
    propagating; a corner outside ``[0, dim)`` is invalid and contributes
    nothing. Mirrored by ``csrc/hat.cuh``.
    """
    f = torch.nan_to_num(torch.floor(p), nan=0.0).clamp(-2.0, float(dim))
    out = []
    for k in (0, 1):
        c = f + k
        w = torch.clamp_min(1.0 - (c - p).abs(), 0.0)
        ci = c.to(torch.int64)
        out.append((ci, w, (ci >= 0) & (ci < dim)))
    return out


def fold_sample_plain(data: torch.Tensor, post, posz, posy, posx) -> torch.Tensor:
    """Plain PyTorch version of K1, operation for operation."""
    T, Z, Y, X = data.shape
    flat = data.reshape(-1)
    st = [hat_stencil(p, d) for p, d in zip((post, posz, posy, posx), (T, Z, Y, X))]
    acc = torch.zeros_like(post)
    for ct, wt, vt in st[0]:
        for cz, wz, vz in st[1]:
            for cy, wy, vy in st[2]:
                for cx, wx, vx in st[3]:
                    ok = vt & vz & vy & vx
                    lin = ((ct * Z + cz) * Y + cy) * X + cx
                    v = flat[torch.where(ok, lin, 0)]
                    w = ((wt * wz) * wy) * wx
                    acc = acc + torch.where(ok, w * v, 0.0)
    return acc


def edge_positions(shape4, n, seed=0, device="cpu"):
    """Positions that reach K1's edge cases, mixed with uniform ones: lanes
    at x0 = X - 1 and at x0 % 4 == 3, corners just outside each axis, far-out
    positions (+-1e30, -10) and NaN."""
    g = torch.Generator().manual_seed(seed)
    pos = [torch.rand(n, generator=g) * (d + 1.0) - 1.0 for d in shape4]
    X = shape4[3]
    frac = torch.rand(n, generator=g)
    quad = torch.randint(0, max(X // 4, 1), (n,), generator=g) * 4 + 3
    pos[3][0::7] = (X - 1) + frac[0::7]
    pos[3][1::7] = quad[1::7].to(torch.float32) + frac[1::7]
    pos[0][2::13] = float("nan")
    pos[1][3::17] = 1e30
    pos[2][4::19] = -1e30
    pos[3][5::23] = -10.0
    pos[3][6::29] = float("nan")
    return [p.to(device) for p in pos]


def _check(name, t, dtype, device, shape=None):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on {device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def fold_sample(data: torch.Tensor, post, posz, posy, posx) -> torch.Tensor:
    """Multilinear sample of the (T, Z, Y, X) field at fractional positions.

    On a CUDA tensor this launches K1 (``fold_sample.launches`` counts the
    launches); on a CPU tensor it runs the plain version.
    """
    if data.device.type == "cpu":
        return fold_sample_plain(data, post, posz, posy, posx)
    if data.device.type != "cuda" or data.dim() != 4:
        raise ValueError(f"fold_sample: expected a 4-D CUDA or CPU field, got {data.device}")
    n = post.shape[0]
    _check("data", data, torch.float32, data.device)
    for name, p in (("post", post), ("posz", posz), ("posy", posy), ("posx", posx)):
        _check(name, p, torch.float32, data.device, (n,))
    out = torch.empty(n, dtype=torch.float32, device=data.device)
    if n == 0:
        return out
    from parcels_tpu_torch.ops._build import load

    launch = load("fold_sample")
    T, Z, Y, X = data.shape
    err = launch(
        data.data_ptr(), T, Z, Y, X, post.data_ptr(), posz.data_ptr(), posy.data_ptr(),
        posx.data_ptr(), out.data_ptr(), n, torch.cuda.current_stream(data.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fold_sample kernel launch failed with cudaError {err}")
    fold_sample.launches += 1
    return out


fold_sample.launches = 0

"""Rectilinear index search over whole particle batches (torch).

Port of the JAX package's ``_core/index_search.py`` (``search_1d``,
``search_time``): 1-D bracketing uses an O(1) analytic index when the axis
is uniformly spaced (detected at ingest) and a searchsorted otherwise.
Out-of-bounds lanes carry the reference's sentinel codes (-1 right, -2
left, -3 search error) so the status-machine semantics carry over unchanged.

The curvilinear search belongs to a later slice of the port.
"""

from __future__ import annotations

import torch

__all__ = [
    "GRID_SEARCH_ERROR",
    "LEFT_OUT_OF_BOUNDS",
    "RIGHT_OUT_OF_BOUNDS",
    "search_1d",
    "search_time",
]

GRID_SEARCH_ERROR = -3
LEFT_OUT_OF_BOUNDS = -2
RIGHT_OUT_OF_BOUNDS = -1


def search_1d(
    arr: torch.Tensor,
    x: torch.Tensor,
    uniform: tuple[float, float, float] | None = None,
    oob_bounds: tuple[float, float] | None = None,
):
    """Bracket positions ``x`` in strictly-increasing 1-D ``arr``.

    Returns ``(index, bcoord)``: ``index`` is the int32 left bracket (or an
    OOB sentinel) and ``bcoord`` the barycentric coordinate.
    ``uniform=(origin, step, last)`` selects the O(1) path.
    """
    n = arr.shape[0]
    if n < 2:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device), torch.zeros_like(x)

    if uniform is not None:
        origin, step, last = uniform
        inv = 1.0 / step
        s = (x - origin) * inv
        fidx = torch.clamp(torch.floor(s), 0, n - 2)
        # a NaN position brackets cell 0 (its bcoord stays NaN), as XLA's
        # saturating float->int conversion does in the reference
        idx = torch.nan_to_num(fidx, nan=0.0).to(torch.int32)
        bcoord = s - fidx
        lo, hi = (origin, last) if oob_bounds is None else oob_bounds
        idx = torch.where(x < lo, LEFT_OUT_OF_BOUNDS, idx)
        idx = torch.where(x > hi, RIGHT_OUT_OF_BOUNDS, idx).to(torch.int32)
        return idx, bcoord

    if n <= 128:
        # count of nodes <= x, as the reference's broadcast compare does
        # (a NaN position counts 0 nodes and brackets cell 0)
        ins = (x[..., None] >= arr).sum(dim=-1).to(torch.int32)
    else:
        ins = torch.searchsorted(arr, x.contiguous(), right=True).to(torch.int32)
    idx = torch.clamp(ins - 1, 0, n - 2)
    left = arr[idx.long()]
    right = arr[idx.long() + 1]
    bcoord = (x - left) / (right - left)

    if oob_bounds is None:
        lo, hi = arr[0], arr[-1]
    else:
        lo, hi = oob_bounds
    idx = torch.where(x < lo, LEFT_OUT_OF_BOUNDS, idx)
    idx = torch.where(x > hi, RIGHT_OUT_OF_BOUNDS, idx).to(torch.int32)
    return idx, bcoord


def search_time(time_flt: torch.Tensor, t: torch.Tensor, uniform=None):
    """Bracket simulation times in the field's time axis (float seconds).

    Out-of-interval times are clamped to the first / last bracket and
    reported through a separate boolean (ErrorOutsideTimeInterval).
    """
    n = time_flt.shape[0]
    if n < 2:
        zi = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
        return zi, torch.zeros_like(t), torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    oob = (t < time_flt[0]) | (t > time_flt[-1])
    idx, bc = search_1d(time_flt, t, uniform)
    idx = torch.clamp(idx, 0, n - 2)
    bc = torch.clamp(bc, 0.0, 1.0)
    return idx, bc, oob

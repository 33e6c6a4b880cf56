"""The yardstick's arithmetic: published peaks of one NVIDIA H100 (SXM, dense
float32 outside the tensor cores, HBM3) and the bytes and operations that
K2 and K5 need for their inputs, counted once each.

A kernel's roofline share is the least time its inputs need, the larger of
bytes over the bandwidth and operations over the float32 rate, over the
device time the trace gives it. The counts come from what the inputs need,
never from what the kernel reports it did: a kernel that does less work for
the same inputs reads as faster, not as held to a smaller bound.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: K2 (the slab sampler): a lane reads 4 int32 cell indices and 4 f32
#: barycentric coordinates and writes one f32 value
K2_LANE_BYTES = 4 * 4 + 4 * 4 + 4
#: f32 operations a lane: 4 weights (1 - bcoord) and 16 corners (4
#: multiplies, 1 add)
K2_LANE_OPS = 4 + 16 * 5

#: K5 (the C-grid stage): one point-in-cell evaluation, about 80 f32
#: operations (tangent-frame projection 13, bilinear inverse about 45,
#: tolerance tests and selection about 20)
K5_PIC_OPS = 80
#: what a stage's check needs of every lane: the cached row's 15 pic columns
#: (60 B), its cell, time, depth and w-depth indices (16), the stage's time
#: and depth brackets (12), y, x and q (20), the lane mask (1), and (xsi,
#: eta) written (8)
K5_CHECK_BYTES = 60 + 16 + 12 + 20 + 1 + 8
#: what a miss needs besides: the found cell's 15 pic columns (60 B) and its
#: 10 geometry columns (40), the U/V face values gathered (32), the 25-column
#: row and the face values written (100 + 32), its brackets written (12)
K5_MISS_BYTES = 60 + 40 + 32 + 100 + 32 + 12


def least_seconds(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S)


def k2_need(lanes: int, touched_field_bytes: int):
    """(bytes, operations) of K2 calls over ``lanes`` live lanes in all,
    whose stencils touch ``touched_field_bytes`` distinct field bytes."""
    return lanes * K2_LANE_BYTES + touched_field_bytes, lanes * K2_LANE_OPS


def k5_need(checked: int, misses: int):
    """(bytes, operations) of K5 stages that checked ``checked`` lanes of
    which ``misses`` left their cached cell: one check a lane, one
    evaluation and one new row a miss."""
    return (checked * K5_CHECK_BYTES + misses * K5_MISS_BYTES,
            (checked + misses) * K5_PIC_OPS)


def distinct_nodes(j, i, nx: int, torch) -> int:
    """Distinct nodes among the 2 x 2 corners of the cells (j, i) (int64
    tensors) of a grid ``nx`` nodes wide."""
    keys = torch.cat([(j + dj) * nx + (i + di) for dj in (0, 1) for di in (0, 1)])
    return int(torch.unique(keys).numel())

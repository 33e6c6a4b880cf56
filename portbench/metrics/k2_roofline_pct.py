"""K2's share of its roofline over the traced piece: the least time its
calls' inputs need over the device time of K2's kernel in the trace.

A K2 call samples one field for the live lanes of one engine block. Its
inputs are each lane's 36 bytes (count.K2_LANE_BYTES) and the distinct field
values the lanes' stencils touch, counted once: 2 times x 2 x 2 corners of a
surface cell. The traced piece's calls are counted from the trace, and each
block's lanes and distinct corners from the lanes the piece left (the set's
order and cells at its end: one step moves a lane a small part of a cell).
"""

import count

KERNELS = ("slab_sample_kernel",)


def after(run, pset):
    """Per engine block: (live lanes, distinct corner nodes of their cells)."""
    import torch

    from parcels_tpu_torch._core.engine import DEFAULT_BLOCK_SIZE

    spec = run.fs.gridset[0].spec
    if spec.curvilinear or spec.lon_uniform is None or spec.lat_uniform is None:
        return None
    (x0, dx, _), (y0, dy, _) = spec.lon_uniform, spec.lat_uniform
    d = pset._data
    blocks = []
    for s in range(0, d["x"].shape[0], DEFAULT_BLOCK_SIZE):
        live = d["_active"][s:s + DEFAULT_BLOCK_SIZE]
        x = d["x"][s:s + DEFAULT_BLOCK_SIZE][live].double()
        y = d["y"][s:s + DEFAULT_BLOCK_SIZE][live].double()
        i = torch.clamp(torch.floor((x - x0) / dx), 0, spec.xdim - 1).long()
        j = torch.clamp(torch.floor((y - y0) / dy), 0, spec.ydim - 1).long()
        blocks.append((int(live.sum()), count.distinct_nodes(j, i, spec.xdim + 1, torch)))
    return blocks


def read(ctx):
    spans = ctx.kernels(*KERNELS)
    blocks = ctx.extra.get("k2_roofline_pct")
    blocks = [b for b in blocks or () if b[0] > 0]
    if not spans or not blocks:
        return None
    busy = sum(b - a for _, a, b in spans) / 1e9
    calls_per_block = len(spans) / len(blocks)
    lanes = sum(n for n, _ in blocks) * calls_per_block
    touched = sum(2 * 4 * u for _, u in blocks) * calls_per_block
    nbytes, nops = count.k2_need(lanes, touched)
    return 100.0 * count.least_seconds(nbytes, nops) / busy

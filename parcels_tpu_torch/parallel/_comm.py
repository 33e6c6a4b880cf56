"""The collectives of the scale-out, over ``torch.distributed``.

The JAX package runs its bands and tiles as devices of one mesh, inside one
``shard_map`` program, whose collectives are ``pmax`` (the loop condition),
``ppermute`` and a ragged ``all_to_all`` (migration) and
``process_allgather`` (gathering the SoA). The port runs one process per
rank (SPMD); this module gives it those collectives and nothing more:

- ``allreduce_max`` of a small integer tensor (``pmax``);
- ``all_to_all_rows``: each rank sends a group of rows (a dict of columns)
  to every rank, the counts first, then the rows packed into one byte
  matrix (``ppermute`` hops and the ragged ``all_to_all``);
- ``allgather_rows``: every rank's rows, in rank order.

The transport is fixed by the backend of the process group:

- ``nccl``: the device tensors go to the collective as they are;
- ``gloo`` with CUDA tensors: each collective copies its bytes through
  reused pinned host buffers (gloo's ``all_to_all`` takes CPU tensors).
  This is how ranks that share one card meet: NCCL refuses two ranks on
  one device. ``comm_stats()`` counts the calls, bytes and host seconds of
  every collective, staged or not;
- ``gloo`` with CPU tensors: the tensors go as they are.

A collective that fails raises; no transport replaces another.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["all_to_all_rows", "allgather_rows", "allreduce_max", "comm_stats", "host_rows",
           "local_rank", "transport", "world"]


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``, else the rank)."""
    return int(os.environ.get("LOCAL_RANK", world()[0]))


def transport() -> str:
    """``"none"`` (one process), ``"nccl"`` (device tensors), or ``"gloo"``
    (CPU tensors as they are, CUDA tensors staged through pinned host
    buffers)."""
    if world()[1] == 1:
        return "none"
    return "nccl" if dist.get_backend() == "nccl" else "gloo"


class _Stats:
    """Per-process counts of the collectives and the pinned staging buffers."""

    def __init__(self):
        self.counts = {"calls": 0, "bytes": 0, "host_s": 0.0, "staged_calls": 0,
                       "staged_bytes": 0}
        self._pinned: dict[str, torch.Tensor] = {}

    def pinned(self, slot: str, nbytes: int) -> torch.Tensor:
        """A reused pinned host buffer of at least ``nbytes`` bytes."""
        buf = self._pinned.get(slot)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8, pin_memory=True)
            self._pinned[slot] = buf
        return buf[:nbytes]


_STATS = _Stats()


def comm_stats(reset: bool = False) -> dict:
    """Calls, bytes moved and host seconds of this rank's collectives, and
    the calls and bytes that were staged through pinned host buffers (gloo
    with CUDA tensors). ``reset`` sets the counts to 0 after reading."""
    out = dict(_STATS.counts, transport=transport())
    if reset:
        for k in _STATS.counts:
            _STATS.counts[k] = 0.0 if k == "host_s" else 0
    return out


def _staged(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and transport() == "gloo"


def _to_host(t: torch.Tensor, slot: str) -> torch.Tensor:
    """``t`` (a contiguous uint8 device tensor) copied into a pinned buffer."""
    host = _STATS.pinned(slot, t.numel()).view(t.shape)
    host.copy_(t)
    return host


def _count(t0: float, nbytes: int, staged: bool) -> None:
    c = _STATS.counts
    c["calls"] += 1
    c["bytes"] += nbytes
    c["host_s"] += time.perf_counter() - t0
    if staged:
        c["staged_calls"] += 1
        c["staged_bytes"] += nbytes


def allreduce_max(t: torch.Tensor) -> torch.Tensor:
    """Element-wise max of a small integer tensor over all ranks, returned
    on the host (it decides the host's control flow)."""
    host = t.detach().to("cpu", torch.int64).contiguous()
    if world()[1] == 1:
        return host
    t0 = time.perf_counter()
    if transport() == "nccl":
        dev = host.to(t.device)
        dist.all_reduce(dev, op=dist.ReduceOp.MAX)
        host = dev.cpu()
    else:
        dist.all_reduce(host, op=dist.ReduceOp.MAX)
    _count(t0, host.numel() * 8, False)
    return host


def _pack(cols: dict, n: int, device) -> tuple[torch.Tensor, list]:
    """Columns of ``n`` rows as one (n, B) uint8 matrix, and their layout."""
    layout, parts = [], []
    for k in sorted(cols):
        v = cols[k].contiguous()
        flat = v.reshape(n, int(np.prod(v.shape[1:], dtype=np.int64)))
        raw = flat.view(torch.uint8) if flat.dtype != torch.bool else flat.to(torch.uint8)
        layout.append((k, v.dtype, tuple(v.shape[1:]), raw.shape[1]))
        parts.append(raw)
    if not parts:
        return torch.empty((n, 0), dtype=torch.uint8, device=device), layout
    return torch.cat(parts, dim=1), layout


def _unpack(mat: torch.Tensor, layout) -> dict:
    out, off = {}, 0
    n = mat.shape[0]
    for k, dtype, shape, width in layout:
        raw = mat[:, off:off + width].clone(memory_format=torch.contiguous_format)
        off += width
        v = raw.bool() if dtype == torch.bool else raw.view(dtype)
        out[k] = v.reshape((n,) + shape)
    return out


def all_to_all_rows(cols: dict, send_counts, device) -> tuple[dict, list]:
    """Send rows to every rank; receive every rank's rows for this one.

    ``cols`` holds columns whose rows are grouped by destination rank in
    rank order, ``send_counts[r]`` rows for rank r. Returns the received
    columns (grouped by source rank, in rank order) and the counts received
    from each rank. Every rank must call it, also with nothing to send.
    """
    send_counts = [int(c) for c in send_counts]
    n = sum(send_counts)
    mat, layout = _pack(cols, n, device)
    _, size = world()
    if size == 1:
        return _unpack(mat, layout), send_counts
    t0 = time.perf_counter()
    staged = _staged(mat)
    cin = torch.tensor(send_counts, dtype=torch.int64)
    cout = torch.empty_like(cin)
    if transport() == "nccl":
        dev_out = torch.empty_like(cin, device=mat.device)
        dist.all_to_all_single(dev_out, cin.to(mat.device))
        cout = dev_out.cpu()
    else:
        dist.all_to_all_single(cout, cin)
    recv_counts = cout.tolist()
    width = mat.shape[1]
    if staged:
        send = _to_host(mat, "a2a_send")
        recv = _STATS.pinned("a2a_recv", sum(recv_counts) * width).view(sum(recv_counts), width)
    else:
        send = mat
        recv = torch.empty((sum(recv_counts), width), dtype=torch.uint8, device=mat.device)
    if width:
        dist.all_to_all_single(recv, send, output_split_sizes=recv_counts,
                               input_split_sizes=send_counts)
    if staged:
        recv = recv.to(mat.device)
    _count(t0, (n + sum(recv_counts)) * width + 16 * size, staged)
    return _unpack(recv, layout), recv_counts


def allgather_rows(cols: dict, device) -> dict:
    """Every rank's rows of ``cols`` concatenated in rank order (the rank
    counts may differ)."""
    n = next(iter(cols.values())).shape[0]
    mat, layout = _pack(cols, n, device)
    _, size = world()
    if size == 1:
        return _unpack(mat, layout)
    t0 = time.perf_counter()
    staged = _staged(mat)
    nccl = transport() == "nccl"
    home = mat.device
    if nccl and home.type != "cuda":
        mat = mat.to(torch.device("cuda", torch.cuda.current_device()))
    cnt = torch.tensor([n], dtype=torch.int64, device=mat.device if nccl else "cpu")
    counts = [torch.empty_like(cnt) for _ in range(size)]
    dist.all_gather(counts, cnt)
    counts = [int(c.item()) for c in counts]
    width, top = mat.shape[1], max(counts)
    if staged:
        send = _STATS.pinned("ag_send", top * width).view(top, width)
        send[:n].copy_(mat)
        recv = _STATS.pinned("ag_recv", size * top * width).view(size, top, width)
    else:
        send = torch.zeros((top, width), dtype=torch.uint8, device=mat.device)
        send[:n] = mat
        recv = torch.empty((size, top, width), dtype=torch.uint8, device=mat.device)
    if width:
        dist.all_gather(list(recv.unbind(0)), send)
    rows = torch.cat([recv[r, :counts[r]] for r in range(size)]).to(home)
    _count(t0, (n + sum(counts)) * width, staged)
    return _unpack(rows, layout)


def host_rows(values, dtype=np.float64) -> np.ndarray:
    """A small host vector from every rank, stacked in rank order: (world, k)."""
    row = torch.as_tensor(np.asarray(values, dtype=dtype)[None])
    return allgather_rows({"v": row}, "cpu")["v"].numpy()

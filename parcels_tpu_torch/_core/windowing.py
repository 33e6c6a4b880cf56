"""Staging of time-window slabs: reused pinned buffers and a copy stream.

``TimeWindow`` is a fieldset's rolling window (``FieldSet.set_time_window``):
the stager, the prefetch thread and the windows it is staging, the window
in use and the counts ``window_stats`` reports. A window is every
time-varying field's ``L`` levels plus the grids' ``L`` time values. The
host reads them (from a lazy store, or a resident numpy field) into one
staging buffer, laid out as byte ranges, and the buffer crosses to the
device in ONE copy; the window's tensors are views of that device block.

On CUDA there are two staging buffers in pinned memory, each sized one
window and reused window after window, and one ``torch.cuda.Stream`` for
the copies. ``stage`` may run on the prefetch thread: it reads into a
buffer (file ``readinto``, decompression and numpy copies, which release
the interpreter lock), issues ``to(device, non_blocking=True)`` on the copy
stream and records an event. The consumer (``Window.publish``, on the main
thread) makes the compute stream wait on that event and calls
``record_stream`` so that the caching allocator does not reuse the block
while the compute stream may still read it. Before a buffer is refilled,
the stager waits for the event of the copy that last read it.

On the CPU the same code runs synchronously: the window's tensors are a
fresh host block read in place (no staging buffer, nothing to copy).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["Stager", "TimeWindow", "Window"]

_ALIGN = 256


def _device_dtype(dtype: np.dtype) -> np.dtype:
    return np.dtype(np.float32) if dtype.kind == "f" else np.dtype(dtype)


class Window:
    """The device tensors of one staged window."""

    def __init__(self, base: torch.Tensor, tensors: dict, event):
        self.base = base
        self.tensors = tensors
        self._event = event

    def publish(self) -> dict:
        """The window's tensors, safe to read on the current stream."""
        if self._event is not None:
            stream = torch.cuda.current_stream(self.base.device)
            stream.wait_event(self._event)
            self.base.record_stream(stream)
            self._event = None
        return self.tensors


class _Slot:
    def __init__(self):
        self.lock = threading.Lock()
        self.buf = None
        self.event = None


class Stager:
    """Reads window parts into staging memory and ships them to ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._slots = [_Slot(), _Slot()]
        self._turn = 0
        self._lock = threading.Lock()
        self._stream = None

    def stage(self, parts: list) -> Window:
        """Stage ``parts``, a list of ``(key, shape, dtype, fill)`` where
        ``fill(out)`` writes the part into the numpy array ``out`` of that
        shape and dtype; returns the window with one tensor per key."""
        layout, total = [], 0
        for key, shape, dtype, fill in parts:
            dtype = _device_dtype(np.dtype(dtype))
            nbytes = int(np.prod(shape)) * dtype.itemsize
            layout.append((key, tuple(shape), dtype, fill, total, nbytes))
            total += -(-nbytes // _ALIGN) * _ALIGN
        if not self._cuda:
            host = torch.empty(total, dtype=torch.uint8, device=self.device)
            self._fill(host, layout)
            return Window(host, self._views(host, layout), None)
        with self._lock:
            slot = self._slots[self._turn]
            self._turn ^= 1
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
        with slot.lock:
            if slot.event is not None:
                slot.event.synchronize()  # the copy that last read this buffer
            if slot.buf is None or slot.buf.numel() < total:
                slot.buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            host = slot.buf[:total]
            self._fill(host, layout)
            with torch.cuda.stream(self._stream):
                base = host.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            slot.event = event
        return Window(base, self._views(base, layout), event)

    @staticmethod
    def _fill(host: torch.Tensor, layout) -> None:
        raw = host.numpy()
        for _, shape, dtype, fill, off, nbytes in layout:
            fill(raw[off:off + nbytes].view(dtype).reshape(shape))

    @staticmethod
    def _views(base: torch.Tensor, layout) -> dict:
        out = {}
        for key, shape, dtype, _, off, nbytes in layout:
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
            out[key] = base[off:off + nbytes].view(tdtype).view(shape)
        return out


class TimeWindow:
    """The rolling time window of one fieldset, ``nlevels`` levels long.

    Holds one window in use (``take``) and the windows the prefetch thread
    is staging (``prefetch``); a window is built by the fieldset's
    ``build(offsets)``, which calls ``stage``. Taking a new window drops the
    one in use before the new one lands, so the execute loop holds at most
    two windows: the one its chunk reads and the successor on its way.
    """

    def __init__(self, device: torch.device, nlevels: int):
        self.nlevels = nlevels
        self.stats = {"loads": 0, "bytes_read": 0}
        self.futures = {}  # offsets -> Future of a staged Window
        self.current = None  # (offsets, farrays) of the window in use
        self.static = None  # (uxcol mode, the resident tensors and tables)
        self._stager = Stager(device)
        self._lock = threading.Lock()  # stats, counted on the prefetch thread
        self._pool = None

    def stage(self, parts: list, loads: int, nbytes: int) -> Window:
        """``Stager.stage(parts)``, counting ``loads`` fields of ``nbytes``."""
        window = self._stager.stage(parts)
        with self._lock:
            self.stats["loads"] += loads
            self.stats["bytes_read"] += nbytes
        return window

    def prefetch(self, key: tuple, build) -> None:
        """Run ``build(key)`` on the prefetch thread, unless window ``key`` is
        in use or on its way."""
        if (self.current is not None and self.current[0] == key) or key in self.futures:
            return
        # bound mispredicted windows: drop finished futures nobody consumed
        if len(self.futures) >= 2:
            for k in [k for k, f in self.futures.items() if f.done()]:
                self.futures.pop(k)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="parcels-window")
        self.futures[key] = self._pool.submit(build, key)

    def take(self, key: tuple, build, publish) -> dict:
        """The farrays of window ``key``, made the one in use: its prefetched
        window (an exception on the thread is raised here), else
        ``build(key)`` now; ``publish(window)`` makes its farrays."""
        if self.current is None or self.current[0] != key:
            self.current = None
            fut = self.futures.pop(key, None)
            window = fut.result() if fut is not None else build(key)
            self.current = (key, publish(window))
        return self.current[1]

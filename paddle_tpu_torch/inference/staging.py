"""Host-to-device uploads that never wait for the device.

``torch.from_numpy(a).to(device)`` copies from pageable memory and then
waits for the stream: every upload would wait for the step in flight, and
a dispatch-ahead engine would run no further ahead than a synchronous one.
A :class:`DeviceBuffer` is a persistent device tensor (its address never
changes, so a captured CUDA graph can read it) refreshed in place from a
ring of pinned host slots with ``non_blocking=True`` copies, ordered on the
current stream behind whatever was dispatched before. Each slot carries a
CUDA event recorded after its copy: the host waits on it only before it
rewrites that slot, so it never overwrites bytes a queued copy has not read
yet. The slots are taken round robin whatever became of the step a copy
fed: a step the serving engine drops after a failure holds none. On the
CPU the buffer is a plain tensor and ``put`` copies at once.
"""
from __future__ import annotations

import numpy as np
import torch

STAGING_SLOTS_DEFAULT = 5     # the engine's default ring depth (4) + 1


class DeviceBuffer:
    """A device tensor of ``shape`` / ``dtype`` (a torch dtype) refreshed
    by :meth:`put` through ``slots`` pinned host buffers."""

    def __init__(self, shape, dtype, device, slots=STAGING_SLOTS_DEFAULT):
        self.device = torch.device(device)
        self.tensor = torch.zeros(shape, dtype=dtype, device=self.device)
        self._cuda = self.device.type == "cuda"
        n = max(1, int(slots)) if self._cuda else 0
        self._host = [torch.empty(shape, dtype=dtype, pin_memory=True)
                      for _ in range(n)]
        self._host_np = [h.numpy() for h in self._host]
        self._events = [None] * n
        self._next = 0

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """Refresh the device tensor with ``arr`` (same shape, a numpy
        dtype of the same kind) and return it. On a CUDA device the copy is
        queued on the current stream and this returns without waiting for
        it, unless the slot it takes still feeds a queued copy."""
        if not self._cuda:
            self.tensor.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            return self.tensor
        i = self._next
        self._next = (i + 1) % len(self._host)
        ev = self._events[i]
        if ev is None:
            ev = self._events[i] = torch.cuda.Event()
        else:
            ev.synchronize()
        self._host_np[i][...] = arr
        self.tensor.copy_(self._host[i], non_blocking=True)
        ev.record()
        return self.tensor


class Feed:
    """A step's small inputs, laid out in one int32 host array and one
    persistent device buffer (each segment 16-byte aligned; fp32 segments
    are views of the same bytes): ``host[name]`` / ``dev[name]``.
    :meth:`upload` refreshes the device buffer through pinned staging;
    ``cached`` skips the copy when the host bytes equal the last ones
    sent."""

    def __init__(self, segments, device, slots, cached=False):
        offsets, n = {}, 0
        for name, size, _ in segments:
            offsets[name] = n
            n += -(-size // 4) * 4
        self.array = np.zeros((max(n, 4),), np.int32)
        self.buffer = DeviceBuffer(self.array.shape, torch.int32, device,
                                   slots)
        self.host, self.dev = {}, {}
        for name, size, kind in segments:
            lo = offsets[name]
            h, d = self.array[lo:lo + size], self.buffer.tensor[lo:lo + size]
            if kind == "f32":
                h, d = h.view(np.float32), d.view(torch.float32)
            self.host[name], self.dev[name] = h, d
        self._sent = np.full_like(self.array, -1) if cached else None

    def upload(self) -> None:
        if self._sent is not None and np.array_equal(self._sent,
                                                     self.array):
            return
        self.buffer.put(self.array)
        # recorded only once the copy is queued: an upload that raised
        # must not leave the next round skipping its bytes
        if self._sent is not None:
            self._sent[...] = self.array


__all__ = ["DeviceBuffer", "Feed", "STAGING_SLOTS_DEFAULT"]

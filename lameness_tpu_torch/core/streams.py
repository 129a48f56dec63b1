"""Overlapped transfers on the card: copies to the device on one side
stream, copies back on another, the compute on the current stream.

The JAX package overlaps batch N+1's transfer and batch N's readback with
compute through XLA's asynchronous dispatch (``serve/driver.py``
``process_stream``, ``video/curation.py`` ``detect_stream``).  On CUDA a
copy issued on the compute stream waits for every kernel queued before it,
and a blocking readback waits for every kernel queued after it too, so the
port issues them on side streams:
- ``put`` runs the host-to-device work on the copy-in stream; the compute
  stream waits for it, and each device tensor it made is recorded on the
  compute stream (the caching allocator must not reuse its memory while a
  kernel still reads it);
- ``fetch`` queues copies of device tensors into pinned host memory on the
  copy-out stream, after the compute queued so far and not after anything
  queued later, and returns a function that waits for those copies alone.
On the CPU both run in place.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host uint8 array (any strides) on ``device``: through pinned
    memory and an asynchronous copy on the current stream on the card, as
    it is on the CPU."""
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(array))
    host = torch.empty(array.shape, dtype=torch.uint8, pin_memory=True)
    np.copyto(host.numpy(), array)
    return host.to(device, non_blocking=True)


class Overlap:
    """The side streams of one device (none on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy_in = torch.cuda.Stream(device)
            self.copy_out = torch.cuda.Stream(device)

    def put(self, fn: Callable):
        """``fn()`` (host-to-device work giving a tensor or a dict of them)
        on the copy-in stream; returns its result, ready for the compute
        stream."""
        if not self.cuda:
            return fn()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_in):
            out = fn()
        compute.wait_stream(self.copy_in)
        for t in out.values() if isinstance(out, dict) else [out]:
            t.record_stream(compute)
        return out

    def fetch(self, tensors: Sequence[torch.Tensor]
              ) -> Callable[[], List[np.ndarray]]:
        """Queue the copies of ``tensors`` to the host; the returned
        function waits for them and gives the numpy arrays."""
        if not self.cuda:
            return lambda: [t.numpy() for t in tensors]
        self.copy_out.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.copy_out):
            hosts = []
            for t in tensors:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t.record_stream(self.copy_out)
                hosts.append(host)
            done = torch.cuda.Event()
            done.record(self.copy_out)

        def wait():
            done.synchronize()
            return [h.numpy() for h in hosts]
        return wait

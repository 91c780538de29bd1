"""The prefetching host feed of one device: the JAX package's
``parallel/mesh.py::prefetch_to_device`` for a single torch device.

:func:`prefetch_to_device` keeps ``size`` batches in flight ahead of the
consumer.  On a CUDA device each array of a batch is copied into a pinned
host buffer and moved to the device with ``non_blocking=True`` on a side
stream, so that the upload of batch i + 1 overlaps the step on batch i.
What keeps that safe:

- the step's stream waits on the event recorded after a batch's copies
  before the batch is handed out, and the side stream waits once on the
  step's stream before the first copy (nothing queued before the feed
  started, such as the model's initialisation, is overtaken);
- each device tensor is marked used by the step's stream
  (``record_stream``), so that the caching allocator does not give its
  memory to a later copy on the side stream while the step still reads it;
- the pinned buffers form a ring of ``size + 1`` slots per array name and
  shape, and a slot is refilled only after the copy that last read it has
  finished (its event is waited on from the host, and by then it has long
  completed).

The batches come out in the iterator's order, bit for bit the arrays the
synchronous copy gives (``torch.from_numpy(x).to(device)``).  On a CPU
device the feed passes the batches through as they are: there is no copy
to overlap, and the CPU is where the caller asked to run.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


class _PinnedRing:
    """Pinned host buffers, ``slots`` per (name, shape, dtype), each with the
    event of the last copy that read it."""

    def __init__(self, slots: int):
        self.slots = slots
        self._rings: Dict[tuple, deque] = {}

    def take(self, key, shape, dtype) -> "list":
        ring = self._rings.setdefault(key, deque())
        if len(ring) < self.slots:
            entry = [torch.empty(shape, dtype=dtype, pin_memory=True), None]
        else:
            entry = ring.popleft()
            if entry[1] is not None:
                entry[1].synchronize()  # its last copy has left the buffer
        ring.append(entry)
        return entry


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]],
                       device, size: int = 2) -> Iterator[Dict]:
    """Yield the batches of ``iterator`` (dicts of arrays) as dicts of
    tensors on ``device``, ``size`` of them uploaded ahead; see the module's
    docstring."""
    if size < 1:
        raise ValueError("size must be >= 1, got %d" % size)
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    ring = _PinnedRing(size + 1)
    pending: deque = deque()

    def upload(batch):
        out, entries = {}, []
        with torch.cuda.stream(side):
            for k, v in batch.items():
                v = np.ascontiguousarray(v)
                src = torch.from_numpy(v)
                entry = ring.take((k, src.shape, src.dtype), src.shape,
                                  src.dtype)
                entry[0].copy_(src)
                out[k] = entry[0].to(device, non_blocking=True)
                entries.append(entry)
            done = torch.cuda.Event()
            done.record(side)
        for entry in entries:
            entry[1] = done
        return out, done

    def hand_out():
        out, done = pending.popleft()
        main.wait_event(done)
        for t in out.values():
            t.record_stream(main)
        return out

    for batch in iterator:
        pending.append(upload(batch))
        if len(pending) > size - 1:
            yield hand_out()
    while pending:
        yield hand_out()

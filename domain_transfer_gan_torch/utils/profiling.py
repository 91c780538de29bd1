"""Step timing without a device sync per step.

:class:`StepTimer` counts items and steps and closes a window on request:
the one synchronisation of a window is ``torch.cuda.synchronize()`` (or one
host read of ``sync_tensor``), so the device work enqueued in the window is
counted honestly while no step waits on the device.
"""

from __future__ import annotations

import time

import torch


class StepTimer:
    """Windowed items/s and time per item.

    ``tick(n)`` per step; ``window(sync_tensor)`` waits for the device once,
    then returns and resets ``(seconds_per_item, items_per_sec, seconds,
    steps)`` of the window."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._items = 0
        self._steps = 0

    def tick(self, n_items: int):
        self._items += n_items
        self._steps += 1

    def window(self, sync_tensor=None):
        if isinstance(sync_tensor, torch.Tensor):
            if sync_tensor.is_cuda:
                torch.cuda.synchronize(sync_tensor.device)
            else:
                sync_tensor.reshape(-1)[0].item()
        dt = time.perf_counter() - self._t0
        sec_per_item = dt / max(self._items, 1)
        items_per_sec = self._items / dt if dt > 0 else float("inf")
        out = (sec_per_item, items_per_sec, dt, self._steps)
        self.reset()
        return out

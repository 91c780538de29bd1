"""Checkpoint writes, synchronous or from a background thread.

:class:`AsyncCheckpointer` writes checkpoints from one long-lived background
thread in submission order, each to a temp file published with
``os.replace``, so a crash mid-write never corrupts an existing ``latest`` /
``best_*``.  ``save`` copies the payload's tensors to the CPU on the
caller's thread first (the one device sync of a save), so the train loop
may go on updating its tensors in place while the thread writes.  A failed
background write is re-raised at the next ``save`` or ``wait``.

The payload is written with ``torch.save`` and holds tensors, numbers,
strings and containers only, so it reads back with
``torch.load(weights_only=True)``.  :class:`OrbaxCheckpointer` writes the
JAX package's payload as an orbax checkpoint directory instead
(``utils/orbax_dir.py``), through the same thread when asked to.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from .orbax_dir import write_orbax


def to_cpu(payload):
    """The payload with every tensor copied to the CPU and every numpy
    array copied (a clone, even of a CPU tensor, so later in-place updates
    do not reach the snapshot)."""
    if isinstance(payload, torch.Tensor):
        return payload.detach().to("cpu", copy=True)
    if isinstance(payload, np.ndarray):
        return payload.copy()
    if isinstance(payload, dict):
        return {k: to_cpu(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(to_cpu(v) for v in payload)
    return payload


def write_checkpoint(path: str, host_payload) -> None:
    """``torch.save`` to ``path + '.tmp'``, then an atomic rename."""
    tmp = path + ".tmp"
    try:
        torch.save(host_payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def read_checkpoint(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


class AsyncCheckpointer:
    """One writer thread; ``save`` snapshots and enqueues, ``wait`` blocks
    until every pending write is durable and re-raises a failed one.
    ``write(path, host_payload)`` writes one checkpoint; saves run in
    submission order, so two saves to one path never overlap."""

    def __init__(self, write=write_checkpoint):
        self._write = write
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _writer(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except BaseException as e:  # handed to save() / wait()
                with self._error_lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._queue.task_done()

    def _raise_pending_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, path: str, payload) -> None:
        self._raise_pending_error()
        host_payload = to_cpu(payload)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()
        self._queue.put((path, host_payload))

    def wait(self) -> None:
        self._queue.join()
        self._raise_pending_error()

    def close(self) -> None:
        """Drain, stop the writer thread and re-raise a failed write."""
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join()
        self._thread = None
        self._raise_pending_error()


class OrbaxCheckpointer:
    """The JAX package's ``OrbaxCheckpointer`` in the port: ``save`` writes
    a payload of numpy arrays as an orbax directory (``write_orbax``), at
    once or, with ``async_save``, from an :class:`AsyncCheckpointer`'s
    thread after a copy on the caller's; ``wait`` blocks until every
    asynchronous save is published and re-raises a failed one."""

    def __init__(self):
        self._async = AsyncCheckpointer(write=write_orbax)

    def save(self, path: str, payload, async_save: bool = False) -> None:
        if async_save:
            self._async.save(path, payload)
        else:
            write_orbax(path, payload)

    def wait(self) -> None:
        self._async.wait()


"""Asynchronous host-to-device input pipeline (the reference's Grain role).

The reference wires an out-of-process-capable Grain dataset for training
input (training/era5_dataset.py:797-842). Here the same role is a
background thread that pulls batches from a host iterator (file reads +
window packing, which grow with the grid), applies the host-to-device
transfer (`jax.device_put` is an async enqueue), and keeps up to
`buffer_size` batches in flight. The training step then consumes
device-resident arrays and never waits on host packing, which otherwise
serializes with compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional


class DevicePrefetcher:
  """Wraps a host batch iterator with background packing + device_put.

  Args:
    iterator: yields host batches (e.g. sources.batch_iterator dicts).
    transform: applied to each batch on the background thread — typically
      the host->device put (jnp.asarray / jax.device_put with a
      sharding). Identity if None.
    buffer_size: max batches in flight (2 = classic double buffering).

  Iteration order is preserved; exceptions raised by the source or the
  transform surface on the consumer thread at the corresponding step.
  Use as an iterator or a context manager; `close()` stops the thread
  promptly even mid-buffer.
  """

  _DONE = object()

  def __init__(self, iterator: Iterator[Any],
               transform: Optional[Callable[[Any], Any]] = None,
               buffer_size: int = 2):
    if buffer_size < 1:
      raise ValueError(f'buffer_size must be >= 1, got {buffer_size}')
    self._it = iterator
    self._transform = transform or (lambda x: x)
    self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
    self._stop = threading.Event()
    self._done = False
    self._thread = threading.Thread(target=self._worker, daemon=True,
                                    name='gencast-prefetch')
    self._thread.start()

  def _put(self, item) -> bool:
    """Stop-aware blocking put. Returns False if close() raced us."""
    while not self._stop.is_set():
      try:
        self._q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _worker(self):
    try:
      for batch in self._it:
        if not self._put((self._transform(batch), None)):
          return
      self._put((self._DONE, None))
    except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
      # Must not drop the error even if the consumer is mid-step for
      # minutes (1-deg compiles): keep trying until it
      # lands or close() is called, else the consumer would block
      # forever on an empty queue with a dead worker.
      self._put((None, e))

  def __iter__(self):
    return self

  def __next__(self):
    if self._stop.is_set() or self._done:
      raise StopIteration
    item, err = self._q.get()
    if err is not None:
      self.close()
      raise err
    if item is self._DONE:
      self._done = True
      raise StopIteration
    return item

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  def close(self):
    self._stop.set()
    # Drain so a blocked producer put() can observe the stop event.
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass
    self._thread.join(timeout=5.0)

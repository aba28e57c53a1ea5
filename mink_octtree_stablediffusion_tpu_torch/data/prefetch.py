"""Double-buffered host → device input pipeline.

Port of `mink_octtree_stablediffusion_tpu/data/prefetch.py`.  A worker
thread iterates the (numpy) batch source and keeps the next ``prefetch``
batches already submitted to the device, so that the copy of batch N+1
overlaps the compute of batch N.  On a CUDA device the worker pins each
batch's host arrays and copies them with ``non_blocking=True`` on a side
stream of its own; the consumer's stream waits on that copy's event
before it uses the batch, and ``record_stream`` tells the caching
allocator that the consumer's stream uses the memory, so that it is not
handed out again while the consumer may still read it.  ``device`` takes
the place of the JAX package's ``sharding``: a data-parallel rank passes
its own device.  On the CPU the batches are converted to tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

_DONE = object()


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, t) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class PrefetchLoader:
    """Iterate a source of numpy pytrees (tuples, lists, dicts of arrays)
    as device-resident batches of tensors.

    Args:
      source: iterable yielding one batch each, e.g. ``(collate_pointclouds
        (...)[:3] for samples in batch_iterator(ds, b, rng))``.
      prefetch: batches kept in flight beyond the one being consumed.
      device: the device every leaf goes to (default: the current CUDA
        device where there is one, else the CPU).

    Errors in the source re-raise at the consuming ``next()``.  Iteration
    is single-epoch.  ``close()`` (or leaving a ``with`` block) stops the
    worker, also when it is blocked on a full queue.
    """

    def __init__(self, source: Iterable[Any], prefetch: int = 2,
                 device=None):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None

        def put_leaf(a):
            t = torch.as_tensor(np.asarray(a))
            if not cuda:
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

        def worker():
            try:
                for batch in source:
                    if self._stop.is_set():
                        return
                    if cuda:
                        with torch.cuda.stream(self._stream):
                            out = _map(put_leaf, batch)
                            event = torch.cuda.Event()
                            event.record(self._stream)
                    else:
                        out, event = _map(put_leaf, batch), None
                    self._put((out, event))
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            finally:
                self._put(_DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        """Block on a full queue until there is room or ``close()``."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)

            def keep(t):
                t.record_stream(consumer)
                return t
            batch = _map(keep, batch)
        return batch

    def close(self):
        """Stop the worker and drop the batches in flight."""
        self._stop.set()
        self._thread.join(timeout=10)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

"""Background-prefetching loader, the counterpart of
``iswm_tpu/data/loader.py``.

Host work is only decoding and batch assembly (augmentation runs on the
device), so one prefetch thread with a bounded queue hides it behind the
device's work.  ``device_prefetch_iterator`` also copies each batch to the
device in that thread: through pinned host buffers, with ``non_blocking``
copies on a side stream, so that the copy overlaps the step in flight.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class PrefetchLoader:
    """Wrap a batch iterator with an N-deep background prefetch queue.

    ``place`` (optional) is applied to each (images, labels) pair in the
    producer thread, before the pair enters the queue.  An exception in
    the producer is raised in the consumer; closing the consumer's
    generator stops the producer."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2, place=None):
        self._it = iterator
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            for item in self._it:
                if self._place is not None:
                    item = self._place(*item)
                if not self._put(item):
                    return
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self._stop.set()


def device_prefetch_iterator(
    batch_iter: Iterator[Tuple[np.ndarray, np.ndarray]],
    device="cpu",
    depth: int = 2,
):
    """Prefetch numpy batches and place them on ``device`` as tensors.

    For a CUDA device the copy runs in the prefetch thread on a side
    stream, from pinned memory with ``non_blocking=True``; each batch
    carries an event that the consumer's stream waits on before use."""
    device = torch.device(device)
    if device.type != "cuda":
        def place(images, labels):
            return torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)

        return iter(PrefetchLoader(batch_iter, depth=depth, place=place))

    stream = torch.cuda.Stream(device)

    def place_cuda(images, labels):
        with torch.cuda.stream(stream):
            out = tuple(torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
                        for a in (images, labels))
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def consume():
        source = iter(PrefetchLoader(batch_iter, depth=depth, place=place_cuda))
        try:
            for (images, labels), done in source:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                images.record_stream(current)
                labels.record_stream(current)
                yield images, labels
        finally:
            source.close()

    return consume()

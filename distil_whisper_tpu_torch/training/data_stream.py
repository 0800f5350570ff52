"""Streaming input pipeline: lazy per-sample preparation, a shuffle buffer
and a background prefetch thread.

The port's own copy of ``distil_whisper_tpu.training.data_stream`` (numpy
and threads only): an iterator of raw rows -> on-the-fly label and feature
preparation -> a reservoir shuffle buffer -> a producer thread that keeps N
batches ready while the device runs the step.  The same
``np.random.default_rng(seed)`` draws give the same order as the JAX
package.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


class ShuffleBuffer:
    """Reservoir-style streaming shuffle (HF ``shuffle(buffer_size=...)``)."""

    def __init__(self, iterable: Iterable, buffer_size: int,
                 rng: Optional[np.random.Generator] = None):
        self.iterable = iterable
        self.buffer_size = buffer_size
        self.rng = rng or np.random.default_rng(0)

    def __iter__(self) -> Iterator:
        buf: List[Any] = []
        for item in self.iterable:
            if len(buf) < self.buffer_size:
                buf.append(item)
                continue
            idx = int(self.rng.integers(0, len(buf)))
            out, buf[idx] = buf[idx], item
            yield out
        self.rng.shuffle(buf)
        yield from buf


class Prefetcher:
    """Producer-thread batch prefetch: keeps up to ``depth`` ready batches so
    host preparation overlaps device work.  An exception in the producer is
    raised in the consumer."""

    _DONE = object()

    def __init__(self, make_batches: Callable[[], Iterator], depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None

        def run():
            try:
                for batch in make_batches():
                    self.q.put(batch)
            except BaseException as e:  # noqa: BLE001 - raised on consume
                self.error = e
            finally:
                self.q.put(self._DONE)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item


def streaming_batches(rows: Iterable[Dict[str, Any]],
                      prepare: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]],
                      collate: Callable[[List[Dict[str, Any]]], Any],
                      batch_size: int,
                      shuffle_buffer_size: int = 0,
                      seed: int = 0,
                      repeat: bool = False,
                      prefetch_depth: int = 2) -> Iterator:
    """rows -> prepare (None = filtered) -> shuffle buffer -> batches,
    produced by a background thread.  With ``repeat`` every pass over the
    rows reshuffles from the same seed and only full batches are emitted;
    without it the last batch may be partial."""

    def sample_iter():
        while True:
            src: Iterable = rows
            if shuffle_buffer_size:
                src = ShuffleBuffer(src, shuffle_buffer_size,
                                    np.random.default_rng(seed))
            for row in src:
                s = prepare(row)
                if s is not None:
                    yield s
            if not repeat:
                return

    def batch_iter():
        buf: List[Dict[str, Any]] = []
        for s in sample_iter():
            buf.append(s)
            if len(buf) == batch_size:
                yield collate(buf)
                buf = []
        if buf and not repeat:
            yield collate(buf)

    return iter(Prefetcher(batch_iter, depth=prefetch_depth))

"""Background-thread prefetching for host-side data iterators
(counterpart of star_tpu/data/prefetch.py).

The port's form of the reference's `DataLoader(num_workers=N)` overlap
(train_sr.py builds its loader with worker processes; SAT's data_video
iterators likewise): while the device runs a training step, the host thread
decodes/augments the next batch. cv2 video decode releases the GIL, so one
producer thread buys real overlap even on a single-core host; process
fan-out is unnecessary because the decode is already native code.

Exceptions raised by the producer are re-raised at the consumer's next
`next()`, and `close()` (or garbage collection) stops the thread promptly
even when the queue is full.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_SENTINEL = object()


class PrefetchIterator:
    """Iterate `src` on a background thread, `depth` items ahead."""

    def __init__(self, src: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iter(src),),
                                        daemon=True)
        self._thread.start()

    def _run(self, it: Iterator):
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            # the single sentinel was already consumed; keep honoring the
            # iterator protocol instead of blocking on the empty queue
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()

    def __del__(self):  # pragma: no cover
        self.close()


def prefetched(factory: Callable[[], Iterable], depth: int = 2):
    """Callable-of-iterable version for epoch-cycling loops: each call
    returns a fresh PrefetchIterator over `factory()` (matches the
    `reset` contract in cli/train_sr.collect_samples)."""
    return lambda: PrefetchIterator(factory(), depth=depth)

"""Background-thread feature prefetch for the trainer (port of
``seedvc_tpu/train/prefetch.py``).

``prefetched`` runs the preparation callable in a daemon worker thread,
``depth`` batches ahead of the consumer, over a bounded queue: the worker's
host work (padding, resampling, the numpy RNG) and its device launches
(Whisper, CAMPPlus, RMVPE) overlap the train step. An exception in the worker
is raised in the consumer; abandoning the generator (early stop,
``max_steps``) stops the worker. ``depth <= 0`` is the synchronous schedule,
with no thread. ``waits``, when given, gets the consumer's wait for each
item in seconds: on the queue, or for the preparation itself when
synchronous.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def prefetched(iterable: Iterable[T], prepare: Callable[[T], U],
               depth: int = 2, waits: Optional[list] = None) -> Iterator[U]:
    """Yield ``prepare(item)`` for each item, computed ``depth`` ahead;
    append each item's wait in seconds to ``waits`` when given."""
    if depth <= 0:
        t = time.perf_counter()
        for item in iterable:
            prepared = prepare(item)
            if waits is not None:
                waits.append(time.perf_counter() - t)
            yield prepared
            t = time.perf_counter()
        return

    q: "queue.Queue[object]" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    failure: list[BaseException] = []

    def _put(item: object) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                if not _put(prepare(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            failure.append(e)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=worker, name="feature-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            t = time.perf_counter()
            item = q.get()
            if item is _SENTINEL:
                if failure:
                    raise failure[0]
                return
            if waits is not None:
                waits.append(time.perf_counter() - t)
            yield item
    finally:
        stop.set()
        thread.join(timeout=10.0)

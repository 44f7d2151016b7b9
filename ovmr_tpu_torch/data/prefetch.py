"""Background batch prefetch — overlaps host decode with device compute.

The port's copy of ``ovmr_tpu/data/prefetch.py``.

The reference gets this from torch DataLoader's worker processes (batches
are produced ahead of consumption); `HostDataLoader` parallelizes decode
*within* a batch but produces batches synchronously, so without this
wrapper the host decodes batch N+1 only after the device finishes step N
(the trainer fetches the loss scalar every step). `prefetch_batches` runs
the underlying iterator in a producer thread with a bounded queue: decode
of the next batch(es) proceeds while the accelerator crunches the current
one, making step time max(device, host) instead of device + host.
SURVEY §7 hard part #6 ("overlapping JPEG decode with device compute").

Order-preserving (single producer), exception-propagating, and daemonic
(an abandoned iterator never wedges interpreter shutdown).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch_batches(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate `iterable` in a background thread, keeping up to `depth`
    items decoded ahead. `depth=0` disables (plain iteration)."""
    if depth <= 0:
        yield from iterable
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_final(obj):
        # the terminal item (sentinel or exception) must reach the consumer
        # even if the queue stays full for minutes (cold compiles): retry
        # until delivered or the consumer abandoned us (stop set)
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.5)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            put_final(_SENTINEL)
        except BaseException as e:  # propagate into the consumer
            put_final(e)

    t = threading.Thread(target=producer, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()

"""Background batch prefetching (own copy of
``wav2vec_s_tpu/data/prefetch.py``).

Twin of fairseq's DataLoader ``num_workers`` pipeline (iterators.py
``BufferedIterator`` + torch DataLoader workers): host-side collation
(audio decode, log-mel extraction, tokenization, padding) runs in a
producer thread with a bounded queue, overlapping the next batches' IO
with the device step.  numpy/file IO release the GIL, so a thread (not a
process pool) captures most of the win without pickling batches.

Resume semantics match the reference's multi-worker loader: the producer
runs up to ``depth`` batches ahead of the consumer, so an iterator-state
checkpoint taken mid-epoch may replay up to ``depth`` batches after a
crash (exact-resume boundaries are epoch starts and clean shutdowns).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Tuple

_STOP = object()


def prefetch_batches(indices: Iterable, collate: Callable, depth: int = 2
                     ) -> Iterator[Tuple[object, object]]:
    """Yield ``(batch_indices, collate(batch_indices))`` with the collation
    of up to ``depth`` upcoming batches running in a background thread.

    ``depth <= 0`` disables prefetching (pure pass-through, no thread).
    Exceptions in the producer re-raise at the consuming site.
    """
    if depth <= 0:
        for idx in indices:
            yield idx, collate(idx)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)

    def produce():
        try:
            for idx in indices:
                q.put((idx, collate(idx), None))
        except BaseException as e:          # noqa: BLE001 — re-raised below
            q.put((None, None, e))
            return
        q.put(_STOP)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                break
            idx, batch, err = item
            if err is not None:
                raise err
            yield idx, batch
    finally:
        # unblock the producer if the consumer stops early
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                break

"""Batched data loader with threaded fetch and prefetch (counterpart of
``duodiff_tpu/data/loader.py``, numpy batch assembly only).

Items are fetched with a thread pool and assembled into contiguous NHWC
float32 batches, scaled by the dataset's ``scale`` and ``offset``; a
background producer keeps a bounded queue of ready batches. Batches are
always full: the sampler is an infinite index stream. With ``rows = (lo,
hi, batch_size)`` (a data-parallel rank) the sampler still advances by the
whole global batch, as on every rank, and only rows lo:hi of it are fetched.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from duodiff_tpu_torch.data.sampler import ResumableSeedableSampler


NUM_WORKERS = 4  # fetch threads
PREFETCH = 2     # ready batches queued ahead of the training loop


class DataLoader:
    def __init__(self, dataset, batch_size: int, sampler: ResumableSeedableSampler,
                 rows: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.rows = rows
        self._pool: Optional[ThreadPoolExecutor] = None
        self._consumed_state: Optional[dict] = None

    def _fetch_batch(self, indices: np.ndarray) -> dict:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=NUM_WORKERS)
        items = list(self._pool.map(self.dataset.__getitem__, indices))
        labels = np.asarray([it[1] for it in items], dtype=np.int32)
        images = np.stack([it[0] for it in items])
        out = np.empty(images.shape, np.float32)
        # in float32, as the JAX package's native batch assembler computes it
        np.multiply(images, np.float32(self.dataset.scale), out=out, casting="unsafe")
        out += np.float32(self.dataset.offset)
        return {"image": out, "label": labels}

    def next_batch(self) -> dict:
        """Synchronously fetch the next batch (advances the sampler state)."""
        indices = self.sampler.next_indices(self.batch_size)
        if self.rows is not None:
            indices = indices[self.rows[0]:self.rows[1]]
        return self._fetch_batch(indices)

    def prefetching_iterator(self) -> Iterator[dict]:
        """Background-producer iterator. Checkpoint-exact: each queued batch
        carries the sampler state after it was drawn, and :meth:`get_state`
        reports the state of the last batch consumed, so a resume replays
        exactly the batches the loop never saw. Closing the generator stops
        and joins the producer."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            while not stop.is_set():
                batch = self.next_batch()
                state = self.sampler.get_state()
                while not stop.is_set():
                    try:
                        q.put((batch, state), timeout=0.5)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, daemon=True, name="duodiff-loader-producer")
        thread.start()
        try:
            while True:
                batch, state = q.get()
                self._consumed_state = state
                yield batch
        finally:
            stop.set()
            thread.join(timeout=5.0)

    def get_state(self) -> dict:
        consumed = self._consumed_state
        return consumed if consumed is not None else self.sampler.get_state()

    def set_state(self, state: dict) -> None:
        self.sampler.set_state(state)
        self._consumed_state = None

    def close(self) -> None:
        """Release the fetch thread pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

"""Batched data loader with threaded fetch and prefetch (counterpart of
``duodiff_tpu/data/loader.py``).

Items are fetched with a thread pool and assembled into contiguous NHWC
float32 batches, scaled by the dataset's ``scale`` and ``offset``: uint8
items by the native assembler (``data/_native``) or, where it cannot be
built, by :func:`assemble_numpy`, both ``u8 * scale + offset`` rounded once
to float32, the bits of the JAX package's native assembler on a host with
FMA; float32 items by the JAX package's float path. A background producer
keeps a bounded queue of ready batches. Batches are
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

from duodiff_tpu_torch.data._native import get_assembler
from duodiff_tpu_torch.data.sampler import ResumableSeedableSampler


NUM_WORKERS = 4  # fetch threads
PREFETCH = 2     # ready batches queued ahead of the training loop


def assemble_numpy(images, scale: float, offset: float) -> np.ndarray:
    """The native assembler's bits without it: ``u8 * f32(scale) +
    f32(offset)`` for uint8 images, computed in float64 and rounded once to
    float32. The float64 value is exact for the loader's pairs (2/255 and
    -1, 1/255 and 0): a uint8 times a float32 needs 32 significant bits, and
    the sum with the offset stays within 53."""
    out = np.stack(images).astype(np.float64)
    out *= np.float64(np.float32(scale))
    out += np.float64(np.float32(offset))
    return out.astype(np.float32)


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
        images = [np.ascontiguousarray(it[0]) for it in items]
        scale, offset = float(self.dataset.scale), float(self.dataset.offset)
        if images[0].dtype == np.uint8:
            assembler = get_assembler()
            if assembler is None:
                return {"image": assemble_numpy(images, scale, offset), "label": labels}
            out = np.empty((len(images),) + images[0].shape, np.float32)
            assembler(images, scale, offset, out, n_threads=NUM_WORKERS)
            return {"image": out, "label": labels}
        if images[0].dtype != np.float32:
            raise ValueError(f"dataset items must be uint8 or float32, got {images[0].dtype}")
        # the JAX package's float path: stacked, scaled, then offset, in float32
        out = np.stack(images)
        if scale != 1.0:
            out *= np.float32(scale)
        if offset != 0.0:
            out += np.float32(offset)
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

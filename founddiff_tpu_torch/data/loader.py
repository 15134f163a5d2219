"""Batching + prefetching loader (mirror of ``founddiff_tpu/data/loader.py``;
the reference's torch DataLoader workers, src/DADiff.py:1582-1588).

A thread-prefetched iterator that assembles NHWC numpy batches; the trainer
moves them to its device.  When the native C++ slice reader
(:mod:`founddiff_tpu_torch.data.native`) is built and the dataset exposes
``sample_paths`` / ``sample_from_arrays``, all files of a batch decode
concurrently on its thread pool, and the samples come out in the order of
the serial path.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def _stack_batch(samples):
    """Stack a list of per-sample trees (lists/tuples/arrays) into batched
    numpy arrays."""
    first = samples[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_batch([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


class Loader:
    """Iterates a map-style dataset in shuffled batches with thread prefetch.

    Args:
      dataset: object with ``__len__`` and ``__getitem__``.
      batch_size: batch size.
      shuffle: reshuffle each epoch (``np.random.RandomState(seed)``).
      drop_last: drop the trailing partial batch.
      prefetch: number of batches to keep in flight (0 disables the thread).
      seed: shuffle seed.
      decode_threads: native pool threads (0: decode serially).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 prefetch: int = 2, seed: int = 0, decode_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.decode_threads = decode_threads
        self._pool = None

    def _native_pool(self):
        """Lazy PrefetchPool, or None when unavailable/unsupported."""
        if self.decode_threads <= 0:
            return None
        if not (hasattr(self.dataset, "sample_paths")
                and hasattr(self.dataset, "sample_from_arrays")):
            return None
        if self._pool is None:
            from founddiff_tpu_torch.data import native

            if not native.available():
                return None
            self._pool = native.PrefetchPool(self.decode_threads)
        return self._pool

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _load_samples(self, chunk):
        pool = self._native_pool()
        if pool is None:
            return [self.dataset[int(i)] for i in chunk]
        per_sample_paths = [self.dataset.sample_paths(int(i)) for i in chunk]
        arrays = pool.load_many([p for ps in per_sample_paths for p in ps])
        samples, pos = [], 0
        for i, ps in zip(chunk, per_sample_paths):
            samples.append(self.dataset.sample_from_arrays(int(i), arrays[pos:pos + len(ps)]))
            pos += len(ps)
        return samples

    def _batches(self):
        idx = self._epoch_indices()
        n = len(idx)
        stop = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield _stack_batch(self._load_samples(idx[start:start + self.batch_size]))

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


def cycle(loader: Loader) -> Iterator:
    """Endless batch stream (reference ``cycle`` src/DADiff.py:75-78)."""
    while True:
        yield from loader

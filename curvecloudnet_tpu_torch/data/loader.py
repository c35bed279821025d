"""Threaded prefetching data loader (counterpart of
``curvecloudnet_tpu/data/loader.py``).

Worker threads prepare padded numpy batches (sample draw, padding,
stacking) ahead of the consumer, at most ``prefetch`` batches ahead, so
host preparation overlaps device compute.  Only the consuming thread
touches the device.  Batches come out in epoch order whatever thread
prepared them, and a worker's exception is raised in the consumer.

With more than one process (``parallel``) each process reads its
lockstep shard of the epoch, as the JAX loader does: every process
shuffles the same global order (the seed is shared), the order is
wrap-padded with repetitions to ceil(n / processes) items a process, and
each process takes its contiguous slice, so every process runs the same
number of steps.  Eval loaders pass ``shard_by_process=False``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..parallel.mesh import process_shard_range
from .datasets import CurveDataset, collate


class PrefetchLoader:
    """Iterate padded numpy batches prepared by worker threads."""

    def __init__(self, dataset: CurveDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0, augment: bool = False,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 4, shard_by_process: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.shard_by_process = shard_by_process

    def _shard_len(self) -> int:
        """Items a process reads an epoch: ceil(n / processes)."""
        if not self.shard_by_process:
            return len(self.dataset)
        return len(process_shard_range(len(self.dataset)))

    def __len__(self):
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self, epoch_seed: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(epoch_seed).shuffle(order)
        if self.shard_by_process:
            # this process's lockstep shard of the shuffled order
            order = order[np.asarray(process_shard_range(len(order)),
                                     dtype=np.int64)]
        stop = (len(order) - self.batch_size + 1 if self.drop_last
                else len(order))
        for s in range(0, max(stop, 0), self.batch_size):
            yield order[s:s + self.batch_size]

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Yield the batches of one epoch, prepared by the worker pool."""
        batches = list(self._batch_indices(self.seed + epoch))
        tasks: "queue.Queue" = queue.Queue()
        for bi, idxs in enumerate(batches):
            tasks.put((bi, idxs))
        results = {}
        ready = threading.Condition()
        # a worker takes a task only while fewer than `prefetch` batches
        # wait for the consumer
        room = threading.Semaphore(self.prefetch)
        stop = threading.Event()

        def worker(wid: int):
            rng = np.random.default_rng((self.seed + epoch) * 1000003 + wid)
            while True:
                room.acquire()
                if stop.is_set():
                    return
                try:
                    bi, idxs = tasks.get_nowait()
                except queue.Empty:
                    room.release()
                    return
                try:
                    got = collate(self.dataset, [
                        self.dataset.get(int(i), rng=rng,
                                         augment=self.augment)
                        for i in idxs])
                except BaseException as e:  # noqa: BLE001 - to the consumer
                    got = e
                with ready:
                    results[bi] = got
                    ready.notify_all()
                if isinstance(got, BaseException):
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with ready:
                    while bi not in results:
                        ready.wait()
                    got = results.pop(bi)
                room.release()
                if isinstance(got, BaseException):
                    raise got
                yield got
        finally:
            stop.set()
            for _ in threads:
                room.release()
            for t in threads:
                t.join(timeout=1.0)

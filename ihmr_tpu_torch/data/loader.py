"""Batched, process-sharded data loading with a background prefetch thread
(port of ihmr_tpu/data/loader.py).

Each process iterates its own stride of the index space (rank::world_size
after padding to a multiple of world_size, the DistributedSampler contract);
samples are collated into numpy batches by one prefetch thread that keeps
up to ``prefetch`` batches ready, as in the JAX package (no worker
processes). A dataset error raised in the thread is raised again to the
consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class BatchLoader:
    """Dataset batches for one process of a data-parallel group.

    ``shuffle`` permutes the indices with ``np.random.RandomState(seed +
    epoch)`` (``set_epoch``); ``drop_last`` drops a short final batch
    (training only: evaluation datasets are padded to divisibility)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = max(rank, 0)
        self.world_size = max(world_size, 1)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset) // self.world_size
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(order)
        pad = (-n) % self.world_size
        if pad:
            order = np.concatenate([order, order[:pad]])
        return order[self.rank:: self.world_size]

    def _batches(self) -> Iterator[np.ndarray]:
        idxs = self._indices()
        for start in range(0, len(idxs), self.batch_size):
            chunk = idxs[start: start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            for chunk in self._batches():
                yield collate([self.dataset[int(i)] for i in chunk])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def worker():
            try:
                for chunk in self._batches():
                    if stop.is_set():
                        return
                    q.put(collate([self.dataset[int(i)] for i in chunk]))
            except Exception as err:  # raised again by the consumer
                q.put(err)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()

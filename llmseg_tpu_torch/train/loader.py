"""Host-side data loading with background prefetch, the counterpart of
``llmseg_tpu.train.loader``: the same order, tiling, per-process shard,
prefetch queue, thread pool and error propagation.

Replaces torch DataLoader + DistributedSampler (reference training.py:385-387,
finetune_llmseg.py:394-403).  A thread pool assembles batches (the datasets
are numpy and CPU torch, which release the GIL for most of the work) and a
small prefetch queue overlaps host preprocessing with device steps.
Sharding: each process draws its own slice of the epoch via
(process_index, process_count), DistributedSampler's split; the port runs
one process, so they are 0 and 1 until it has DDP.

``pin_memory=True`` also copies each batch's arrays into page-locked
tensors in the producer thread, so that the consumer's copy to the card
can be asynchronous (``Trainer`` holds each pinned batch until its copy
has finished).  Off by default: the batches are then collate's numpy
arrays, as in the JAX package.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List

import numpy as np
import torch


def pin_batch(item):
    """A collated item with every numpy array of its batch dict (the item
    itself, or the first element of a tuple) as a pinned CPU tensor."""
    if isinstance(item, tuple):
        return (pin_batch(item[0]),) + item[1:]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            if isinstance(v, np.ndarray) else v for k, v in item.items()}


class BatchLoader:
    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 steps: int, *, shuffle: bool = False, seed: int = 0,
                 prefetch: int = 2, num_threads: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True, pin_memory: bool = False):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.steps = steps
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.num_threads = max(num_threads, 1)
        self.process_index = process_index
        self.process_count = process_count
        self.pin_memory = pin_memory

    def _indices(self, epoch: int) -> List[int]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(n)
        # per-process shard (DistributedSampler equivalent)
        order = order[self.process_index::self.process_count]
        need = self.steps * self.batch_size
        if len(order) < need:
            reps = -(-need // max(len(order), 1))
            order = np.tile(order, reps)
        return order[:need].tolist()

    def epoch(self, epoch: int = 0) -> Iterator:
        indices = self._indices(epoch)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # pool workers fetch samples concurrently; batch order is
            # preserved by submitting per batch, the torch
            # DataLoader(num_workers=N) equivalent
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                idxs))
                        item = self.collate_fn(samples)
                        q.put(pin_batch(item) if self.pin_memory else item)
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self):
        return self.steps

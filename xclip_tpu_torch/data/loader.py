"""Host-side training loader: threaded decode/augment with batch prefetch.

A copy of ``xclip_tpu/data/loader.py``: samples decode on a thread pool
(PIL releases the GIL in its codecs), finished batches wait in a bounded
queue, and the order is a seeded per-epoch permutation sharded round-robin
over ranks (the DistributedSampler contract), so at an equal seed, epoch and
rank it yields the same index order as the JAX loader. No worker processes
are spawned. Batches are numpy; the trainer pins them and copies them to
the card (``train/main.py``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np


def default_collate(items):
    """Stack a list of samples. Tuples -> tuple of stacked columns; numeric
    types stack to arrays, strings stay lists."""
    first = items[0]
    if isinstance(first, tuple):
        return tuple(default_collate([it[i] for it in items]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, str):
        return list(items)
    if isinstance(first, (int, np.integer)):
        return np.asarray(items, np.int32)
    if isinstance(first, (float, np.floating)):
        return np.asarray(items, np.float32)
    return np.stack([np.asarray(it) for it in items])


class DataLoader:
    """Iterable over batches of a map-style dataset; call :meth:`set_epoch`
    between epochs for a new permutation."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_threads: int = 16,
        prefetch_batches: int = 4,
        collate: Callable = default_collate,
        rank: int = 0,
        world_size: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch_batches = prefetch_batches
        self.collate = collate
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            idx = np.arange(n)
        if self.world_size > 1:
            idx = idx[self.rank :: self.world_size]
        return idx

    @property
    def num_batches(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self._indices())

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator:
        indices = self._indices()
        batches = [indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        failure = []

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    it = iter(batches)
                    # keep prefetch_batches+1 batch futures in flight
                    pending = [pool.map(self.dataset.__getitem__, b)
                               for b in (next(it, None) for _ in range(self.prefetch_batches + 1))
                               if b is not None]
                    while pending:
                        items = list(pending.pop(0))
                        b = next(it, None)
                        if b is not None:
                            pending.append(pool.map(self.dataset.__getitem__, b))
                        if stop.is_set():
                            return
                        out_q.put(self.collate(items))
            except Exception as exc:  # reported to the consumer, which raises it
                failure.append(exc)
            out_q.put(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
            if failure:
                raise failure[0]
        finally:
            stop.set()
            # drain so the producer can exit
            while worker.is_alive():
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass


def tokenizing_collate(tokenizer, context_length: Optional[int] = None) -> Callable:
    """Collate (image, caption) samples into ``{"images", "texts"}`` numpy
    arrays, the captions tokenized."""

    def collate(items):
        imgs = np.stack([np.asarray(it[0]) for it in items])
        caps = [it[1] for it in items]
        if isinstance(caps[0], str):
            texts = tokenizer(caps, context_length=context_length)
        else:
            texts = np.stack(caps)
        return {"images": imgs, "texts": texts}

    return collate

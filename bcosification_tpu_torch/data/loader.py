"""Data loading without torch.utils.data: a threaded prefetching loader of
numpy batches (a copy of ``bcosification_tpu/data/loader.py``).

PIL decode and the numpy transforms release the GIL for most of their time,
so a thread pool decodes images without the cost of worker processes, and
batches are prefetched ahead of the card. Every sample's augmentation draws
from an rng keyed by (seed, epoch, position), so an epoch's batches are the
same in every run and bit-identical to the JAX package's.
"""
from __future__ import annotations

import concurrent.futures as cf
import itertools
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["default_collate", "DataLoader"]


def default_collate(samples: Sequence) -> Any:
    """Stack tuples/dicts of arrays into batched numpy arrays."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    arr = np.asarray(first)
    if arr.dtype == object:
        return list(samples)
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Iterable over batches with threaded sample loading + batch prefetch.

    dataset: __len__ + __getitem__(i). sampler: iterable of indices (defaults
    to sequential or shuffled). collate_fn(batch_list) -> batch (defaults to
    stacking); batch-level transforms (mixup etc.) compose into collate_fn.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        sampler: Optional[Any] = None,
        num_workers: int = 8,
        collate_fn: Optional[Callable] = None,
        drop_last: bool = False,
        seed: int = 0,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.num_workers = max(num_workers, 1)
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _indices(self) -> List[int]:
        if self.sampler is not None:
            return list(iter(self.sampler))
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return list(rng.permutation(n))
        return list(range(n))

    def __len__(self):
        n = len(self._indices()) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        from bcosification_tpu_torch.data import transforms as T

        indices = self._indices()
        # hoisted: rebuilding list(enumerate(...)) inside the comprehension
        # is O(n^2/batch) — minutes of epoch-start CPU at ImageNet scale on
        # a 1-core host
        enumerated = list(enumerate(indices))
        batches = [
            enumerated[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:

            def load_batch(batch_pos_idx):
                # deterministic augmentation: every sample's rng derives from
                # (seed, epoch, position-in-epoch) — reproducible across runs
                # and identical across the hosts of a multi-process run
                # (device_put to a multi-process mesh requires equal host
                # batches); positions (not dataset indices) keep repeated-
                # augmentation duplicates of one sample distinct
                def get(pos_idx):
                    pos, idx = pos_idx
                    T.set_sample_rng(
                        np.random.default_rng((self.seed, self.epoch, 0, pos))
                    )
                    try:
                        return self.dataset[idx]
                    finally:
                        T.set_sample_rng(None)

                samples = list(pool.map(get, batch_pos_idx))
                # batch transforms (mixup/cutmix/SplitAndGrid) draw at
                # collate time in THIS thread: key by the batch's first
                # position (namespace 1 keeps it off the sample streams)
                T.set_sample_rng(
                    np.random.default_rng(
                        (self.seed, self.epoch, 1, batch_pos_idx[0][0])
                    )
                )
                try:
                    return self.collate_fn(samples)
                finally:
                    T.set_sample_rng(None)

            pending: List[cf.Future] = []
            batch_pool = cf.ThreadPoolExecutor(max_workers=self.prefetch_batches + 1)
            try:
                it = iter(batches)
                for b in itertools.islice(it, self.prefetch_batches + 1):
                    pending.append(batch_pool.submit(load_batch, b))
                while pending:
                    fut = pending.pop(0)
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(batch_pool.submit(load_batch, nxt))
                    yield fut.result()
            finally:
                batch_pool.shutdown(wait=False, cancel_futures=True)

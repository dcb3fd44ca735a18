"""Repeated-augmentation sampler (a copy of
``bcosification_tpu/data/sampler.py``, DeiT's RASampler): each augmented
repetition of a sample lands on a different replica. With one process
feeding the card, num_replicas=1: the repetitions interleave within the
batch.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["RASampler"]


class RASampler:
    def __init__(
        self,
        dataset,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        repetitions: int = 3,
        select_all: bool = False,
    ):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(
            math.ceil(len(dataset) * float(repetitions) / num_replicas)
        )
        self.total_size = self.num_samples * num_replicas
        if select_all:
            # plain per-process split (data.split_by_process): every sample
            # exactly once per epoch — the reference's 256-truncation is an
            # RA artifact (it selects a subset of the repeated stream,
            # sampler.py:37-39) and would zero out small datasets here.
            # Explicit opt-in only: configs that set ra_repetitions (even 1)
            # keep the reference truncation for steps/LR-schedule parity.
            self.num_selected_samples = self.num_samples
        else:
            self.num_selected_samples = int(
                math.floor(len(dataset) // 256 * 256 / num_replicas)
            )
        self.shuffle = shuffle
        self.seed = seed
        self.repetitions = repetitions

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(len(self.dataset)).tolist()
        else:
            indices = list(range(len(self.dataset)))
        indices = [i for i in indices for _ in range(self.repetitions)]
        indices += indices[: (self.total_size - len(indices))]
        assert len(indices) == self.total_size
        indices = indices[self.rank : self.total_size : self.num_replicas]
        assert len(indices) == self.num_samples
        return iter(indices[: self.num_selected_samples])

    def __len__(self):
        return self.num_selected_samples

    def set_epoch(self, epoch: int):
        self.epoch = epoch

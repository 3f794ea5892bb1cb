"""A minimal batch loader, the torch counterpart of BatchLoader in
ldm_image_generator_tpu/data/loader.py: the indices shuffled every epoch
(numpy RandomState seeded 0, as the JAX package's default) and full
batches only (the trailing partial batch is dropped). The threaded
prefetch, host sharding and labels are not ported yet."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchLoader:
    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.RandomState(0)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = np.arange(len(self.dataset))
        self.rng.shuffle(idx)
        for b in range(len(self)):
            sl = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield np.stack([self.dataset[int(i)] for i in sl])

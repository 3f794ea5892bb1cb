"""Batched, shuffled loader with a background prefetch thread: the torch
counterpart of BatchLoader in ldm_image_generator_tpu/data/loader.py.

The indices are shuffled every epoch by numpy's RandomState(seed), so the
order is the JAX package's; the trailing partial batch is dropped (the
JAX loader's defaults). A daemon thread makes up to `prefetch` batches
ahead; it stops when the consumer stops iterating, and an exception
raised while making a batch reaches the consumer. with_labels=True
yields (batch, int32 labels) from the dataset's per-source-dir labels.

batch_size is the GLOBAL batch. Under a data-parallel group every rank
builds the loader with the same seed, so the per-epoch permutation is the
same on every rank, and each rank loads only its stripe [lo, lo + B / W)
of each global batch (labels striped the same way): shard_index and
shard_count default to the rank and size of `group` (the default group,
or a mesh's data group: parallel.mesh.Mesh.data_group; 0 and 1 without
one), as the JAX loader's default to the process index and count.

A dataset with load_raw (the fp16 cache's memory maps,
data/dataset.py) is stacked straight from them and cast to float32 once
per batch; with device_cast=True the batch stays fp16 and the consumer
casts it on its device (the train steps cast to fp32 there: exact, and
half the bytes to copy).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

# how long the producer waits on a full queue before it checks whether
# the consumer has stopped
_PUT_POLL_S = 0.1
_DONE = object()


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchLoader:
    def __init__(self, dataset, batch_size: int, seed: int = 0, prefetch: int = 2,
                 with_labels: bool = False, shard_index: "int | None" = None,
                 shard_count: "int | None" = None, device_cast: bool = False,
                 group=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.with_labels = with_labels
        self.device_cast = device_cast
        if shard_index is None or shard_count is None:
            import torch.distributed as dist

            grouped = dist.is_available() and dist.is_initialized()
            shard_index = dist.get_rank(group) if grouped else 0
            shard_count = dist.get_world_size(group) if grouped else 1
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        if batch_size % shard_count:
            raise ValueError(f"batch {batch_size} does not split over {shard_count} "
                             "shards")
        self.shard_index = shard_index
        self.shard_count = shard_count

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _make(self, sl):
        load = getattr(self.dataset, "load_raw", None)
        if load is None:  # a dataset without the fp16 cache
            batch = np.stack([np.asarray(self.dataset[int(i)]) for i in sl])
        else:
            batch = np.stack([load(int(i)) for i in sl])
            if not self.device_cast:
                batch = batch.astype(np.float32)
        if self.with_labels:
            labels = np.asarray([self.dataset.labels[int(i)] for i in sl],
                                dtype=np.int32)
            return batch, labels
        return batch

    def __iter__(self) -> Iterator:
        idx = np.arange(len(self.dataset))
        self.rng.shuffle(idx)
        n_batches = len(self)
        per_shard = self.batch_size // self.shard_count
        lo = self.shard_index * per_shard
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_PUT_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    sl = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    # this rank's stripe of the global batch
                    sl = sl[lo:lo + per_shard]
                    if not put(self._make(sl)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(_Failed(e))
                return
            put(_DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failed):
                    raise item.exc
                yield item
        finally:
            stop.set()

"""Data loading: micro-batches from a dataset, on the host.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (the reference's
``DeepSpeedDataLoader`` and ``RepeatingLoader``), with its batches: the same
order (a shuffle draws ``numpy.random.default_rng(seed + epoch)``), the same
rank sharding (contiguous for an indexable dataset, round-robin for an
iterable one), the same ``drop_last`` and the same default collate (dicts and
tuples by field, arrays stacked with numpy). The engine builds it with one
replica: data parallelism waits for ROADMAP.md queue 1 item 11. A
``torch.utils.data.DataLoader`` may be passed to the engine instead.
"""

from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch


class RepeatingLoader:
    """Wraps a loader and restarts it at ``StopIteration``."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def __len__(self):
        return len(self.loader)


def default_collate(samples: List[Any]) -> Any:
    """Dicts by key and tuples/lists by position, recursively; leaves stacked
    along a new leading axis as numpy arrays (tensors go through numpy)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def concat_micro_batches(micros: List[Any]) -> Any:
    """Micro-batches of one structure joined along the leading axis (numpy
    arrays with numpy, tensors with torch)."""
    first = micros[0]
    if isinstance(first, dict):
        return {k: concat_micro_batches([m[k] for m in micros]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(concat_micro_batches([m[i] for m in micros])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.cat(micros, dim=0)
    return np.concatenate([np.asarray(m) for m in micros], axis=0)


class DeepSpeedDataLoader:
    """Batches of ``batch_size`` samples from an indexable dataset (``__len__``
    and ``__getitem__``) or an iterable one, for replica ``rank`` of
    ``num_replicas``."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1, rank: int = 0,
                 collate_fn: Optional[Callable] = None, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self._indexable = hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__")

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if not self._indexable:
            raise TypeError("length of an iterable dataset is unknown")
        per_replica = len(self.dataset) // self.num_replicas
        n = per_replica // self.batch_size
        if not self.drop_last and per_replica % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Any]:
        if self._indexable:
            n = len(self.dataset)
            order = np.arange(n)
            if self.shuffle:
                np.random.default_rng(self.seed + self.epoch).shuffle(order)
            per = n // self.num_replicas        # contiguous shard, no padding
            order = order[self.rank * per:(self.rank + 1) * per]
            for i in range(0, len(order), self.batch_size):
                idx = order[i:i + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    break
                yield self.collate_fn([self.dataset[int(j)] for j in idx])
        else:
            buf = []
            for item_i, sample in enumerate(self.dataset):
                if item_i % self.num_replicas != self.rank:
                    continue
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield self.collate_fn(buf)
                    buf = []
            if buf and not self.drop_last:
                yield self.collate_fn(buf)

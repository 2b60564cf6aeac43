"""Data loading: a copy of ``deepspeed_tpu/runtime/dataloader.py``
(``DeepSpeedDataLoader`` + ``RepeatingLoader``).  Accepts numpy arrays,
dicts of arrays, torch datasets or any indexable; batches come out as
numpy arrays and the engine moves them to its device."""
from typing import Callable, Optional

import numpy as np


class DeepSpeedDataLoader:
    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.len = max(len(dataset) // batch_size, 1)

    def __len__(self):
        return self.len

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        end = n - n % self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idx = order[start:start + self.batch_size]
            items = [self.dataset[int(i)] for i in idx]
            if self.collate_fn is not None:
                yield self.collate_fn(items)
            else:
                yield _default_collate(items)


def _default_collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(it[k]) for it in items])
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([np.asarray(it[j]) for it in items])
                           for j in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class RepeatingLoader:
    """Wraps an iterable to restart on StopIteration."""

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
